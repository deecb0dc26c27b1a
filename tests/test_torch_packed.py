"""The port's bit-packed yCHG (``repro_torch.kernels.ychg_packed``) against
the JAX package's (``repro.kernels.ychg_packed``, its Pallas kernels in
interpret mode), on the same seeded numpy masks: ``pack_rows``,
``packed_colscan`` and all seven fields of ``packed_analyze``, exactly,
dtypes included. On the CPU the wrappers run their plain versions; the
CUDA kernels are held to those on the card by ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ychg_packed as jax_packed  # noqa: E402
from repro_torch.core import ychg  # noqa: E402
from repro_torch.kernels import ychg_packed as kp  # noqa: E402

# tests/test_ychg_kernels.py's SHAPES, then H = 1, W = 1 and H % 8 != 0
SHAPES = [(1, 1), (7, 5), (16, 128), (33, 200), (128, 384), (257, 131),
          (5, 1024), (1, 77), (40, 1), (13, 129)]
DTYPES = [np.uint8, np.bool_, np.int32, np.float32]


def _mask(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < 0.45).astype(dtype)


def _assert_same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _subnormal_mask():
    """The 9 x 3 float32 mask whose subnormals of both signs the reference
    packs as background: only (1, 1) is foreground."""
    m = np.zeros((9, 3), np.float32)
    m[0, 0], m[1, 1], m[8, 2] = 1e-40, 1.0, -1e-42
    return m


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_pack_rows_matches_jax(shape, dtype):
    img = _mask(shape, dtype, seed=shape[0] * 1000 + shape[1])
    _assert_same(kp.pack_rows(torch.from_numpy(img)),
                 jax_packed.pack_rows(jnp.asarray(img)))


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_colscan_matches_jax(shape):
    img = _mask(shape, np.uint8, seed=7 + shape[1])
    packed = kp.pack_rows(torch.from_numpy(img))
    _assert_same(kp.packed_colscan(packed),
                 jax_packed.packed_colscan(jnp.asarray(packed.numpy())))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_packed_analyze_matches_jax(shape, dtype):
    img = _mask(shape, dtype, seed=11 + shape[0])
    got = kp.packed_analyze(torch.from_numpy(img))
    want = jax_packed.packed_analyze(jnp.asarray(img))
    assert set(got) == set(want)
    for field in want:
        _assert_same(got[field], want[field])
    # and the reference's unpacked analysis of the same mask
    ref = ychg.analyze(torch.from_numpy(img))
    for field in got:
        assert torch.equal(got[field], getattr(ref, field)), field


def test_float32_subnormals_pack_as_background():
    img = _subnormal_mask()
    packed = kp.pack_rows(torch.from_numpy(img))
    assert packed.tolist() == [[0, 2, 0], [0, 0, 0]]
    _assert_same(packed, jax_packed.pack_rows(jnp.asarray(img)))
    got = kp.packed_analyze(torch.from_numpy(img))
    want = jax_packed.packed_analyze(jnp.asarray(img))
    for field in want:
        _assert_same(got[field], want[field])
    assert got["runs"].tolist() == [0, 1, 0]
    assert int(got["n_hyperedges"]) == 1 and int(got["n_transitions"]) == 2


def test_float16_subnormals_stay_foreground():
    """float16 keeps its subnormals, as the reference's jitted compare
    does."""
    img = np.zeros((9, 3), np.float16)
    img[0, 0], img[1, 1] = np.float16(1e-7), 1.0
    got = kp.packed_analyze(torch.from_numpy(img))
    want = jax_packed.packed_analyze(jnp.asarray(img))
    for field in want:
        _assert_same(got[field], want[field])
    assert got["runs"].tolist() == [1, 1, 0]


def test_pack_rows_bit_layout():
    img = np.zeros((9, 2), np.uint8)
    img[0, 0] = img[7, 0] = img[8, 1] = 1
    pk = kp.pack_rows(torch.from_numpy(img))
    assert pk.shape == (2, 2) and pk.dtype == torch.uint8
    assert int(pk[0, 0]) == 0x81 and int(pk[1, 1]) == 0x01


@pytest.mark.parametrize("block_w", [1, 128, 256])
def test_block_w_changes_no_result(block_w):
    img = torch.from_numpy(_mask((64, 300), np.uint8, seed=3))
    base = kp.packed_analyze(img)
    got = kp.packed_analyze(img, block_w=block_w)
    for field in base:
        assert torch.equal(got[field], base[field]), field
    assert torch.equal(kp.packed_colscan(kp.pack_rows(img), block_w=block_w),
                       base["runs"])


def test_all_one_columns_run_across_every_byte():
    img = torch.ones(100, 5, dtype=torch.uint8)
    got = kp.packed_analyze(img)
    assert got["runs"].tolist() == [1] * 5
    assert int(got["n_hyperedges"]) == 1 and int(got["n_transitions"]) == 1


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 4, dtype=torch.int32),      # not uint8
    torch.zeros(2, 4, 4, dtype=torch.uint8),   # not 2-D
    torch.zeros(4, 8, dtype=torch.uint8)[:, ::2],  # not contiguous
])
def test_packed_wrappers_refuse_bad_input(bad):
    with pytest.raises(ValueError):
        kp.ychg_packed_colscan(bad)
    with pytest.raises(ValueError):
        kp.ychg_packed_fused(bad)


def test_block_w_must_be_positive():
    with pytest.raises(ValueError):
        kp.packed_analyze(torch.ones(8, 8, dtype=torch.uint8), block_w=0)


def test_launch_needs_a_cuda_tensor():
    """The kernel launchers take a CUDA tensor or raise: no fallback."""
    packed = kp.pack_rows(torch.ones(9, 4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kp.launch_colscan(packed)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kp.launch_fused(packed)
