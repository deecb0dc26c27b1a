"""Parity: the port's CCL (plain version, canonicalization, CPU wrapper)
against the JAX package's ``labels`` (jnp reference) and ``labels_pallas``
(Pallas kernel in interpret mode), and against a pure-Python BFS oracle,
on the same seeded numpy masks. Tolerance: exact, dtypes included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ccl as jccl  # noqa: E402
from repro_torch.kernels import ccl  # noqa: E402

RAGGED = [(1, 1), (1, 7), (6, 1), (17, 23), (20, 17), (33, 64)]


def _random(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.uint8)


def _checkerboard(h, w):
    return (np.indices((h, w)).sum(axis=0) % 2).astype(np.uint8)


def _serpentine(h, w):
    """One component snaking through every other row: the longest chain a
    (h, w) mask can hold for its area."""
    m = np.zeros((h, w), np.uint8)
    m[::2] = 1
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = 1
    return m


def _bfs(mask):
    """4-neighbour BFS: canonical labels (row-major first encounter), the
    raw fixpoint (min linear index + 1 per component) and the count."""
    h, w = mask.shape
    canon = np.zeros((h, w), np.int32)
    raw = np.zeros((h, w), np.int32)
    n = 0
    for i in range(h):
        for j in range(w):
            if mask[i, j] and not canon[i, j]:
                n += 1
                root = i * w + j + 1
                stack = [(i, j)]
                canon[i, j], raw[i, j] = n, root
                while stack:
                    y, x = stack.pop()
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        yy, xx = y + dy, x + dx
                        if (0 <= yy < h and 0 <= xx < w and mask[yy, xx]
                                and not canon[yy, xx]):
                            canon[yy, xx], raw[yy, xx] = n, root
                            stack.append((yy, xx))
    return canon, raw, n


CASES = ([(f"random {s}", _random((2, *s), sum(s))) for s in RAGGED] + [
    ("all-zero", np.zeros((2, 9, 13), np.uint8)),
    ("all-one", np.ones((2, 9, 13), np.uint8)),
    ("checkerboard", np.stack([_checkerboard(10, 15),
                               1 - _checkerboard(10, 15)])),
    ("serpentine", np.stack([_serpentine(21, 17), _serpentine(17, 21).T])),
    ("dense", _random((2, 24, 31), 3, density=0.7)),
])
IDS = [c[0] for c in CASES]


def assert_summary_equal(got, want):
    for f in ccl.CCL_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype == np.int32, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("jax_fn", ["labels", "labels_pallas"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_labels_match_jax(case, jax_fn):
    _, x = case
    want = getattr(jccl, jax_fn)(jnp.asarray(x))
    assert_summary_equal(ccl.labels(torch.from_numpy(x)), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fixpoint_and_labels_match_bfs_oracle(case):
    _, x = case
    raw = ccl.ccl_fixpoint_plain(torch.from_numpy(x))
    assert raw.dtype == torch.int32
    got = ccl.labels(torch.from_numpy(x))
    for b in range(x.shape[0]):
        canon, want_raw, n = _bfs(x[b])
        np.testing.assert_array_equal(raw[b].numpy(), want_raw)
        np.testing.assert_array_equal(got.labels[b].numpy(), canon)
        assert int(got.n_components[b]) == n


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int32, np.float32,
                                   np.int16])
def test_input_dtypes(dtype):
    x = _random((2, 17, 23), 7).astype(dtype)
    want = jccl.labels(jnp.asarray(x))
    assert_summary_equal(ccl.labels(torch.from_numpy(x)), want)


def test_canonicalize_matches_jax():
    """The same raw fixpoint through both packages' ``_canonicalize``."""
    x = _random((3, 19, 26), 9)
    raw = ccl.ccl_fixpoint_plain(torch.from_numpy(x))
    got = ccl._canonicalize(raw, torch.from_numpy(x) != 0)
    want = jccl._canonicalize(jnp.asarray(raw.numpy()), jnp.asarray(x) != 0)
    assert_summary_equal(got, want)


def test_seed_and_neighbor_min_match_jax():
    x = _random((2, 7, 9), 4)
    seed = ccl._seed_labels(torch.from_numpy(x) != 0)
    np.testing.assert_array_equal(
        seed.numpy(), np.asarray(jccl._seed_labels(jnp.asarray(x) != 0)))
    np.testing.assert_array_equal(
        ccl._neighbor_min(seed).numpy(),
        np.asarray(jccl._neighbor_min(jnp.asarray(seed.numpy()))))


def test_serpentine_converges_in_few_sweeps():
    """Hooking plus full pointer jumping: a serpentine whose chain is
    hundreds of pixels long settles in a handful of sweeps."""
    x = torch.from_numpy(_serpentine(61, 47))[None]
    raw, sweeps = ccl.fixpoint_with_sweeps(x)
    assert sweeps <= 8
    assert torch.all(raw[x != 0] == 1) and torch.all(raw[x == 0] == 0)


def test_wrapper_on_cpu_runs_the_plain_version():
    x = torch.from_numpy(_random((3, 19, 40), 1))
    before = ccl.LAUNCHES["ccl"]
    assert torch.equal(ccl.ccl_fixpoint(x), ccl.ccl_fixpoint_plain(x))
    assert_summary_equal(ccl.labels_kernel(x), ccl.labels(x))
    assert ccl.LAUNCHES["ccl"] == before   # no kernel launched


def test_wrapper_refuses_other_devices_shapes_and_sizes():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccl.ccl_fixpoint(torch.zeros((1, 4, 4), device="meta"))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        ccl.ccl_fixpoint(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="sentinel"):
        ccl.ccl_fixpoint_plain(torch.zeros((1, 1 << 15, 1 << 15),
                                           device="meta"))


def test_empty_stacks():
    for shape in [(0, 4, 4), (2, 0, 5), (2, 5, 0)]:
        s = ccl.labels(torch.zeros(shape, dtype=torch.uint8))
        want = jccl.labels(jnp.zeros(shape, jnp.uint8))
        assert tuple(s.labels.shape) == shape
        assert_summary_equal(s, want)


def test_pad_invariance():
    """Zero padding to a larger canvas starts no component and never
    renumbers the native region."""
    mask = _random((1, 13, 19), 5)
    padded = np.zeros((1, 20, 32), np.uint8)
    padded[0, :13, :19] = mask[0]
    base = ccl.labels(torch.from_numpy(mask))
    pad = ccl.labels(torch.from_numpy(padded))
    assert torch.equal(pad.labels[0, :13, :19], base.labels[0])
    assert torch.all(pad.labels[0, 13:] == 0)
    assert torch.all(pad.labels[0, :, 19:] == 0)
    assert torch.equal(pad.n_components, base.n_components)
