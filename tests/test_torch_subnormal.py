"""Subnormal float inputs: the port's ychg, ccl and denoise paths against the
JAX package, bit for bit.

XLA on the CPU (as on the TPU) flushes float32 subnormals: a float32 pixel
whose exponent bits are all zero is background to ychg and ccl, and each
float32 operation of denoise reads a subnormal as zero and writes a
subnormal result as a zero of its sign (its final select passes the pixel
itself through). float64 is rounded to float32 first (x64 is off).
float16 is not flushed; bfloat16 is not either on the JAX package's
jitted and kernel paths, which the port follows. The serial baselines are
NumPy, which keeps subnormals, in both packages. On the CPU each kernel
wrapper runs its plain version; ``chip_smoke.py`` holds the CUDA kernels
to those on subnormal cases.
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ychg as jychg  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import YCHGConfig as JConfig  # noqa: E402
from repro.kernels import ccl as jccl  # noqa: E402
from repro.kernels import denoise as jdn  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import ychg  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.kernels import ccl as kccl  # noqa: E402
from repro_torch.kernels import denoise as kdn  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS  # noqa: E402

FLT_MIN = np.finfo(np.float32).tiny
# subnormals of both signs, +-0, NaN, +-inf, normal values at and near the
# smallest normal (whose sums and products land in the subnormal range)
VALUES = np.array([0.0, -0.0, 1e-39, -1e-39, 5e-40, 1e-45, FLT_MIN,
                   -FLT_MIN, 2 * FLT_MIN, 1.5e-38, 3e-38, 2e-38, 1e-19,
                   1.1e-19, 1.0, 0.5, np.nan, np.inf, -np.inf], np.float32)


def _values(shape, seed):
    return VALUES[np.random.default_rng(seed).integers(0, len(VALUES),
                                                       shape)]


def _example(dtype, vals=(1e-40, -1e-39)):
    """The 3 x 3 mask of ROADMAP Queue C 3: one foreground pixel in the
    middle column, a subnormal in the others."""
    a = np.zeros((3, 3), dtype)
    a[0, 1], a[1, 1], a[2, 2] = vals[0], 1, vals[1]
    return a


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def assert_bits(got, want, label=""):
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, label
    if g.dtype == np.float32:
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=label)


# --------------------------------------------------------------------- ychg


def test_queue_c3_example():
    """The case of the report: the JAX package gives runs [0 1 0]; before
    the repair the port gave [1 1 1]."""
    a = _example(np.float32)
    assert_bits(ychg.analyze(torch.from_numpy(a)).runs,
                np.array([0, 1, 0], np.int32))
    assert_bits(ychg.analyze(torch.from_numpy(a)).runs,
                jychg.analyze(jnp.asarray(a)).runs)


@pytest.mark.parametrize("backend", ["torch", "fused", "cuda"])
@pytest.mark.parametrize("dtype,vals", [
    (np.float32, (1e-40, -1e-39)), (np.float64, (1e-40, -1e-39)),
    (np.float64, (1e-300, 1e-50)), (np.float16, (1e-6, -1e-6)),
    (ml_dtypes.bfloat16, (1e-39, -1e-39))])
def test_ychg_backends_match_jax(backend, dtype, vals):
    """Every device backend on the example and on random subnormal-laden
    masks, against the JAX engine's jitted ``jax`` backend."""
    a = _example(dtype, vals)
    b = _values((2, 30, 40), 1).astype(dtype)
    eng = Engine(EngineConfig(backend=backend), device="cpu")
    jeng = JEngine(JConfig(backend="jax"))
    for got, want in [(eng.analyze(_torch(a)), jeng.analyze(a)),
                      (eng.analyze_batch(_torch(b)), jeng.analyze_batch(b))]:
        gh, wh = got.to_host(), want.to_host()
        for f in SUMMARY_FIELDS:
            assert_bits(gh[f], wh[f], f)


@pytest.mark.parametrize("budget", [4 * 1024 * 1024, 1])
@pytest.mark.parametrize("backend,jax_backend", [
    ("fused", "fused"), ("cuda", "pallas")])
def test_kernel_backends_match_jax_kernels(backend, jax_backend, budget):
    """Both routes of each kernel backend against the JAX Pallas kernels
    (interpret mode) on float32 subnormals."""
    b = _values((2, 33, 45), 2)
    cfg = dict(block_h=8, stream_vmem_budget=budget)
    got = Engine(EngineConfig(backend=backend, **cfg),
                 device="cpu").analyze_batch(b).to_host()
    want = JEngine(JConfig(backend=jax_backend, **cfg)).analyze_batch(
        b).to_host()
    for f in SUMMARY_FIELDS:
        assert_bits(got[f], want[f], f)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ref_matches_jax_ref(dtype):
    a = _values((25, 60), 3).astype(dtype)
    got, want = ref.analyze_ref(torch.from_numpy(a)), jref.analyze_ref(
        jnp.asarray(a))
    for k in want:
        assert_bits(got[k], want[k], k)


@pytest.mark.parametrize("backend", ["serial", "scalar"])
def test_serial_backends_keep_subnormals(backend):
    """NumPy keeps subnormals: the serial baselines count them as
    foreground, in both packages."""
    a = _example(np.float32)
    got = Engine(EngineConfig(backend=backend), device="cpu").analyze(a)
    want = JEngine(JConfig(backend=backend)).analyze(a)
    assert_bits(got.to_host()["runs"], np.array([0, 1, 1], np.int32))
    for f in SUMMARY_FIELDS:
        assert_bits(got.to_host()[f], want.to_host()[f], f)


def test_foreground_dtypes():
    x = torch.tensor([0.0, -0.0, 1e-39, -1e-45, FLT_MIN, float("nan"),
                      float("inf"), 1.0])
    want = [False, False, False, False, True, True, True, True]
    assert ychg.foreground(x).tolist() == want
    assert ychg.foreground(x.double()).tolist() == want
    assert ychg.foreground(torch.tensor([1e-300, 1e-40, 1e-30],
                                        dtype=torch.float64)).tolist() == [
        False, False, True]
    assert ychg.foreground(torch.tensor([6e-8], dtype=torch.float16)).item()


# ---------------------------------------------------------------------- ccl


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_ccl_matches_jax(dtype):
    b = _values((2, 24, 31), 4).astype(dtype)
    want = jccl.labels(jnp.asarray(b))
    want_pallas = jccl.labels_pallas(jnp.asarray(b), interpret=True)
    for got in (kccl.labels(torch.from_numpy(b)),
                kccl.labels_kernel(torch.from_numpy(b))):
        for w in (want, want_pallas):
            assert_bits(got.labels, w.labels, "labels")
            assert_bits(got.n_components, w.n_components, "n")


# ------------------------------------------------------------------ denoise


@pytest.mark.parametrize("jax_fn", ["denoise", "denoise_pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64,
                                   ml_dtypes.bfloat16, np.float16])
def test_denoise_matches_jax(dtype, jax_fn):
    """Windows mixing subnormals, +-0 and normal values at the edge of the
    normal range: every flush decides an output somewhere here."""
    b = _values((3, 20, 33), 5).astype(dtype)
    want = np.asarray(getattr(jdn, jax_fn)(jnp.asarray(b)).image)
    for got in (kdn.denoise(_torch(b)).image,
                kdn.denoise_kernel(_torch(b)).image):
        assert got.dtype == torch.float32
        assert_bits(got, want)


def test_denoise_all_subnormal_windows_pass_through():
    """Where a window holds only subnormals and zeros, every arithmetic step
    flushes to zero, the outlier test is false, and the pixel passes
    through unflushed."""
    b = np.full((1, 6, 7), 1e-39, np.float32)
    b[0, ::2] = -5e-41
    got = kdn.denoise(torch.from_numpy(b)).image
    assert_bits(got, b)
    assert_bits(got, np.asarray(jdn.denoise(jnp.asarray(b)).image))


def test_ftz_keeps_the_sign():
    x = torch.tensor([1e-39, -1e-39, -0.0, 0.0, FLT_MIN, -2.0, float("nan")])
    got = kdn._ftz(x)
    assert got.view(torch.int32).tolist() == torch.tensor(
        [0.0, -0.0, -0.0, 0.0, FLT_MIN, -2.0, float("nan")]).view(
            torch.int32).tolist()
