"""64-bit integer masks: the port reduces int64 to int32 and uint64 to
uint32, keeping the low 32 bits, as the JAX package's ``jnp.asarray`` does
with x64 off, so 2**32 and -2**32 are background and 2**40 + 1 is 1.

Each test feeds the same seeded NumPy masks to both packages on the CPU:
the JAX side through ``jnp.asarray``, its engine, service, server or
scene runner (never a raw NumPy array into its eager ``core.ychg.analyze``,
which compares in NumPy before any cast: ROADMAP Queue C). Tolerance:
exact, dtypes included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import scene as jscene  # noqa: E402
from repro.core import ychg as jychg  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.kernels import ccl as jccl  # noqa: E402
from repro.kernels import denoise as jdenoise  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import YCHGService as JService  # noqa: E402
from repro_torch.core import ychg  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.frontend import ServerThread, YCHGClient  # noqa: E402
from repro_torch.kernels import ccl  # noqa: E402
from repro_torch.kernels import denoise  # noqa: E402
from repro_torch.kernels import ychg_colscan as kc  # noqa: E402
from repro_torch.kernels import ychg_fused as kf  # noqa: E402
from repro_torch.scene import GranuleReader, SceneRunner  # noqa: E402
from repro_torch.service import ServiceConfig, YCHGService  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS  # noqa: E402

TIMEOUT = 300.0
# beside ordinary pixels: values whose low 32 bits are zero, and 2**40 + 1,
# whose low bits are 1; uint64 holds -2**32 as 2**64 - 2**32
WIDE = {
    np.int64: [0, 1, 3, 2**32, -2**32, 2**40 + 1, 2**32 + 5],
    np.uint64: [0, 1, 3, 2**32, 2**64 - 2**32, 2**40 + 1, 2**64 - 1],
}
WIDE_DTYPES = list(WIDE)


def _wide(shape, seed, dtype):
    vals = np.array(WIDE[dtype], dtype)
    return vals[np.random.default_rng(seed).integers(0, len(vals), shape)]


def assert_host_same(got, want, label=""):
    assert set(got) == set(want), label
    for f in want:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.dtype == w.dtype, f"{label} {f}: {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{label} {f}: {g.shape} != {w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {f}")


def _summary(s):
    return {f: getattr(s, f) for f in SUMMARY_FIELDS}


def _host(d):
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}


def test_the_reduction_keeps_the_low_32_bits():
    a = np.array([2**32, -2**32, 2**40 + 1, 2**31, -1], np.int64)
    u = np.array([2**32, 2**40 + 1, 2**64 - 1], np.uint64)
    for x in (a, u):
        got = ychg.narrow_wide_ints(torch.from_numpy(x)).numpy()
        want = np.asarray(jnp.asarray(x))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    x = torch.ones(3, dtype=torch.int16)
    assert ychg.narrow_wide_ints(x) is x


@pytest.mark.parametrize("dtype", WIDE_DTYPES)
def test_core_ychg_matches_jax(dtype):
    m = _wide((3, 17, 23), 1, dtype)
    assert_host_same(_host(_summary(ychg.analyze(torch.from_numpy(m)))),
                     _summary(jychg.analyze(jnp.asarray(m))))


@pytest.mark.parametrize("dtype", WIDE_DTYPES)
def test_kernel_wrappers_match_jax(dtype):
    """The fused and two-kernel wrappers (plain on the CPU) and the ops
    ccl and denoise, each on a tensor that was never reduced."""
    m = _wide((2, 19, 31), 2, dtype)
    t = torch.from_numpy(m)
    want = _summary(jychg.analyze(jnp.asarray(m)))
    got = _host(kf.ychg_fused_full(t))
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
    np.testing.assert_array_equal(kc.ychg_colscan_full(t[1]).numpy(),
                                  np.asarray(want["runs"])[1])
    got = ccl.labels(t)
    want = jccl.labels(jnp.asarray(m))
    assert_host_same(_host({"labels": got.labels, "n": got.n_components}),
                     {"labels": want.labels, "n": want.n_components})
    assert_host_same(_host({"image": denoise.denoise(t).image}),
                     {"image": jdenoise.denoise(jnp.asarray(m)).image})


@pytest.mark.parametrize("op", ["ychg", "ccl", "denoise"])
@pytest.mark.parametrize("dtype", WIDE_DTYPES)
def test_engine_ops_match_jax(dtype, op):
    m = _wide((3, 21, 40), 3, dtype)
    want = JEngine().analyze_batch(m, op=op).to_host()
    eng = Engine(device="cpu")
    for x in (m, torch.from_numpy(m)):  # host data and a tensor
        assert_host_same(eng.analyze_batch(x, op=op).to_host(), want, op)
    assert_host_same(eng.analyze(m[0], op=op).to_host(),
                     JEngine().analyze(m[0], op=op).to_host(), op)


@pytest.mark.parametrize("dtype", WIDE_DTYPES)
def test_pipeline_matches_jax(dtype):
    m = _wide((2, 24, 30), 4, dtype)
    got = Engine(device="cpu").run_pipeline(m, ["denoise", "ychg"])
    want = JEngine().run_pipeline(m, ["denoise", "ychg"])
    assert_host_same(got.to_host(), want.to_host())


def test_service_matches_jax():
    masks = [_wide((20, 30), 5, np.int64), _wide((33, 17), 6, np.uint64),
             _wide((9, 64), 7, np.int64)]
    cfg = dict(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    with YCHGService(Engine(device="cpu"), ServiceConfig(**cfg)) as svc:
        got = [f.result(timeout=TIMEOUT) for f in map(svc.submit, masks)]
    with JService(JEngine(), JServiceConfig(**cfg)) as js:
        want = [f.result(timeout=TIMEOUT) for f in map(js.submit, masks)]
    for g, w in zip(got, want):
        assert_host_same(g.to_host(), w.to_host())


@pytest.mark.parametrize("dtype", WIDE_DTYPES)
def test_scene_seams_follow_the_engine(dtype):
    """A wide pixel in every seam row: the stitched scene equals the JAX
    engine's whole-scene call (the JAX ``SceneRunner`` tests its seams in
    NumPy on all 64 bits and disagrees with its own engine here)."""
    m = _wide((30, 20), 8, dtype)
    for r in (3, 4, 7, 8, 11, 12):   # the last and first rows of strips
        m[r, ::3] = 2**32
        m[r, 1::3] = 2**40 + 1
    got = SceneRunner(Engine(device="cpu"), stack_tiles=2).analyze_scene(
        GranuleReader.from_array(m, 4)).to_host()
    assert_host_same(got, JEngine().analyze(m).to_host())
    ref = jscene.SceneRunner(JEngine(), stack_tiles=2).analyze_scene(
        jscene.GranuleReader.from_array(m, 4)).to_host()
    assert not np.array_equal(ref["runs"], got["runs"])


def test_one_request_over_loopback_matches_jax():
    masks = {"ychg": _wide((40, 40), 9, np.int64),
             "ccl": _wide((40, 40), 10, np.uint64),
             "denoise": _wide((40, 40), 11, np.uint64)}
    svc = YCHGService(Engine(device="cpu"),
                      ServiceConfig(bucket_sides=(64,), max_batch=4))
    with svc, ServerThread(svc) as srv, \
            YCHGClient("127.0.0.1", srv.port) as client:
        for op, m in masks.items():
            got = client.analyze(m, op=op)
            want = JEngine().analyze(m, op=op).to_host()
            assert_host_same(got, want, op)


# the dtypes that were right before: still equal to the JAX package
NARROW_DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
                 np.float16, "bfloat16", np.float32, np.float64, np.bool_]


@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
def test_other_dtypes_still_match(dtype):
    rng = np.random.default_rng(12)
    vals = rng.integers(0, 3, (2, 15, 27)).astype(np.float32)
    vals[0, ::4] = 200.0
    if dtype == "bfloat16":
        j = jnp.asarray(vals, jnp.bfloat16)
        t = torch.from_numpy(vals).to(torch.bfloat16)
        host = None
    else:
        host = vals.astype(dtype)
        j, t = jnp.asarray(host), torch.from_numpy(host)
    want = _summary(jychg.analyze(j))
    assert_host_same(_host(_summary(ychg.analyze(t))), want)
    if host is not None:
        assert_host_same(Engine(device="cpu").analyze_batch(host).to_host(),
                         JEngine().analyze_batch(host).to_host())
