"""Parity: the port's two-kernel yCHG path (``kernels.ychg_colscan``,
``kernels.ops.colscan_runs``/``transitions``/``analyze``), its oracles
(``kernels.ref``), its serial baselines (``core.serial``) and its ``cuda``,
``serial`` and ``scalar`` engine backends, against the JAX package.

The same seeded numpy inputs go to both packages; the JAX Pallas kernels
run in interpret mode. Tolerance: exact, dtypes included. On a CPU tensor
each wrapper runs its kernel's plain version; the CUDA kernels themselves
are held to those plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import serial as jserial  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import YCHGConfig as JConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ychg_colscan import (  # noqa: E402
    colscan_runs_pallas,
    colscan_runs_streamed,
    transitions_pallas,
)
from repro_torch.core import serial  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, registry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ychg_colscan as kc  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS  # noqa: E402

DTYPES = [np.uint8, np.bool_, np.int32, np.float32, np.int16]
SHAPES = [(7, 5), (33, 200), (16, 128), (1, 300), (200, 1), (1, 1),
          (19, 141)]


def assert_same(got, want, label=""):
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{label}: {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{label}: {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=label)


def _mask(shape, seed, p=0.5, dtype=np.uint8):
    return (np.random.default_rng(seed).random(shape) < p).astype(dtype)


def _runs(w, seed):
    return np.random.default_rng(seed).integers(0, 50, w).astype(np.int32)


# ------------------------------------------------------- the three kernels


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_colscan_full_matches_pallas_interpret(shape, dtype):
    img = _mask(shape, sum(shape), dtype=dtype)
    assert_same(kc.ychg_colscan_full(torch.from_numpy(img)),
                colscan_runs_pallas(jnp.asarray(img), interpret=True))


@pytest.mark.parametrize("block_h", [4, 16, 64])
@pytest.mark.parametrize("shape,p", [
    ((130, 140), 0.6), ((33, 129), 0.6), ((257, 131), 0.6),
    ((64, 8), 1.0), ((5, 40), 0.5)])
def test_colscan_splith_matches_streamed_interpret(shape, p, block_h):
    """H and W not multiples of the block sizes, runs crossing every seam."""
    img = _mask(shape, sum(shape) + block_h, p=p)
    assert_same(
        kc.ychg_colscan_splith(torch.from_numpy(img), block_h=block_h),
        colscan_runs_streamed(jnp.asarray(img), block_h=block_h,
                              interpret=True))


@pytest.mark.parametrize("w", [1, 2, 127, 128, 300])
def test_diff_matches_pallas_interpret(w):
    runs = _runs(w, w)
    got = kc.ychg_diff(torch.from_numpy(runs))
    want = transitions_pallas(jnp.asarray(runs), interpret=True)
    for k, v in zip(("transitions", "births", "deaths"), want):
        assert_same(got[k], v, k)


def test_splith_plain_matches_full_plain():
    img = torch.from_numpy(_mask((96, 200), 2))
    for block_h in (1, 7, 32, 96, 1000):
        assert_same(kc.colscan_splith_plain(img, block_h),
                    kc.colscan_full_plain(img).numpy(), str(block_h))


# -------------------------------------------------------------- kernels.ops


@pytest.mark.parametrize("shape", [(45, 77), (3, 200), (70, 150)])
def test_ops_analyze_matches_jax(shape):
    img = _mask(shape, len(shape) + shape[0])
    got = tops.analyze(torch.from_numpy(img))
    want = jops.analyze(jnp.asarray(img))
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k], k)
    trans, births, deaths = tops.transitions(got["runs"])
    for k, v in zip(("transitions", "births", "deaths"),
                    jops.transitions(jnp.asarray(want["runs"]))):
        assert_same({"transitions": trans, "births": births,
                     "deaths": deaths}[k], v, k)


def test_ops_routing_matches_jax(monkeypatch):
    """The split-H kernel runs exactly where the reference streams: when
    H * block_w exceeds the budget; the runs stay identical either way."""
    calls = []

    def spy(mod, name, tag):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(tag)
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(kc, "ychg_colscan_full", "port-full")
    spy(kc, "ychg_colscan_splith", "port-split")
    spy(jops._k, "colscan_runs_pallas", "jax-full")
    spy(jops._k, "colscan_runs_streamed", "jax-split")
    img = _mask((70, 150), 3)
    for budget in (1, 70 * 128 - 1, 70 * 128, 1 << 30):
        calls.clear()
        got = tops.colscan_runs(torch.from_numpy(img), block_h=32,
                                vmem_budget=budget)
        want = jops.colscan_runs(jnp.asarray(img), block_h=32,
                                 vmem_budget=budget)
        split = budget < 70 * 128
        assert calls == (["port-split", "jax-split"] if split
                         else ["port-full", "jax-full"]), (budget, calls)
        assert_same(got, want)


def test_ops_non_contiguous_input_is_copied():
    img = _mask((40, 30), 4)
    view = torch.from_numpy(img).t()
    assert not view.is_contiguous()
    assert_same(tops.colscan_runs(view),
                jops.colscan_runs(jnp.asarray(img.T.copy())))


# ------------------------------------------------------------------ oracles


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.float32,
                                   np.float64])
def test_ref_matches_jax_ref(dtype):
    img = _mask((37, 90), 5, dtype=dtype)
    got, want = ref.analyze_ref(torch.from_numpy(img)), jref.analyze_ref(
        jnp.asarray(img))
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k], k)
    runs = _runs(90, 6)
    for g, w in zip(ref.transitions_ref(torch.from_numpy(runs)),
                    jref.transitions_ref(jnp.asarray(runs))):
        assert_same(g, w)


def test_ref_agrees_with_the_kernel_plain_versions():
    img = torch.from_numpy(_mask((50, 64), 7))
    runs = ref.colscan_runs_ref(img)
    assert_same(kc.colscan_full_plain(img), runs.numpy())
    t, b, d = ref.transitions_ref(runs)
    plain = kc.diff_plain(runs)
    for k, v in (("transitions", t), ("births", b), ("deaths", d)):
        assert_same(plain[k], v.numpy(), k)


# ---------------------------------------------------------- serial baselines


@pytest.mark.parametrize("fn", ["analyze_numpy", "analyze_scalar"])
@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.float32])
def test_serial_matches_jax_serial(fn, dtype):
    img = _mask((23, 31), 8, dtype=dtype)
    got, want = getattr(serial, fn)(img), getattr(jserial, fn)(img)
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k], k)


# ------------------------------------------------------------ engine backends


@pytest.mark.parametrize("budget", [4 * 1024 * 1024, 1])
@pytest.mark.parametrize("backend,jax_backend", [
    ("cuda", "pallas"), ("serial", "serial"), ("scalar", "scalar")])
def test_engine_backend_matches_jax(backend, jax_backend, budget):
    """The two-kernel ``cuda`` backend (on the CPU: the plain versions)
    against the JAX ``pallas`` backend, under both routes; the host
    baselines against the JAX ones."""
    stack = _mask((3, 40, 70), 9)
    cfg = dict(block_h=16, stream_vmem_budget=budget)
    eng = Engine(EngineConfig(backend=backend, **cfg), device="cpu")
    jeng = JEngine(JConfig(backend=jax_backend, **cfg))
    for got, want in [(eng.analyze_batch(stack), jeng.analyze_batch(stack)),
                      (eng.analyze(stack[1]), jeng.analyze(stack[1]))]:
        assert got.batched == want.batched
        gh, wh = got.to_host(), want.to_host()
        for f in SUMMARY_FIELDS:
            assert_same(gh[f], wh[f], f)


@pytest.mark.parametrize("backend", ["cuda", "serial", "scalar"])
def test_engine_backend_on_an_empty_stack(backend):
    got = Engine(EngineConfig(backend=backend), device="cpu").analyze_batch(
        np.zeros((0, 5, 6), np.uint8))
    assert got.batch_size == 0 and got.runs.shape == (0, 6)
    assert got.runs.dtype == torch.int32


def test_cuda_backend_is_explicit_only():
    """``auto`` never picks a single-image backend; ``cuda`` on the card,
    ``serial`` and ``scalar`` on the CPU are there when named."""
    assert registry.resolve("auto", platform="cuda").name == "fused"
    assert registry.resolve("auto", platform="cpu").name == "torch"
    for name in ("cuda", "serial", "scalar"):
        spec = registry.get_backend(name)
        assert not spec.supports_batch
    assert registry.get_backend("cuda").device_kinds == ("cuda", "cpu")
    assert registry.get_backend("serial").device_kinds == ("cpu",)


def test_cuda_backend_counts_no_launch_on_the_cpu():
    before = dict(kc.LAUNCHES)
    Engine(EngineConfig(backend="cuda"), device="cpu").analyze_batch(
        _mask((2, 9, 11), 10))
    assert kc.LAUNCHES == before


# ---------------------------------------------------------------- refusals


def test_wrappers_refuse_bad_input():
    with pytest.raises(ValueError, match=r"\(H, W\) mask"):
        kc.ychg_colscan_full(torch.zeros((1, 2, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        kc.ychg_colscan_splith(
            torch.zeros((8, 6), dtype=torch.uint8).t(), block_h=2)
    with pytest.raises(ValueError, match="block_h"):
        kc.ychg_colscan_splith(torch.zeros((4, 4)), block_h=0)
    with pytest.raises(ValueError, match="int32"):
        kc.ychg_diff(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        kc.ychg_colscan_full(np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match="device meta"):
        kc.ychg_colscan_full(torch.zeros((2, 3), device="meta"))
    with pytest.raises(ValueError):
        tops.colscan_runs(torch.zeros((1, 2, 3)))


def test_kernel_path_refuses_without_cuda():
    """The kernel path never falls back: a CPU tensor is refused, and the
    library will not load (or build) in a process that sees no card."""
    x = torch.zeros((4, 4), dtype=torch.uint8)
    for launch in (kc.launch_full,
                   lambda t: kc.launch_splith(t, block_h=2)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.launch_diff(torch.zeros(4, dtype=torch.int32))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("ychg_colscan", kc._SIGNATURES)


def test_library_path_names_source_hash():
    path = _build.library_path("ychg_colscan")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libychg_colscan-") and path.suffix == ".so"
    assert "-ftz=true" in _build.NVCC_FLAGS
