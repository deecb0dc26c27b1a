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
from repro_torch.core import ychg as tychg  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, registry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ychg_colscan as kc  # noqa: E402
from repro_torch.kernels import ychg_fused as kf  # noqa: E402
from test_torch_fused import DECOMP_WIDTHS, model_full  # noqa: E402
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


@pytest.mark.parametrize("addr", [0, 1, 4, 8])
@pytest.mark.parametrize("w", DECOMP_WIDTHS)
def test_model_colscan_matches_plain(w, addr):
    """``ychg_colscan_full``'s decomposition (``test_torch_fused.model_full``
    without the halo): declared constants, heights no segment count
    divides, H = 0 and 1, base addresses 1, 4 and 8 bytes off 16."""
    for h in (0, 1, 37, 300):
        img = _mask((h, w), w + h + addr)
        want = kc.colscan_full_plain(torch.from_numpy(img)).numpy()
        for dtype in (np.uint8, np.int32):
            got = model_full(img[None].astype(dtype), addr=addr, fused=False)
            assert_same(got["runs"], want, f"{h} {dtype}")


def test_model_colscan_long_alternating_columns():
    """Segments far past a byte lane's 255 runs, and past the 16-bit lanes'
    flush period at a small one."""
    img = np.zeros((3000, 24), np.uint8)
    img[::2] = 1
    img[::7, 3] = 0
    want = kc.colscan_full_plain(torch.from_numpy(img)).numpy()
    for kw in ({}, {"lanes": 4, "threads": 4}, {"lanes": 2, "threads": 2,
                                                 "chunk": 10, "pair_chunks": 3}):
        assert_same(model_full(img[None], fused=False, **kw)["runs"], want,
                    str(kw))


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


# ------------------------------------------- the two-kernel path a batch


@pytest.mark.parametrize("b", [0, 1, 3])
@pytest.mark.parametrize("budget", [4 * 1024 * 1024, 1])
@pytest.mark.parametrize("w", [131, 8])
def test_analyze_batch_plain_matches_jax_pallas(b, budget, w):
    """The batch entry's plain version (``analyze_plain``), directly and
    through ``kops.analyze_batch``, against the JAX ``pallas`` backend in
    interpret mode: B = 0, 1 and 3, ragged W, both routes."""
    stack = _mask((b, 40, w), b + w + budget % 7)
    cfg = dict(block_h=16, stream_vmem_budget=budget)
    want = JEngine(JConfig(backend="pallas", **cfg)).analyze_batch(
        stack).to_host()
    split = budget < 40 * 128
    plain = kc.analyze_plain(torch.from_numpy(stack), 16 if split else None)
    got = tops.analyze_batch(torch.from_numpy(stack), block_h=16,
                             vmem_budget=budget)
    assert tuple(got) == tuple(plain) == kc.ANALYZE_FIELDS
    for f in SUMMARY_FIELDS:
        assert_same(plain[f], want[f], f)
        assert_same(got[f], want[f], f)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int16])
def test_analyze_plain_dtypes_match_jax_pallas(dtype):
    stack = _mask((2, 33, 70), 12, dtype=dtype)
    if dtype == np.float32:
        stack[1, ::2] *= np.float32(1e-39)  # subnormals: background
    for budget, block_h in ((1 << 30, None), (1, 5)):
        want = JEngine(JConfig(backend="pallas", block_h=5,
                               stream_vmem_budget=budget)).analyze_batch(
            stack).to_host()
        got = kc.analyze_plain(torch.from_numpy(stack), block_h)
        for f in SUMMARY_FIELDS:
            assert_same(got[f], want[f], f)


def test_analyze_batch_routes_as_colscan_runs(monkeypatch):
    """One route for the whole stack, chosen by ``colscan_runs``'s rule,
    and one call of the batch entry (no call a mask)."""
    calls = []
    real = kc.ychg_colscan_analyze

    def spy(imgs, *, block_h=None):
        calls.append(block_h)
        return real(imgs, block_h=block_h)

    monkeypatch.setattr(kc, "ychg_colscan_analyze", spy)
    stack = torch.from_numpy(_mask((3, 70, 150), 13))
    for budget, want in ((1, 32), (70 * 128 - 1, 32), (70 * 128, None),
                         (1 << 30, None)):
        calls.clear()
        tops.analyze_batch(stack, block_h=32, vmem_budget=budget)
        assert calls == [want], budget
    calls.clear()
    Engine(EngineConfig(backend="cuda", block_h=32, stream_vmem_budget=1),
           device="cpu").analyze_batch(stack.numpy())
    assert calls == [32]


def test_analyze_is_the_batch_entry_with_one_mask():
    img = torch.from_numpy(_mask((45, 77), 14))
    one = tops.analyze(img, block_h=8, vmem_budget=1)
    batch = tops.analyze_batch(img[None], block_h=8, vmem_budget=1)
    assert tuple(one) == kc.ANALYZE_FIELDS
    for k in kc.ANALYZE_FIELDS:
        assert_same(one[k], batch[k][0].numpy(), k)
        assert one[k].shape == batch[k].shape[1:]


@pytest.mark.parametrize("fields", [kc.ANALYZE_FIELDS, kf._FIELDS])
@pytest.mark.parametrize("b,w", [(0, 5), (1, 1), (3, 17)])
def test_outputs_are_views_of_one_zeroed_buffer(b, w, fields):
    """The batch entry's outputs (and the fused kernels', on their six
    fields): one allocation, every field zeroed (the kernels add into the
    totals, split-H into the runs), the dtypes and shapes of
    ``core.ychg.analyze``, no two fields overlapping."""
    out = tychg.zeroed_outputs(fields, b, w, torch.device("cpu"))
    assert tuple(out) == fields
    base = out["runs"].untyped_storage().data_ptr()
    spans = []
    for k, v in out.items():
        want = (b,) if k.startswith("n_") else (b, w)
        assert v.shape == want and v.is_contiguous(), k
        assert v.dtype == (torch.bool if k == "transitions" else torch.int32)
        assert v.untyped_storage().data_ptr() == base, k
        assert not v.any(), k
        start = v.data_ptr()
        spans.append((start, start + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b_[0] for a, b_ in zip(spans, spans[1:]))


def test_field_layout_matches_core_analyze():
    """``FIELD_LAYOUT``, from which the kernels' output buffer is cut, says
    what ``core.ychg.analyze`` gives for every summary field."""
    got = tychg.analyze(torch.from_numpy(_mask((3, 9, 13), 21)))
    assert tuple(tychg.FIELD_LAYOUT) == kc.ANALYZE_FIELDS
    for k, kind in tychg.FIELD_LAYOUT.items():
        v = getattr(got, k)
        dtype, shape = kind.split()
        assert v.dtype == {"int32": torch.int32, "bool": torch.bool}[dtype], k
        assert v.shape == {"plane": (3, 13), "total": (3,)}[shape], k


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
    with pytest.raises(ValueError, match=r"\(B, H, W\) stack"):
        kc.ychg_colscan_analyze(torch.zeros((2, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="block_h"):
        kc.ychg_colscan_analyze(torch.zeros((1, 4, 4)), block_h=0)
    with pytest.raises(ValueError):
        tops.analyze_batch(torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        tops.analyze(torch.zeros((1, 2, 3)))


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
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.launch_analyze(torch.zeros((1, 4, 4), dtype=torch.uint8))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("ychg_colscan", kc._SIGNATURES)


def test_library_path_names_source_hash():
    path = _build.library_path("ychg_colscan")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libychg_colscan-") and path.suffix == ".so"
    assert "-ftz=true" in _build.NVCC_FLAGS
