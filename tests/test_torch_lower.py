"""``Engine.lower`` of the port against the JAX package's.

The port's ``lower`` reckons a cell from its shape alone; the JAX
package's jit-lowers it. Both are held field by field: ``out_info``
(shape, dtype name) for the backend pairs ``torch``/``jax``,
``fused``/``fused`` and ``cuda``/``pallas`` over ychg, ccl and denoise
where registered; the argument and output bytes of the compiled cell; and
every case where lowering raises. Two divergences are stated here and in
ROADMAP Queue C: the port raises for every shape that is not (B, H, W)
(JAX's ``jax`` and ``fused`` backends lower a 2-D shape by broadcasting),
and the port lowers H = 0 and W = 0 on its kernel backends (JAX's
``fused`` and ``pallas`` raise there), as its run serves them. The plan
(route, launches, kernel bytes) is pinned at the serving batch, the scene
and the tall strip against PERF.md's kernel table. Exact everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import YCHGConfig  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.engine.lowering import ShapeDtype  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ychg_fused as kf  # noqa: E402

# port backend -> the JAX package's
PAIRS = {"torch": "jax", "fused": "fused", "cuda": "pallas"}
OPS_OF = {"torch": ("ychg", "ccl", "denoise"), "fused": ("ychg",),
          "cuda": ("ychg", "ccl", "denoise")}
SERVING, SCENE, TALL = (8, 8192, 8192), (1, 21000, 21000), (1, 40960, 8192)
# port dtype -> the JAX package's, for the same NumPy input
DTYPES = {"uint8": (torch.uint8, jnp.uint8), "bool": (torch.bool, jnp.bool_),
          "int32": (torch.int32, jnp.int32),
          "float32": (torch.float32, jnp.float32),
          "int64": (torch.int64, np.int64),
          "float64": (torch.float64, np.float64),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _port(backend, op, **cfg):
    return Engine(EngineConfig(backend=backend, **cfg), op=op, device="cpu")


def _jax(backend, op):
    return JEngine(YCHGConfig(backend=backend), op=op)


def _fields(result):
    """(field, shape, dtype name) of a result of ShapeDtype or
    ShapeDtypeStruct leaves, in field order."""
    out = []
    for name, leaf in vars(result).items():
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            dtype = str(leaf.dtype).replace("torch.", "")
            out.append((name, tuple(leaf.shape), dtype))
    return out


CELLS = [(b, op, shape) for b, ops in OPS_OF.items() for op in ops
         for shape in [(8, 64, 64), (0, 16, 8), (1, 33, 130), (2, 0, 8),
                       (2, 16, 0)]
         if not (b != "torch" and op == "ychg" and 0 in shape[1:])]


@pytest.mark.parametrize("backend,op,shape", CELLS)
def test_out_info_matches_jax(backend, op, shape):
    got = _port(backend, op).lower(shape).out_info
    want = _jax(PAIRS[backend], op).lower(shape).out_info
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)
    assert got.batched is True and want.batched is True


@pytest.mark.parametrize("backend,op", [(b, op) for b, ops in OPS_OF.items()
                                        for op in ops])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_out_info_matches_jax_for_every_dtype(backend, op, name):
    tdt, jdt = DTYPES[name]
    got = _port(backend, op).lower((2, 16, 8), tdt).out_info
    want = _jax(PAIRS[backend], op).lower((2, 16, 8), jdt).out_info
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_argument_and_output_bytes_match_jax(name):
    """Argument bytes equal JAX's but for float64, which stays float64 in
    the port (JAX's argument is float32 with x64 off: half the bytes). The
    port's output bytes are JAX's less XLA's 8-byte tuple table entry a
    field (344 = 288 + 7 x 8 at (2, 16, 8))."""
    tdt, jdt = DTYPES[name]
    shape = (2, 16, 8)
    port = _port("torch", "ychg").lower(shape, tdt)
    jl = _jax("jax", "ychg").lower(shape, jdt)
    got, want = port.compile().memory_analysis(), jl.compile().memory_analysis()
    jax_in = jl.in_avals[0][0]
    port_in = str(port.in_info.dtype).replace("torch.", "")
    if name == "float64":
        assert port_in == "float64" and str(jax_in.dtype) == "float32"
        assert got.argument_size_in_bytes == 2 * want.argument_size_in_bytes
    else:
        assert port_in == str(jax_in.dtype)
        assert got.argument_size_in_bytes == want.argument_size_in_bytes
    assert got.output_size_in_bytes == 288
    assert want.output_size_in_bytes == got.output_size_in_bytes + 7 * 8
    assert _fields(port.out_info) == _fields(jl.out_info)


@pytest.mark.parametrize("op,fields", [("ccl", 2), ("denoise", 1)])
def test_output_bytes_of_the_image_ops(op, fields):
    """One 8-byte table entry a field where the result has several; none
    for denoise's single image."""
    got = _port("cuda", op).lower((2, 16, 8)).compile().memory_analysis()
    want = _jax("pallas", op).lower((2, 16, 8)).compile().memory_analysis()
    assert got.argument_size_in_bytes == want.argument_size_in_bytes == 256
    table = 8 * fields if fields > 1 else 0
    assert want.output_size_in_bytes == got.output_size_in_bytes + table


@pytest.mark.parametrize("backend,op", [
    ("fused", "ccl"), ("fused", "denoise"), ("serial", "ychg"),
    ("scalar", "ychg"), ("serial", "ccl"), ("scalar", "denoise")])
def test_lowering_raises_where_jax_raises(backend, op):
    """An op the backend does not serve raises ValueError in both; the
    host backends raise ValueError in the port, where JAX's tracer raises
    TracerArrayConversionError."""
    with pytest.raises(Exception):
        _jax(backend, op).lower((2, 16, 8))
    with pytest.raises(ValueError):
        _port(backend, op).lower((2, 16, 8))


@pytest.mark.parametrize("backend", ["torch", "fused", "cuda"])
def test_two_dimensional_shape_divergence(backend):
    """JAX's ``jax`` and ``fused`` lower a 2-D shape, broadcasting
    ``runs`` to (W,); its ``pallas`` raises. The port raises on every
    backend: its signature is (B, H, W). 4-D: JAX's ``jax`` lowers it,
    the others raise; the port raises."""
    jb = PAIRS[backend]
    if jb == "pallas":
        with pytest.raises(ValueError):
            _jax(jb, "ychg").lower((64, 64))
    else:
        info = _jax(jb, "ychg").lower((64, 64)).out_info
        assert info.runs.shape == (64,) and info.n_hyperedges.shape == ()
    if jb == "jax":
        assert _jax(jb, "ychg").lower((2, 3, 4, 5)).out_info.runs.shape == (
            2, 3, 5)
    else:
        with pytest.raises(ValueError):
            _jax(jb, "ychg").lower((2, 3, 4, 5))
    for shape in [(64, 64), (2, 3, 4, 5), (64,)]:
        with pytest.raises(ValueError, match=r"\(B, H, W\)"):
            _port(backend, "ychg").lower(shape)
    with pytest.raises(ValueError):
        _port(backend, "ychg").lower((2, -1, 4))


@pytest.mark.parametrize("backend", ["fused", "cuda"])
@pytest.mark.parametrize("shape", [(2, 0, 8), (2, 16, 0)])
def test_empty_rows_or_columns_divergence(backend, shape):
    """JAX's ``fused`` and ``pallas`` raise on H = 0 and W = 0 (a division
    by zero, a slice larger than the operand). The port's kernel backends
    run those shapes, and lowering follows the run: the out_info is the
    ``torch`` backend's, which equals JAX's ``jax`` backend's."""
    with pytest.raises((ZeroDivisionError, TypeError)):
        _jax(PAIRS[backend], "ychg").lower(shape)
    got = _port(backend, "ychg").lower(shape).out_info
    assert _fields(got) == _fields(_jax("jax", "ychg").lower(shape).out_info)
    out = _port(backend, "ychg").analyze_batch(np.zeros(shape, np.uint8))
    assert [(f, tuple(getattr(out, f).shape), str(getattr(out, f).dtype)
             .replace("torch.", "")) for f, _, _ in _fields(got)] == (
        _fields(got))


@pytest.mark.parametrize("backend,shape,route,launches", [
    ("fused", SERVING, "full", {"ychg_fused_full": 1}),
    ("fused", SCENE, "full", {"ychg_fused_full": 1}),
    ("fused", TALL, "splith", {"ychg_fused_splith": 1}),
    ("cuda", SERVING, "full", {"ychg_colscan_full": 8, "ychg_diff": 8}),
    ("cuda", SCENE, "full", {"ychg_colscan_full": 1, "ychg_diff": 1}),
    ("cuda", TALL, "splith", {"ychg_colscan_splith": 1, "ychg_diff": 1}),
])
def test_plan_route_and_launches(backend, shape, route, launches):
    c = _port(backend, "ychg").lower(shape).compile()
    assert c.route == route
    assert c.cost_analysis()["launches"] == launches


def test_kernel_bytes_pinned_to_the_kernel_table():
    """PERF.md section 6: ``ychg_fused_full`` at 8 x 8192^2 uint8 moves
    537,722,944 bytes (row 1); the two-kernel path 8 x (67,141,632 +
    139,272) (rows 3 and 5). The cut vertices (2 * runs, a PyTorch op)
    are the fused route's op bytes: 8 x 8192 x 8."""
    fused = _port("fused", "ychg").lower(SERVING).compile().cost_analysis()
    cuda = _port("cuda", "ychg").lower(SERVING).compile().cost_analysis()
    assert fused["kernel bytes"] == 537_722_944
    assert fused["op bytes"] == 8 * 8192 * 8
    assert cuda["kernel bytes"] == 538_247_232 == 8 * (67_141_632 + 139_272)
    assert cuda["op bytes"] == 0
    assert fused["bytes accessed"] == cuda["bytes accessed"]


@pytest.mark.parametrize("backend,op", [
    ("fused", "ychg"), ("cuda", "ychg"), ("cuda", "ccl"), ("cuda", "denoise")])
@pytest.mark.parametrize("shape", [SERVING, (3, 33, 130), (0, 4, 4)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float64])
def test_plan_outputs_tile_out_info(backend, op, shape, dtype):
    """The plan's output tensors hold exactly the result's bytes; a
    kernel route's temporaries are only the passes its wrappers run (none
    for a dtype the kernels read in place, bar ccl's re-ranking)."""
    c = _port(backend, op).lower(shape, dtype).compile()
    mem = c.memory_analysis()
    assert c.lowered.plan.output_bytes() == mem.output_size_in_bytes
    if dtype == torch.uint8 and op != "ccl":
        assert mem.temp_size_in_bytes == 0
    assert mem.temp_size_in_bytes is not None


def test_plain_backend_reckons_no_tensors():
    mem = _port("torch", "ychg").lower(SERVING).compile().memory_analysis()
    assert mem.temp_size_in_bytes is None
    assert mem.argument_size_in_bytes == 8 * 8192 * 8192


class _Creations(TorchFunctionMode):
    """Records the element count of every tensor a torch call returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self.sizes.append(out.numel())
        return out


@pytest.mark.parametrize("backend,op", [
    ("fused", "ychg"), ("cuda", "ychg"), ("torch", "ychg"), ("cuda", "ccl"),
    ("cuda", "denoise")])
def test_lowering_makes_no_tensor_of_the_stack(backend, op):
    """No tensor of the stack's shape is made, not even on ``meta``: every
    tensor lowering creates is empty (the dtype probe of ingest)."""
    with _Creations() as mode:
        c = _port(backend, op).lower((8, 21000, 21000)).compile()
        c.cost_analysis(), c.memory_analysis()
    assert mode.sizes and max(mode.sizes) == 0


def test_out_info_predicts_the_run_on_the_cpu():
    """Every field of a run has the shape and dtype ``out_info`` says."""
    rng = np.random.default_rng(20)
    x = (rng.random((3, 21, 40)) < 0.4).astype(np.uint8)
    for backend, ops in OPS_OF.items():
        for op in ops:
            eng = _port(backend, op)
            info = eng.lower(x.shape).out_info
            res = eng.analyze_batch(x)
            for name, shape, dtype in _fields(info):
                got = getattr(res, name)
                assert (tuple(got.shape), got.dtype) == (
                    shape, getattr(torch, dtype)), (backend, op, name)


def test_one_routing_rule_for_the_wrappers_and_the_plan(monkeypatch):
    """``kernels.ops.use_splith`` decides both the run's kernel and the
    plan's route: forcing it sends both to split-H."""
    called = []
    monkeypatch.setattr(kops, "use_splith", lambda *a, **k: True)
    monkeypatch.setattr(kf, "ychg_fused_splith", lambda x, block_h: (
        called.append(block_h) or kf.ychg_fused_splith_plain(x, block_h)))
    eng = _port("fused", "ychg")
    assert eng.lower((2, 16, 8)).route == "splith"
    eng.analyze_batch(np.ones((2, 16, 8), np.uint8))
    assert called == [2048]
    assert _port("cuda", "ychg").lower((2, 16, 8)).route == "splith"


def test_dtype_probe_follows_ingest():
    """The lowered dtype is what ``analyze_batch`` would hand the backend:
    64-bit integers narrowed, then the config's cast."""
    assert _port("torch", "ychg").lower((1, 2, 2), np.uint64).in_info == (
        ShapeDtype((1, 2, 2), torch.uint32))
    cast = _port("fused", "ychg", dtype="int64")
    assert cast.lower((1, 2, 2), torch.float32).in_info.dtype == torch.int32
    assert jax.default_backend() == "cpu"
