"""The port's batch mesh (``repro_torch.sharding``, ``Engine(mesh=...)``)
against the JAX package's.

The JAX engine sees one CPU device here, so its meshed engine runs
``shard_map`` over a 1-device mesh (``make_batch_mesh()``). The port's
meshed engine runs over meshes of 1, 2 and 3 ``cpu`` entries (one device
may be listed several times: the stack is cut into as many chunks), on
B = 0, 1, 5 and 7, ragged H and W. Its results must equal JAX's meshed
engine and both packages' unmeshed engines, every field and dtype, exactly;
denoise on float32 inputs against the JAX package within the rule of
``tests/test_torch_denoise.py`` (1 ulp, at most 1 in 10^4 outputs, so
none at these sizes), and bit for bit against the port's unmeshed engine.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import scenes as jscenes  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import YCHGConfig as JConfig  # noqa: E402
from repro.engine import YCHGEngine as JYCHGEngine  # noqa: E402
from repro.sharding import batch_sharded_analyze as jbatch_sharded  # noqa: E402
from repro.sharding import make_batch_mesh as jmake_batch_mesh  # noqa: E402
from repro_torch.data import scenes  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    Engine,
    EngineConfig,
    YCHGEngine,
    registry,
)
from repro_torch.scene import GranuleReader, SceneRunner  # noqa: E402
from repro_torch.service import ResultCache, ServiceConfig, YCHGService  # noqa: E402
from repro_torch.service.cache import make_key, serialize_key  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    BatchMesh,
    batch_sharded_analyze,
    make_batch_mesh,
    pad_batch,
)

MESH_SIZES = [1, 2, 3]
BATCHES = [0, 1, 5, 7]
# (H, W) of each B: ragged, H = 1 and W = 1 among them
SHAPES = {0: (9, 14), 1: (1, 23), 5: (19, 37), 7: (13, 1)}
INPUTS = ["ychg", "ccl", "denoise", "denoise-float32"]
# the port's backend names -> the JAX package's
JAX_NAMES = {"torch": "jax", "cuda": "pallas", "fused": "fused",
             "serial": "serial", "scalar": "scalar"}


def _stack(b, float_input=False, seed=0):
    h, w = SHAPES[b]
    rng = np.random.default_rng(seed + 17 * b)
    if float_input:
        x = rng.random((b, h, w)).astype(np.float32)
        x[rng.random((b, h, w)) < 0.05] = np.float32(4.0)   # impulses
        return x
    return (rng.random((b, h, w)) < 0.5).astype(np.uint8)


def _cpu_mesh(n, axis_name="data"):
    return make_batch_mesh(axis_name, devices=["cpu"] * n)


def _assert_exact(got, want, context=""):
    assert set(got) == set(want), context
    for f in want:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.dtype == w.dtype and g.shape == w.shape, context + f
        assert g.tobytes() == w.tobytes(), context + f


def _assert_denoise_close(got, want):
    """1 ulp, at most 1 in 10^4 outputs differing."""
    g, w = got["image"], want["image"]
    assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
    same = (g.view(np.int32) == w.view(np.int32)) | (np.isnan(g)
                                                      & np.isnan(w))
    assert np.all(np.abs(g[~same] - w[~same]) <= np.spacing(np.abs(w[~same])))
    assert (~same).sum() <= g.size // 10_000


_JAX_CACHE = {}


def _jax_results(b, kind):
    """(JAX meshed, JAX unmeshed) host results of one input, computed once."""
    key = (b, kind)
    if key not in _JAX_CACHE:
        op = kind.split("-")[0]
        x = _stack(b, kind.endswith("float32"))
        meshed = JEngine(JConfig(), mesh=jmake_batch_mesh())
        _JAX_CACHE[key] = (meshed.analyze_batch(x, op=op).to_host(),
                           JEngine().analyze_batch(x, op=op).to_host())
    return _JAX_CACHE[key]


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", MESH_SIZES)
def test_meshed_engine_matches_jax(n, b, kind):
    op = kind.split("-")[0]
    x = _stack(b, kind.endswith("float32"))
    engine = Engine(device="cpu").with_mesh(_cpu_mesh(n))
    got = engine.analyze_batch(x, op=op)
    assert got.batch_size == b
    got = got.to_host()
    _assert_exact(got, Engine(device="cpu").analyze_batch(x, op=op).to_host(),
                  "port unmeshed: ")
    j_meshed, j_plain = _jax_results(b, kind)
    _assert_exact(j_meshed, j_plain, "jax meshed vs unmeshed: ")
    if kind == "denoise-float32":
        _assert_denoise_close(got, j_meshed)
    else:
        _assert_exact(got, j_meshed, "jax meshed: ")


@pytest.mark.parametrize("n", MESH_SIZES)
def test_meshed_single_mask_and_stream(n):
    """``analyze`` (a B=1 view) and ``analyze_stream`` through the mesh."""
    img = _stack(5)[2]
    engine = Engine(device="cpu", mesh=_cpu_mesh(n))
    want = JEngine(JConfig(), mesh=jmake_batch_mesh()).analyze(img)
    got = engine.analyze(img)
    assert not got.batched
    _assert_exact(got.to_host(), want.to_host())
    outs = list(engine.analyze_stream([img, _stack(7)]))
    _assert_exact(outs[0].to_host(), want.to_host())
    _assert_exact(outs[1].to_host(),
                  JEngine().analyze_batch(_stack(7)).to_host())


@pytest.mark.parametrize("n", MESH_SIZES)
def test_meshed_pipeline_matches_jax(n):
    x = _stack(5, float_input=True)
    got = Engine(device="cpu", mesh=_cpu_mesh(n)).run_pipeline(
        x, ["denoise", "ychg"]).to_host()
    want = JEngine(JConfig(), mesh=jmake_batch_mesh()).run_pipeline(
        x, ["denoise", "ychg"]).to_host()
    _assert_exact(got, want)
    _assert_exact(got, Engine(device="cpu").run_pipeline(
        x, ["denoise", "ychg"]).to_host())


@pytest.mark.parametrize("n", MESH_SIZES)
def test_meshed_split_h_matches_jax(n):
    """``with_config(stream_vmem_budget=0)`` keeps the mesh and sends ychg
    to the split-H kernel's route."""
    x = _stack(5)
    engine = Engine(device="cpu", mesh=_cpu_mesh(n)).with_config(
        stream_vmem_budget=0, block_h=8)
    assert engine.mesh == _cpu_mesh(n)
    assert engine.config.stream_vmem_budget == 0
    jengine = JEngine(JConfig(), mesh=jmake_batch_mesh()).with_config(
        stream_vmem_budget=0, block_h=8)
    _assert_exact(engine.analyze_batch(x).to_host(),
                  jengine.analyze_batch(x).to_host())


def test_with_mesh_none_detaches():
    mesh = _cpu_mesh(2)
    engine = Engine(device="cpu", op="ccl").with_mesh(mesh)
    assert engine.mesh is mesh and engine.op == "ccl"
    assert engine.resolve_backend(op="ychg") == "fused"
    plain = engine.with_mesh(None)
    assert plain.mesh is None and plain.op == "ccl"
    assert plain.device == engine.device
    assert plain.resolve_backend(op="ychg") == "torch"
    x = _stack(5)
    _assert_exact(plain.analyze_batch(x).to_host(),
                  engine.analyze_batch(x).to_host())


def test_mesh_axis_and_device_type_mismatch_raise():
    with pytest.raises(ValueError, match="mesh_axis"):
        Engine(EngineConfig(mesh_axis="batch"), device="cpu",
               mesh=_cpu_mesh(1, "data"))
    engine = Engine(EngineConfig(mesh_axis="batch"), device="cpu",
                    mesh=_cpu_mesh(2, "batch"))
    assert engine.mesh.shape == {"batch": 2}
    with pytest.raises(ValueError, match="device type"):
        Engine(device="cpu", mesh=BatchMesh(("meta",)))
    with pytest.raises(ValueError):
        BatchMesh(())


@pytest.mark.parametrize("op", ["ychg", "ccl", "denoise"])
def test_resolve_backend_under_a_mesh_matches_jax(op):
    """``auto`` and every explicit backend, with a mesh attached: the same
    choice, or the same refusal, as the JAX engine's (names mapped)."""
    jmesh = jmake_batch_mesh()
    mesh = _cpu_mesh(2)
    auto = Engine(device="cpu", mesh=mesh).resolve_backend(op=op)
    assert JAX_NAMES[auto] == JEngine(JConfig(), mesh=jmesh).resolve_backend(
        op=op)
    for name in registry.backend_names(op):
        jname = JAX_NAMES[name]
        try:
            want = JEngine(JConfig(backend=jname),
                           mesh=jmesh).resolve_backend(op=op)
        except ValueError:
            with pytest.raises(ValueError, match="does not support mesh"):
                Engine(EngineConfig(backend=name), device="cpu",
                       mesh=mesh).resolve_backend(op=op)
            continue
        got = Engine(EngineConfig(backend=name), device="cpu",
                     mesh=mesh).resolve_backend(op=op)
        assert JAX_NAMES[got] == want


def test_mesh_capable_flags_match_jax():
    from repro.engine import registry as jregistry

    for op in ("ychg", "ccl", "denoise"):
        for name in registry.backend_names(op):
            assert (registry.get_backend(name, op).supports_mesh
                    == jregistry.get_backend(JAX_NAMES[name],
                                             op).supports_mesh), (op, name)


def test_ychg_engine_shim_warns_and_matches_jax():
    x = _stack(5)
    with pytest.warns(DeprecationWarning, match="YCHGEngine is deprecated"):
        engine = YCHGEngine(device="cpu", mesh=_cpu_mesh(3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jengine = JYCHGEngine(mesh=jmake_batch_mesh())
    assert engine.op == "ychg" and isinstance(engine, Engine)
    _assert_exact(engine.analyze_batch(x).to_host(),
                  jengine.analyze_batch(x).to_host())


@pytest.mark.parametrize("n", MESH_SIZES)
def test_batch_sharded_analyze_shim_warns_and_matches_jax(n):
    x = _stack(7)
    with pytest.warns(DeprecationWarning, match="batch_sharded_analyze"):
        got = batch_sharded_analyze(x, mesh=_cpu_mesh(n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jbatch_sharded(x)
    for f in ("runs", "cut_vertices", "transitions", "births", "deaths",
              "n_hyperedges", "n_transitions"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f


def test_make_batch_mesh_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="sees none"):
        make_batch_mesh()
    with pytest.warns(DeprecationWarning), \
            pytest.raises(RuntimeError, match="sees none"):
        batch_sharded_analyze(_stack(1))


def test_batch_mesh_is_stable_and_hashable():
    a, b = _cpu_mesh(3), make_batch_mesh(devices=[torch.device("cpu")] * 3)
    assert a == b and hash(a) == hash(b)
    assert repr(a) == "BatchMesh(axis_name='data', devices=('cpu', 'cpu', 'cpu'))"
    assert a.axis_names == ("data",) and a.shape == {"data": 3}
    assert a != _cpu_mesh(2)


def test_pad_batch_pads_with_blank_images():
    x = torch.from_numpy(_stack(5))
    padded, b = pad_batch(x, 3)
    assert b == 5 and padded.shape == (6, *x.shape[1:])
    assert padded.dtype == x.dtype
    assert torch.equal(padded[:5], x) and not padded[5].any()
    same, b = pad_batch(x, 5)
    assert b == 5 and same is x


def test_service_cache_key_carries_the_mesh():
    """The twin of ``tests/test_service.py::test_make_key_discriminates_
    every_component``'s mesh leg, and through the service: a meshed and
    an unmeshed engine sharing one cache never serve each other's
    entries."""
    a = np.ascontiguousarray(_stack(1)[0])
    base = make_key(a, "fused", EngineConfig())
    meshed = make_key(a, "fused", EngineConfig(), _cpu_mesh(1))
    assert meshed != base
    assert serialize_key(meshed) != serialize_key(base)
    assert make_key(a, "fused", EngineConfig(), _cpu_mesh(2)) != meshed
    cache = ResultCache(16)
    cfg = ServiceConfig(bucket_sides=(32,), max_batch=2, max_delay_ms=1.0)
    engine = Engine(EngineConfig(backend="fused"), device="cpu")
    with YCHGService(engine, cfg, cache=cache) as plain:
        want = plain.submit(a).result(timeout=120).to_host()
    with YCHGService(engine.with_mesh(_cpu_mesh(2)), cfg,
                     cache=cache) as svc:
        got = svc.submit(a).result(timeout=120).to_host()
        m = svc.metrics()
    assert m.batches == 1 and m.cache_hits == 0
    assert len(cache) == 2
    _assert_exact(got, want)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_stitched_scene_bit_identical_under_mesh(n):
    """The twin of ``tests/test_scene.py::test_stitched_scene_bit_identical
    _under_mesh``: stacks of strips go through the mesh."""
    mask = scenes.scene(40, 16, seed=11, cell=8)
    np.testing.assert_array_equal(mask, jscenes.scene(40, 16, seed=11,
                                                      cell=8))
    engine = Engine(EngineConfig(backend="auto"), device="cpu",
                    mesh=_cpu_mesh(n))
    reader = GranuleReader.from_array(mask, 8)
    got = SceneRunner(engine, stack_tiles=3).analyze_scene(reader)
    _assert_exact(got.to_host(), Engine(device="cpu").analyze(mask).to_host())
    _assert_exact(got.to_host(), JEngine().analyze(mask).to_host())
