"""Parity: the port's ``Engine`` on the CPU against the JAX ``Engine``.

The same seeded numpy masks go to ``repro_torch.engine.Engine(device="cpu")``
(both of its backends) and to ``repro.engine.Engine(YCHGConfig(backend=
"jax"))``; every field must match exactly, dtypes included. Also: ``auto``
resolution as data, the CUDA default, and carrying a JAX config across.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ychg_modis as jconfigs  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import YCHGConfig as JConfig  # noqa: E402
from repro_torch.configs.ychg_modis import (  # noqa: E402
    config as workload_config,
    engine_config_from_jax,
)
from repro_torch.engine import (  # noqa: E402
    Engine,
    EngineConfig,
    UnknownOpError,
    registry,
)
from repro_torch.engine import engine as engine_mod  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS  # noqa: E402


def _masks(shape, seed, p=0.5):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


def assert_result_same(got, want):
    """Port result == JAX result: batched flag, and every field's dtype,
    shape and values, through ``to_host`` as well."""
    assert got.batched == want.batched
    assert got.batch_size == want.batch_size
    gh, wh = got.to_host(), want.to_host()
    assert set(gh) == set(wh) == set(SUMMARY_FIELDS)
    for f in SUMMARY_FIELDS:
        assert gh[f].dtype == wh[f].dtype, f
        assert gh[f].shape == wh[f].shape, f
        np.testing.assert_array_equal(gh[f], wh[f], err_msg=f)


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(JConfig(backend="jax"))


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_analyze_batch_matches_jax(backend, jax_engine):
    stack = _masks((3, 40, 260), 1)
    got = Engine(EngineConfig(backend=backend), device="cpu").analyze_batch(stack)
    assert_result_same(got, jax_engine.analyze_batch(stack))


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_analyze_single_matches_jax(backend, jax_engine):
    img = _masks((45, 77), 2)
    eng = Engine(EngineConfig(backend=backend), device="cpu")
    got = eng.analyze(img)
    assert not got.batched and got.batch_size == 1
    assert_result_same(got, jax_engine.analyze(img))
    # a tensor passes through ingest untouched
    assert_result_same(eng.analyze(torch.from_numpy(img)),
                       jax_engine.analyze(img))


def test_analyze_stream_matches_jax(jax_engine):
    items = [_masks((20, 30), 3), _masks((2, 16, 40), 4),
             _masks((33, 9), 5)[::-1]]          # a non-contiguous view
    eng = Engine(device="cpu")
    got = list(eng.analyze_stream(iter(items)))
    want = list(jax_engine.analyze_stream(iter(items)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_result_same(g, w)
    assert list(eng.analyze_stream([])) == []


def test_analyze_stream_bad_item_delivers_prior_result():
    eng = Engine(device="cpu")
    stream = eng.analyze_stream([_masks((8, 8), 6), np.zeros((2, 2, 2, 2))])
    first = next(stream)
    assert first.batch_size == 1
    with pytest.raises(ValueError, match="stream items"):
        next(stream)


def test_dtype_cast_config_matches_jax():
    img = np.random.default_rng(7).integers(0, 4, (19, 23)).astype(np.int32)
    got = Engine(EngineConfig(dtype="bool"), device="cpu").analyze(img)
    want = JEngine(JConfig(backend="jax", dtype="bool")).analyze(img)
    assert_result_same(got, want)


def test_tensor_on_another_device_moves_to_the_engine():
    """A tensor on another device than the engine's is copied onto the
    engine's device, not run where it lies (the meta device stands in for
    the card here: the plain reference runs on it, the kernel path refuses
    it)."""
    x = torch.from_numpy(_masks((2, 5, 6), 11))
    r = Engine(EngineConfig(backend="torch"), device="meta").analyze_batch(x)
    assert r.runs.device.type == "meta" and r.runs.dtype == torch.int32
    with pytest.raises(ValueError, match="device meta"):
        Engine(EngineConfig(backend="fused"), device="meta").analyze_batch(x)
    eng = Engine(device="cpu")
    assert eng._ingest(x) is x


def test_engine_rank_checks():
    eng = Engine(device="cpu")
    with pytest.raises(ValueError, match="analyze_batch"):
        eng.analyze(np.zeros((2, 3, 4), np.uint8))
    with pytest.raises(ValueError, match="analyze_batch expects"):
        eng.analyze_batch(np.zeros((3, 4), np.uint8))


# --------------------------------------------------------------- resolution


def test_auto_resolution_is_data():
    """cpu -> the plain reference, cuda -> the kernels: a pure function of
    the registered specs and the platform key."""
    assert registry.resolve("auto", platform="cpu").name == "torch"
    assert registry.resolve("auto", platform="cuda").name == "fused"
    assert set(registry.backend_names()) == {"torch", "fused"}
    eng = Engine(device="cpu")
    assert eng.platform == "cpu" and eng.resolve_backend() == "torch"
    assert Engine(EngineConfig(backend="fused"),
                  device="cpu").resolve_backend() == "fused"


def test_default_engine_needs_cuda(monkeypatch):
    """``Engine()`` means the card; without one it raises and names the way
    onto the CPU instead of carrying on there quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine()
    from repro_torch.service import YCHGService
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YCHGService()
    assert engine_mod.Engine(device="cpu").device == torch.device("cpu")


def test_unported_ops_are_unknown():
    """Every op of the JAX package is ported (``ccl`` and ``denoise``
    resolve); an op neither package has raises the typed error."""
    eng = Engine(device="cpu")
    for op in ("ccl", "denoise"):
        assert eng.analyze(_masks((4, 4), 8), op=op).batch_size == 1
    with pytest.raises(UnknownOpError):
        eng.analyze(_masks((4, 4), 8), op="warp")
    with pytest.raises(UnknownOpError):
        Engine(device="cpu", op="warp").resolve_backend()


def test_result_block_until_ready_and_summary():
    r = Engine(device="cpu").analyze_batch(_masks((2, 5, 6), 9))
    assert r.event is None and r.block_until_ready() is r
    s = r.to_summary()
    assert s.runs.shape == (2, 6) and s.n_hyperedges.dtype == torch.int32


# ------------------------------------------------------- carried-over config


def test_engine_config_from_jax():
    jcfg = JConfig(backend="fused", block_w=64, block_h=32,
                   stream_vmem_budget=1, interpret=True, dtype="uint8")
    cfg = engine_config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == EngineConfig(backend="fused", block_w=64, block_h=32,
                               stream_vmem_budget=1, dtype="uint8")
    section = jconfigs.config().engine
    assert (engine_config_from_jax(dataclasses.asdict(section))
            == workload_config().engine.to_engine_config())
    with pytest.raises(ValueError, match="unknown engine config fields"):
        engine_config_from_jax({**dataclasses.asdict(jcfg), "bogus": 1})


def test_carried_config_routes_and_matches():
    """Under one policy (here: split-H on every stack, block_h=32) the port's
    fused backend equals the JAX fused backend."""
    jcfg = JConfig(backend="fused", block_h=32, stream_vmem_budget=1)
    stack = _masks((2, 70, 150), 10)
    got = Engine(engine_config_from_jax(dataclasses.asdict(jcfg)),
                 device="cpu").analyze_batch(stack)
    assert_result_same(got, JEngine(jcfg).analyze_batch(stack))
