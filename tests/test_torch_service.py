"""Parity: the port's ``YCHGService`` on a CPU engine against the JAX
service, on the same ragged masks in one bucket.

No wall-clock assertions (tests/README.md timing policy): results are held
to the JAX service's and to the plain reference, and the cache is checked
through the registry's call counters.
"""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import modis as jmodis  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import YCHGConfig as JConfig  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import YCHGService as JService  # noqa: E402
from repro_torch.core import ychg  # noqa: E402
from repro_torch.data import modis  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, UnknownOpError, registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.service import (  # noqa: E402
    ResultCache,
    ServiceConfig,
    YCHGService,
    make_key,
    pad_stack,
    pick_bucket_side,
)
from repro_torch.service.cache import serialize_key  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS  # noqa: E402

TIMEOUT = 300.0  # generous future bound: fail, never hang


def _mask(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.uint8)


RAGGED = [_mask((17, 23), 1), _mask((64, 64), 2), _mask((33, 40), 3),
          _mask((5, 60), 4), _mask((1, 1), 5), np.zeros((30, 30), np.uint8),
          np.ones((16, 48), np.uint8), _mask((64, 1), 6)]


def assert_host_same(got: dict, want: dict):
    assert set(got) == set(want) == set(SUMMARY_FIELDS)
    for f in SUMMARY_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        assert got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_service_matches_jax_service(backend):
    """Ragged masks in one 64-bucket, duplicates included: every port
    result equals the JAX service's and the plain reference on the raw
    mask."""
    masks = RAGGED + [RAGGED[0].copy(), RAGGED[3].copy()]
    cfg = dict(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    eng = Engine(EngineConfig(backend=backend), device="cpu")
    with YCHGService(eng, ServiceConfig(**cfg)) as svc:
        got = [f.result(timeout=TIMEOUT) for f in [svc.submit(m) for m in masks]]
    with JService(JEngine(JConfig(backend="jax")), JServiceConfig(**cfg)) as js:
        want = [f.result(timeout=TIMEOUT) for f in [js.submit(m) for m in masks]]
    for g, w, m in zip(got, want, masks):
        assert not g.batched and g.batch_size == 1
        assert_host_same(g.to_host(), w.to_host())
        ref = ychg.analyze(torch.from_numpy(m))
        s = g.to_summary()
        for f in SUMMARY_FIELDS:
            assert torch.equal(getattr(s, f), getattr(ref, f)), f


def test_cache_hit_skips_backend():
    eng = Engine(device="cpu")
    backend = eng.resolve_backend()
    with YCHGService(eng, ServiceConfig(bucket_sides=(64,), max_batch=8,
                                        max_delay_ms=1.0)) as svc:
        first = [svc.analyze(m, timeout=TIMEOUT) for m in RAGGED[:4]]
        n_after_miss = registry.call_count(backend)
        again = [svc.analyze(m, timeout=TIMEOUT) for m in RAGGED[:4]]
        assert registry.call_count(backend) == n_after_miss
        m = svc.metrics()
    assert all(a is b for a, b in zip(first, again))
    assert m.cache_hits == 4 and m.completed_from_cache == 4


def test_cache_keys_differ_from_jax_keys():
    """The config's class name is in the key: the port's EngineConfig and the
    JAX YCHGConfig never share an entry, even for the same mask and knobs."""
    mask = RAGGED[0]
    port = make_key(mask, "fused", EngineConfig())
    jax_ = make_key(mask, "fused", JConfig())
    assert serialize_key(port) != serialize_key(jax_)
    assert b"EngineConfig:" in serialize_key(port)
    cache = ResultCache(4)
    cache.put(jax_, "jax result")
    assert cache.get(port) is None


def test_unported_ops_and_pipelines_raise():
    with YCHGService(Engine(device="cpu"),
                     ServiceConfig(bucket_sides=(64,))) as svc:
        with pytest.raises(UnknownOpError):
            svc.submit(RAGGED[0], op="ccl")
        with pytest.raises(UnknownOpError):
            svc.submit_pipeline(RAGGED[0], ["denoise", "ychg"])
        with pytest.raises(ValueError, match="pipeline"):
            svc.submit(RAGGED[0], op="denoise+ychg")


def test_batching_helpers():
    assert pick_bucket_side((17, 23), (16, 32, 64)) == 32
    with pytest.raises(ValueError, match="largest service bucket"):
        pick_bucket_side((65, 2), (16, 64))
    stack = pad_stack([RAGGED[0], RAGGED[4]], 32, 4, np.dtype(np.uint8))
    assert stack.shape == (4, 32, 32) and stack[2:].sum() == 0
    np.testing.assert_array_equal(stack[0, :17, :23], RAGGED[0])


def test_modis_copy_matches_jax():
    np.testing.assert_array_equal(modis.snowfield(96, seed=3),
                                  jmodis.snowfield(96, seed=3))
    np.testing.assert_array_equal(modis.striped(120, 50),
                                  jmodis.striped(120, 50))
    assert modis.hyperedge_series() == jmodis.hyperedge_series()


def test_serve_cli_on_cpu(capsys):
    """The serve command's in-process pass, with the overload leg."""
    report = serve.serve_ychg(argparse.Namespace(
        res=32, batch=2, overload=True, device="cpu", workload="ychg"))
    out = capsys.readouterr().out
    assert "ychg service[torch] on cpu" in out and "shed" in out
    assert report.cached_batches == 0 and report.cached_hit_rate == 1.0
    assert report.batches["cold"] >= 1 and report.batches["warm"] >= 1
    assert sum(report.batches.values()) == report.metrics.batches
    masks = serve.derived_masks(32, 4)
    assert len({m.tobytes() for m in masks}) == 4
    for res, m in zip(report.cold + report.warm, masks):
        assert int(res.n_hyperedges[0]) == int(
            ychg.hyperedge_count(torch.from_numpy(m)))
