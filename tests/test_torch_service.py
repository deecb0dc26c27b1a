"""Parity: the port's ``YCHGService`` on a CPU engine against the JAX
service, on the same ragged masks in one bucket.

No wall-clock assertions (tests/README.md timing policy): results are held
to the JAX service's and to the plain reference, and the cache is checked
through the registry's call counters.
"""

import argparse
import gc
import threading
import weakref

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
    """Ops and chains naming an op no package has raise the typed error;
    a pipeline key passed to ``submit`` points at ``submit_pipeline``."""
    with YCHGService(Engine(device="cpu"),
                     ServiceConfig(bucket_sides=(64,))) as svc:
        with pytest.raises(UnknownOpError):
            svc.submit(RAGGED[0], op="warp")
        with pytest.raises(UnknownOpError):
            svc.submit_pipeline(RAGGED[0], ["denoise", "warp"])
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
        res=32, batch=2, overload=True, device="cpu", workload="ychg",
        op="ychg"))
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


def test_a_closed_service_is_freed_without_the_garbage_collector():
    """Once closed, the scheduler lets go of the service's callbacks: a
    used, closed and dropped service, and its cache of results, are freed
    by reference counting alone."""
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    gc.collect()
    gc.disable()
    try:
        svc = YCHGService(Engine(device="cpu"), cfg)
        for m in RAGGED[:3] + RAGGED[:1]:   # three misses and a hit
            svc.analyze(m, timeout=TIMEOUT)
        svc.close()
        refs = weakref.ref(svc), weakref.ref(svc.cache)
        del svc
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


# ------------------------------------------------------ spans and stages
# Ordering, nesting and presence of the spans that cut the host stages;
# nothing here reads a duration.

NEW_STAGES = ("key_copy", "key_hash", "pad_stack", "h2d")


@pytest.fixture
def tracing():
    """Tracing on (the default) for the test, whatever it was before."""
    from repro_torch import obs

    was = obs.tracing_enabled()
    obs.configure(enabled=True)
    yield obs
    obs.configure(enabled=was)


def _by_name(tr):
    out = {}
    for name, t0, t1, meta in tr.spans():
        out.setdefault(name, []).append((t0, t1, meta))
    return out


def _minflt(meta):
    n = meta["minflt"]
    return isinstance(n, int) and n >= 0


class _GatedEngine(Engine):
    """Holds every dispatch at the analyze_batch door until ``go`` is set."""

    def __init__(self):
        super().__init__(device="cpu")
        self.go = threading.Event()

    def analyze_batch(self, stack, **kw):
        assert self.go.wait(TIMEOUT), "engine gate never opened"
        return super().analyze_batch(stack, **kw)


def test_probe_is_cut_into_key_copy_then_key_hash(tracing):
    """Inside ``cache.probe``: ``cache.key_copy`` from its start, then
    ``cache.key_hash``, on misses and on a hit; the key is
    ``make_key``'s, bit for bit."""
    eng = Engine(device="cpu")
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    masks = RAGGED[:3]
    traces = [tracing.Trace() for _ in range(4)]
    with YCHGService(eng, cfg) as svc:
        got = [svc.submit(m, trace=t).result(timeout=TIMEOUT)
               for m, t in zip(masks, traces)]
        hit = svc.submit(masks[0], trace=traces[3]).result(timeout=TIMEOUT)
        for m, g in zip(masks, got):
            key = make_key(m, eng.resolve_backend(), eng.config, op="ychg")
            assert svc.cache.get(key) is g
    assert hit is got[0]
    for tr in traces:
        s = _by_name(tr)
        (p0, p1, probe), = s["cache.probe"]
        (c0, c1, copy), = s["cache.key_copy"]
        (h0, h1, _), = s["cache.key_hash"]
        assert p0 == c0 <= c1 <= h0 <= h1 <= p1
        assert _minflt(copy)
    assert _by_name(traces[3])["cache.probe"][0][2]["outcome"] == "hit"


def test_flush_is_cut_into_pad_stack_then_h2d_on_every_rider(tracing):
    """Four riders of one flush (a long batching window, flushed by
    size): each trace holds ``scheduler.pad_stack`` then
    ``scheduler.h2d`` inside ``scheduler.flush``, the batch's own spans."""
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4,
                        max_delay_ms=60_000.0)
    traces = [tracing.Trace() for _ in range(4)]
    with YCHGService(Engine(device="cpu"), cfg) as svc:
        futs = [svc.submit(m, trace=t) for m, t in zip(RAGGED[:4], traces)]
        for f, m in zip(futs, RAGGED[:4]):
            assert_host_same(f.result(timeout=TIMEOUT).to_host(),
                             Engine(device="cpu").analyze(m).to_host())
        assert svc.metrics().batches == 1
    cut = set()
    for tr in traces:
        s = _by_name(tr)
        (f0, f1, flush), = s["scheduler.flush"]
        (a0, a1, pad), = s["scheduler.pad_stack"]
        (b0, b1, _), = s["scheduler.h2d"]
        assert f0 <= a0 <= a1 <= b0 <= b1 <= f1
        assert flush["occupancy"] == 4 and _minflt(pad)
        cut.add((f0, f1, a0, a1, pad["minflt"], b0, b1))
    assert len(cut) == 1


def test_new_stages_in_stage_hists_and_on_the_metrics_page(tracing):
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.obs import parse_prom_text

    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    with YCHGService(Engine(device="cpu"), cfg) as svc, \
            ServerThread(svc) as srv, \
            YCHGClient("127.0.0.1", srv.port) as client:
        for m in RAGGED[:3]:
            svc.analyze(m, timeout=TIMEOUT)
        m = svc.metrics()
        text = client.metrics_text()
    hists = {}
    for labels, snap in m.stage_hists:
        stage = dict(labels)["stage"]
        hists[stage] = hists.get(stage, 0) + snap.count
    # a sample a request for the key's copy and hash, a batch for the rest
    assert hists["key_copy"] == hists["key_hash"] == hists["cache_probe"] == 3
    assert hists["pad_stack"] == hists["h2d"] == hists["flush"] == m.batches
    page = {}
    for s in parse_prom_text(text).samples:
        if s.name == "ychg_stage_seconds_count":
            stage = dict(s.labels)["stage"]
            page[stage] = page.get(stage, 0) + s.value
    for stage in NEW_STAGES:
        assert page[stage] == hists[stage] > 0, stage


def test_service_idle_only_on_a_request_that_finds_the_service_empty(
        tracing):
    """The first request finds the service empty and carries
    ``service.idle``; one that arrives while it is in flight does not; the
    next, after both are back, carries the stretch from the moment the
    service emptied to its own probe."""
    eng = _GatedEngine()
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    ta, tb, tc = (tracing.Trace() for _ in range(3))
    with YCHGService(eng, cfg) as svc:
        fa = svc.submit(RAGGED[0], trace=ta)
        fb = svc.submit(RAGGED[1], trace=tb)
        eng.go.set()
        fa.result(timeout=TIMEOUT)
        fb.result(timeout=TIMEOUT)
        svc.submit(RAGGED[2], trace=tc).result(timeout=TIMEOUT)
    a, b, c = (_by_name(t) for t in (ta, tb, tc))
    assert len(a["service.idle"]) == 1
    assert a["service.idle"][0][1] == a["cache.probe"][0][0]
    assert "service.idle" not in b
    (i0, i1, _), = c["service.idle"]
    assert i1 == c["cache.probe"][0][0]
    assert i0 >= max(a["engine.compute"][0][1], b["engine.compute"][0][1])


def test_pipeline_path_keeps_its_stage_spans_and_stays_exact(tracing):
    """A compound request's flush: ``pipeline.<op>`` a stage after
    ``scheduler.h2d``, and the answer equals feeding the cropped first
    stage back in as a request of its own."""
    rng = np.random.default_rng(7)
    imgs = [rng.random(s).astype(np.float32) * (rng.random(s) < 0.6)
            for s in [(17, 23), (30, 12)]]
    traces = [tracing.Trace() for _ in imgs]
    cfg = ServiceConfig(bucket_sides=(32,), max_batch=2,
                        max_delay_ms=60_000.0)
    with YCHGService(Engine(device="cpu"), cfg) as svc:
        futs = [svc.submit_pipeline(x, ["denoise", "ychg"], trace=t)
                for x, t in zip(imgs, traces)]
        piped = [f.result(timeout=TIMEOUT) for f in futs]
    with YCHGService(Engine(device="cpu"),
                     ServiceConfig(bucket_sides=(32,))) as svc:
        for x, p in zip(imgs, piped):
            mid = svc.submit(x, op="denoise").result(timeout=TIMEOUT)
            seq = svc.submit(mid.to_host()["image"],
                             op="ychg").result(timeout=TIMEOUT)
            assert_host_same(p.to_host(), seq.to_host())
    for tr in traces:
        s = _by_name(tr)
        (f0, f1, _), = s["scheduler.flush"]
        (a0, a1, _), = s["scheduler.pad_stack"]
        (b0, b1, _), = s["scheduler.h2d"]
        (d0, d1, _), = s["pipeline.denoise"]
        (y0, y1, _), = s["pipeline.ychg"]
        assert f0 <= a0 <= a1 <= b0 <= b1 <= d0 <= d1 <= y0 <= y1 <= f1


def test_tracing_off_records_no_spans_and_still_counts_stages(tracing):
    tracing.recorder().clear()
    tracing.configure(enabled=False)
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    with YCHGService(Engine(device="cpu"), cfg) as svc:
        for m in RAGGED[:3]:
            svc.analyze(m, timeout=TIMEOUT)
        m = svc.metrics()
    assert tracing.recorder().traces() == []
    counted = {dict(labels)["stage"] for labels, snap in m.stage_hists
               if snap.count}
    assert set(NEW_STAGES) | {"cache_probe", "flush", "compute"} <= counted
