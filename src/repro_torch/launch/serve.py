"""The port's serve command: ``--workload ychg`` runs the paper's
image-analysis service on the card, in-process or over the network front
end.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --res 8192 --batch 8                    # on the CUDA device
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --op ccl --res 8192 --batch 8           # another op
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --res 64 --batch 4 --overload --device cpu
  # network modes (repro_torch.frontend):
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --listen 127.0.0.1:8788                 # serve over loopback HTTP
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --connect http://127.0.0.1:8788         # drive a running server
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --res 64 --batch 4 --frontend-smoke --device cpu   # end-to-end assert
  # granule-scale bulk analysis (repro_torch.scene):
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg scene \\
      --granules 4 --scene-height 4096 --scene-width 2048 \\
      --out scene_out --ckpt scene_ckpt       # SIGTERM -> checkpoint; rerun resumes
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --res 64 --batch 4 --scene-smoke --device cpu      # scene end-to-end assert

The counterpart of ``repro.launch.serve``'s in-process ``ychg`` pass
(``serve_ychg``), with its ``--op`` and ``--overload`` legs, of its
``--listen``, ``--connect`` and ``--frontend-smoke`` network modes, and of
its ``scene`` subcommand and ``--scene-smoke``; :func:`pipeline_pass`
serves masks through an op chain. Every mode runs the engine on the card
unless ``--device cpu`` is given. The fleet, SLO and LM modes come in later
slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.data import modis


def derived_masks(res: int, n: int, seed: int = 0) -> List[np.ndarray]:
    """``n`` distinct (res, res) uint8 masks from two ``modis.snowfield``
    draws, the rest rolled and flipped copies of those two: a snowfield at
    8192^2 takes tens of seconds on one host core, a roll a fraction of a
    second."""
    bases = [modis.snowfield(res, seed=seed + i) for i in range(min(n, 2))]
    out = []
    for i in range(n):
        k = i // 2
        m = np.roll(bases[i % 2], (k * 613 % res, k * 977 % res), axis=(0, 1))
        out.append(np.ascontiguousarray(m[::-1] if k % 2 else m))
    return out


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """What one cold/warm/cached run of the service did."""

    backend: str
    pixels_per_pass: int
    t_cold: float
    t_warm: float
    t_cached: float
    cold: tuple        # per-request results of each pass, in submit order
    warm: tuple
    cached: tuple
    batches: dict         # pass name -> device batches it dispatched
    cached_hit_rate: float
    warm_stage_s: dict    # service stage -> seconds summed over the warm pass
    metrics: Any          # ServiceMetrics after the three passes

    @property
    def warm_mpx_s(self) -> float:
        return self.pixels_per_pass / self.t_warm / 1e6

    @property
    def cached_batches(self) -> int:
        return self.batches["cached"]


def serve_passes(engine, masks: Sequence[np.ndarray],
                 fresh: Sequence[np.ndarray], *, op: str = "ychg",
                 timeout: float = 600.0) -> ServeReport:
    """Three timed passes of op ``op`` through one service: cold (first use
    of the bucket shape: kernel build and warm-up), warm (steady-state
    compute on fresh masks), cached (``masks`` again, served from the
    result cache)."""
    from repro_torch.service import ServiceConfig, YCHGService

    side = max(max(m.shape) for m in masks)
    cfg = ServiceConfig(bucket_sides=(side,), max_batch=len(masks))

    def timed_pass(svc, batch):
        t0 = time.perf_counter()
        outs = tuple(f.result(timeout=timeout)
                     for f in [svc.submit(m, op=op) for m in batch])
        return time.perf_counter() - t0, outs

    with YCHGService(engine, cfg) as svc:
        t_cold, cold = timed_pass(svc, masks)
        before_warm = svc.metrics()
        t_warm, warm = timed_pass(svc, fresh)
        before = svc.metrics()
        t_cached, cached = timed_pass(svc, masks)
        m = svc.metrics()
    return ServeReport(
        backend=engine.resolve_backend(op=op),
        pixels_per_pass=sum(int(x.size) for x in fresh),
        t_cold=t_cold, t_warm=t_warm, t_cached=t_cached,
        cold=cold, warm=warm, cached=cached,
        batches={"cold": before_warm.batches,
                 "warm": before.batches - before_warm.batches,
                 "cached": m.batches - before.batches},
        # the cached pass's own hit rate (the lifetime rate would dilute it
        # with the cold/warm passes' unavoidable misses)
        cached_hit_rate=(m.cache_hits - before.cache_hits) / len(masks),
        warm_stage_s={k: v - _stage_seconds(before_warm).get(k, 0.0)
                      for k, v in _stage_seconds(before).items()},
        metrics=m,
    )


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """What one pass of masks through an op chain did."""

    backend: str       # "+"-joined resolved backends of the stages
    seconds: float
    results: tuple     # last stage's per-request results, in submit order
    batches: int       # device batches the pass dispatched
    stage_s: dict      # service stage -> seconds summed over its requests
    metrics: Any


def pipeline_pass(engine, masks: Sequence[np.ndarray],
                  stages: Sequence[str] = ("denoise", "ychg"), *,
                  timeout: float = 600.0) -> PipelineReport:
    """One timed pass of ``masks`` through ``submit_pipeline(stages)`` on a
    service with one bucket of the masks' side and ``max_batch`` of their
    count; the stage split includes the per-stage ``pipeline.<op>``
    dispatch seconds."""
    from repro_torch.service import ServiceConfig, YCHGService

    side = max(max(m.shape) for m in masks)
    cfg = ServiceConfig(bucket_sides=(side,), max_batch=len(masks))
    with YCHGService(engine, cfg) as svc:
        t0 = time.perf_counter()
        outs = tuple(f.result(timeout=timeout) for f in
                     [svc.submit_pipeline(m, stages) for m in masks])
        seconds = time.perf_counter() - t0
        m = svc.metrics()
    return PipelineReport(
        backend="+".join(engine.resolve_backend(op=s) for s in stages),
        seconds=seconds, results=outs, batches=m.batches,
        stage_s=_stage_seconds(m), metrics=m)


def _stage_seconds(metrics) -> dict:
    """Seconds summed per service stage (cache_probe, queue_wait, flush,
    compute, crop, ...) from a metrics snapshot's stage histograms."""
    out: dict = {}
    for labels, snap in metrics.stage_hists:
        stage = dict(labels)["stage"]
        out[stage] = out.get(stage, 0.0) + snap.sum
    return out


def overload_pass(engine, burst: Sequence[np.ndarray], *, max_batch: int,
                  op: str = "ychg", timeout: float = 600.0) -> tuple[int, int]:
    """Offer a burst to a bounded-queue service (``overload_policy="shed"``)
    and return (admitted, shed); raises unless it shed. The delay window, a
    minute, outlasts the burst: unless ``max_batch`` admitted requests fill
    a batch, the two admitted ones stay pending until the service closes
    and drains them, so the shed count does not depend on how long each
    submit's content hash takes (at 8192^2 it can outlast a short window
    and free the slots mid-burst)."""
    from repro_torch.service import ServiceConfig, ServiceOverloaded, YCHGService

    side = max(max(m.shape) for m in burst)
    ocfg = ServiceConfig(bucket_sides=(side,), max_batch=max_batch,
                         max_delay_ms=60_000.0, max_queue_depth=2,
                         overload_policy="shed")
    shed, futures = 0, []
    with YCHGService(engine, ocfg) as osvc:
        for b in burst:
            try:
                futures.append(osvc.submit(b, op=op))
            except ServiceOverloaded:
                shed += 1
        om = osvc.metrics()
    for f in futures:
        f.result(timeout=timeout)   # admitted requests still resolve
    if shed == 0 or om.shed != shed:
        raise SystemExit(
            "overload pass failed: admission control shed nothing")
    return len(futures), shed


# one human-readable number per op for the per-tile report
_OP_STAT_NAME = {"ychg": "hyperedges", "ccl": "components",
                 "denoise": "mean"}


def _op_stat(op: str, out) -> Any:
    if op == "ychg":
        return int(out.n_hyperedges[0])
    if op == "ccl":
        return int(out.n_components.reshape(-1)[0])
    return round(float(out.image.mean()), 4)


def serve_ychg(args) -> ServeReport:
    """The paper's image-analysis workload behind the service, on the
    engine's device: a cold, a warm and a cached pass of ``--batch`` masks
    at ``--res`` through op ``--op``, and with ``--overload`` a burst
    against a bounded queue."""
    from repro_torch.engine import Engine

    op = args.op
    engine = Engine(device=args.device)
    masks = derived_masks(args.res, 2 * args.batch)
    report = serve_passes(engine, masks[:args.batch], masks[args.batch:],
                          op=op)
    m = report.metrics
    stats = [_op_stat(op, o) for o in report.cold]
    print(f"{op} service[{report.backend}] on {engine.device}: "
          f"{args.batch} x {args.res}^2 masks")
    print(f"  cold  {report.t_cold * 1e3:8.1f}ms (includes kernel build)")
    print(f"  warm  {report.t_warm * 1e3:8.1f}ms "
          f"({report.warm_mpx_s:.0f} Mpx/s)")
    print(f"  cached{report.t_cached * 1e3:8.1f}ms "
          f"(hit rate {report.cached_hit_rate:.0%})")
    print(f"  p50 {m.p50_latency_ms:.1f}ms p95 {m.p95_latency_ms:.1f}ms over "
          f"{m.completed} requests ({m.completed_from_cache} from cache) "
          f"in {m.batches} device batches {report.batches}; "
          f"{_OP_STAT_NAME[op]} per tile: {stats}")
    print("  warm pass by stage (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(report.warm_stage_s.items())))
    if args.overload:
        n_burst = 4 * args.batch
        burst = derived_masks(args.res, n_burst, seed=10_000)
        admitted, shed = overload_pass(engine, burst, max_batch=args.batch,
                                       op=op)
        print(f"  overload burst of {n_burst} at max_queue_depth=2: "
              f"{admitted} admitted, {shed} shed "
              f"(shed rate {shed / n_burst:.0%})")
    return report


def _parse_hostport(s: str, default_host: str = "127.0.0.1"):
    """"HOST:PORT", ":PORT", "PORT" or "http://HOST:PORT" -> (host, port)."""
    if "//" in s:
        s = s.split("//", 1)[1]
    s = s.rstrip("/")
    host, _, port = s.rpartition(":")
    return (host or default_host), int(port)


def _service_config(args, **overrides):
    from repro_torch.service import ServiceConfig

    sides = (tuple(int(b) for b in args.buckets.split(","))
             if args.buckets else (args.res,))
    knobs = dict(bucket_sides=sides, max_batch=args.batch,
                 max_queue_depth=args.max_queue_depth,
                 bucket_queue_depth=args.bucket_queue_depth,
                 overload_policy=args.policy)
    knobs.update(overrides)
    return ServiceConfig(**knobs)


def serve_listen(args) -> None:
    """Serve the image service over HTTP (and the framed TCP RPC with
    ``--rpc-listen``) until interrupted."""
    from repro_torch.engine import Engine
    from repro_torch.frontend import ServerThread
    from repro_torch.service import YCHGService

    host, port = _parse_hostport(args.listen)
    rpc_port = (_parse_hostport(args.rpc_listen)[1]
                if args.rpc_listen else None)
    engine = Engine(device=args.device)
    with YCHGService(engine, _service_config(args)) as svc:
        with ServerThread(svc, host=host, port=port,
                          rpc_port=rpc_port) as srv:
            extra = (f" (rpc on {host}:{srv.rpc_port})"
                     if rpc_port is not None else "")
            print(f"yCHG frontend listening on http://{host}:{srv.port}"
                  f"{extra}; engine on {engine.device}, buckets "
                  f"{svc.config.bucket_sides}, max_batch "
                  f"{svc.config.max_batch}", flush=True)
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                print("shutting down", flush=True)
                path = obs.auto_dump("serve-shutdown")
                if path:
                    print(f"flight recorder dumped to {path}", flush=True)


def serve_connect(args) -> None:
    """Client mode: drive a running front end with ``--batch`` masks at
    ``--res`` in one streamed batch and report the wire time."""
    from repro_torch.frontend import YCHGClient

    host, port = _parse_hostport(args.connect)
    masks = derived_masks(args.res, args.batch)
    px = args.batch * args.res * args.res
    with YCHGClient(host, port) as client:
        health = client.wait_ready(timeout=60.0)
        print(f"connected to {host}:{port}: backend {health['backend']}")
        t0 = time.perf_counter()
        items = list(client.analyze_batch(masks))
        dt = time.perf_counter() - t0
        failed = [it for it in items if not it.ok]
        if failed:
            raise SystemExit(
                f"{len(failed)} of {len(items)} requests failed; first: "
                f"{failed[0].status} {failed[0].error}")
        edges = [int(it.result["n_hyperedges"]) for it in
                 sorted(items, key=lambda it: it.id)]
        print(f"  wire  {dt * 1e3:8.1f}ms for {args.batch} x {args.res}^2 "
              f"masks ({px / dt / 1e6:.0f} Mpx/s); hyperedges: {edges}")


def check_metrics_page(text: str) -> float:
    """Parse a ``/metrics`` page; every histogram series must have its
    buckets, ``_sum`` and ``_count``, the buckets cumulative and ending at
    the count, and the latency histograms' total count must equal
    completed minus cache-served requests. Returns that count; raises
    ``SystemExit`` on any failure."""
    from repro_torch.obs import base_family, parse_prom_text

    page = parse_prom_text(text)
    lat_count = 0.0
    for fam in sorted(n for n, t in page.types.items() if t == "histogram"):
        series = {}
        for smp in page.samples:
            if base_family(smp.name) != fam:
                continue
            key = tuple(p for p in smp.labels if p[0] != "le")
            d = series.setdefault(key, {"b": [], "sum": None, "count": None})
            if smp.name.endswith("_bucket"):
                d["b"].append(smp.value)
            elif smp.name.endswith("_sum"):
                d["sum"] = smp.value
            elif smp.name.endswith("_count"):
                d["count"] = smp.value
        for key, d in series.items():
            if d["sum"] is None or d["count"] is None or not d["b"]:
                raise SystemExit(
                    f"metrics: histogram {fam} series {dict(key)} is "
                    f"missing _sum/_count/buckets")
            if d["b"] != sorted(d["b"]) or d["b"][-1] != d["count"]:
                raise SystemExit(
                    f"metrics: histogram {fam} series {dict(key)} buckets "
                    f"disagree with _count")
            if fam == "ychg_request_latency_seconds":
                lat_count += d["count"]

    def scalar(name):
        vals = [smp.value for smp in page.samples
                if smp.name == name and not smp.labels]
        return vals[0] if vals else 0.0

    want = (scalar("ychg_completed_total")
            - scalar("ychg_completed_from_cache_total"))
    if lat_count != want:
        raise SystemExit(f"metrics: latency histogram count {lat_count} != "
                         f"completed-minus-cached {want}")
    return lat_count


def overload_over_wire(engine, config, hold_mask, mask) -> float:
    """One admission slot, held by an in-process submit parked in a long
    delay window, so a wire request sheds deterministically: it must come
    back HTTP 429 with a positive Retry-After, and the shed counters must
    move in ``/metrics``. Returns the 429's ``retry_after_s``."""
    from repro_torch.frontend import (
        FrontendOverloaded,
        ServerThread,
        YCHGClient,
    )
    from repro_torch.service import YCHGService

    ocfg = dataclasses.replace(config, max_delay_ms=10_000.0,
                               max_queue_depth=1, bucket_queue_depth=1,
                               overload_policy="shed")
    with YCHGService(engine, ocfg) as osvc:
        holder = osvc.submit(hold_mask)
        with ServerThread(osvc) as srv, \
                YCHGClient("127.0.0.1", srv.port) as client:
            try:
                client.analyze(mask)
                raise SystemExit("overload: expected HTTP 429, got a result")
            except FrontendOverloaded as e:
                retry = e.retry_after_s
                if not retry > 0:
                    raise SystemExit("overload: 429 carried no positive "
                                     "retry_after_s")
            metrics = client.metrics_text()
        for needle in ("ychg_shed_total 1", "ychg_shed_bucket_total{"):
            if needle not in metrics:
                raise SystemExit(f"overload: {needle!r} missing from "
                                 f"/metrics after a shed")
    holder.result(timeout=600)   # the admitted request still resolves
    return retry


def frontend_smoke(args) -> None:
    """End-to-end assert over a real loopback socket (ephemeral port):

      1. a streamed client batch is BIT-IDENTICAL (values, dtypes, shapes)
         to in-process ``YCHGService.submit`` on the same masks;
      2. one traced request leaves a single flight-recorder trace whose
         spans cover client -> frontend -> scheduler -> engine in order
         (skipped under ``YCHG_TRACE=0``);
      3. every ``/metrics`` series parses as Prometheus text and the
         latency histogram ties out against the request counters;
      4. at a full admission queue the wire answer is HTTP 429 with a
         Retry-After, and the shed counters move in ``/metrics``.

    Exits nonzero on any failure.
    """
    from repro_torch.engine import Engine
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.service import YCHGService

    masks = derived_masks(args.res, args.batch + 1)
    masks, fresh = masks[:args.batch], masks[args.batch]
    engine = Engine(device=args.device)
    config = _service_config(args)
    with YCHGService(engine, config) as svc, \
            ServerThread(svc) as srv, \
            YCHGClient("127.0.0.1", srv.port) as client:
        items = {it.id: it for it in client.analyze_batch(masks)}
        want = [svc.submit(m).result(timeout=600).to_host() for m in masks]
        for i, host_res in enumerate(want):
            item = items.get(i)
            if item is None or not item.ok:
                raise SystemExit(f"frontend smoke: mask {i} failed over the "
                                 f"wire: {item and item.error}")
            for field, arr in host_res.items():
                a, b = np.asarray(arr), item.result[field]
                if not (np.array_equal(a, b) and a.dtype == b.dtype
                        and a.shape == b.shape):
                    raise SystemExit(
                        f"frontend smoke: field {field!r} of mask {i} is "
                        f"not bit-identical over the wire")
        print(f"frontend smoke: {len(masks)} masks round-tripped over "
              f"loopback HTTP bit-identical to in-process submit on "
              f"{engine.device} ({svc.metrics().backend})", flush=True)

        if obs.tracing_enabled():
            tid = obs.new_trace_id()
            client.analyze(fresh, trace_id=tid)
            events = [e for e in client.debug_traces().get("traceEvents", [])
                      if e.get("args", {}).get("trace_id") == tid]
            names = {e["name"] for e in events}
            needed = {"client.encode", "client.wire", "frontend.parse",
                      "cache.probe", "scheduler.admission",
                      "scheduler.queue_wait", "scheduler.flush",
                      "engine.compute", "engine.crop"}
            if needed - names:
                raise SystemExit(f"frontend smoke [trace]: spans missing "
                                 f"from the flight recorder: "
                                 f"{sorted(needed - names)}")
            ts = {e["name"]: e["ts"] for e in events}
            chain = ["client.encode", "frontend.parse",
                     "scheduler.admission", "engine.compute", "engine.crop"]
            for a, b in zip(chain, chain[1:]):
                if ts[b] < ts[a]:   # same process, same clock: strict
                    raise SystemExit(f"frontend smoke [trace]: span {b!r} "
                                     f"starts before {a!r}")
            print("frontend smoke: one trace covers client -> frontend -> "
                  "scheduler -> engine with ordered spans", flush=True)

        lat_count = check_metrics_page(client.metrics_text())
        print(f"frontend smoke: /metrics parsed clean; latency histogram "
              f"count {lat_count:.0f} ties out against the request "
              f"counters", flush=True)

    overload_over_wire(engine, config, masks[0], masks[1])
    print("frontend smoke: overload answered 429 with Retry-After and the "
          "per-bucket shed counter moved", flush=True)


def _scene_manifest(args):
    from repro_torch.scene import manifest_from_json, synthetic_manifest

    if args.manifest:
        with open(args.manifest) as f:
            return manifest_from_json(f.read())
    return synthetic_manifest(args.granules, args.scene_height,
                              args.scene_width, seed=args.seed)


def scene_run(args) -> None:
    """``serve.py ... scene``: run a granule manifest as a resumable bulk
    job. SIGTERM/SIGINT checkpoint the current tile row and exit cleanly;
    rerunning the same command resumes from the last checkpoint and the
    output files come out byte-identical to an uninterrupted run."""
    import signal

    from repro_torch.engine import Engine
    from repro_torch.scene import BulkJob, BulkJobConfig, SceneProgress

    manifest = _scene_manifest(args)
    cfg = BulkJobConfig(out_dir=args.out, ckpt_dir=args.ckpt,
                        tile_h=args.tile_h, stack_tiles=args.stack,
                        checkpoint_every=args.checkpoint_every)
    progress = SceneProgress()
    engine = Engine(device=args.device)
    job = BulkJob(engine, manifest, cfg, progress=progress)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    px = sum(s.pixels for s in manifest)
    print(f"bulk job on {engine.device}: {len(manifest)} granules "
          f"({px / 1e6:.1f} Mpx total), tile_h {cfg.tile_h}, "
          f"stacks of {cfg.stack_tiles}, checkpoint every "
          f"{cfg.checkpoint_every} stacks -> {args.ckpt}", flush=True)
    report = job.run(max_stacks=args.max_stacks, should_stop=stop.is_set)
    snap = progress.snapshot()
    done_px = report.tiles_done * cfg.tile_h * manifest[0].width
    rate = (done_px / report.elapsed_s / 1e6
            if report.elapsed_s > 0 else 0.0)
    print(f"bulk job {report.status}: {report.granules_done} granules, "
          f"{report.tiles_done} tiles in {report.elapsed_s:.2f}s "
          f"({rate:.0f} Mpx/s); tiles {snap.tiles_done}/{snap.tiles_total}, "
          f"resumes {report.resumes}, "
          f"stitch {snap.stitch_time_s * 1e3:.1f}ms", flush=True)
    for path in report.written:
        print(f"  wrote {path}", flush=True)
    dump = obs.auto_dump("scene-run-end")
    if dump:
        print(f"flight recorder dumped to {dump}", flush=True)
    if not report.completed:
        print("interrupted — rerun the same command to resume from the "
              "checkpoint", flush=True)


def _host_identical(got: dict, want: dict) -> bool:
    """Every field of two host result dicts equal in value, dtype, shape."""
    return set(got) == set(want) and all(
        np.array_equal(np.asarray(got[f]), np.asarray(want[f]))
        and np.asarray(got[f]).dtype == np.asarray(want[f]).dtype
        and np.asarray(got[f]).shape == np.asarray(want[f]).shape
        for f in want)


def scene_smoke(args) -> None:
    """End-to-end assert for the scene tier (repro_torch.scene):

      1. **stitch bit-identity** — streaming a synthetic granule through
         ``SceneRunner`` (ragged last strip included) produces all seven
         result fields BIT-IDENTICAL (values, dtypes, shapes) to one
         whole-scene ``engine.analyze`` call;
      2. **kill -> resume byte-identity** — a ``BulkJob`` stopped
         mid-granule (with its newest checkpoint then truncated, so the
         Checkpointer must fall back to the previous valid one) resumes
         and writes result files byte-identical to an uninterrupted run;
      3. **online/offline agreement** — the same tiles replayed through
         the HTTP front end's NDJSON batch endpoint match per-tile
         ``engine.analyze`` bit for bit, ``stitch_tile_runs`` over the
         wire results equals the offline scene runs, and the attached
         ``SceneProgress`` surfaces in ``/metrics``.

    Exits nonzero on any failure.
    """
    import glob
    import os
    import tempfile
    import warnings

    from repro_torch.data import scenes
    from repro_torch.engine import Engine
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.scene import (
        BulkJob,
        BulkJobConfig,
        GranuleReader,
        SceneProgress,
        SceneRunner,
        read_scene_result,
        stitch_tile_runs,
        synthetic_manifest,
    )
    from repro_torch.service import ServiceConfig, YCHGService

    engine = Engine(device=args.device)

    # leg 1: stitch bit-identity, ragged last strip (45 = 3*16 - 3)
    h, w, tile_h = 45, args.res, 16
    mask = scenes.scene(h, w, seed=7, cell=8)
    reader = GranuleReader.from_array(mask, tile_h, granule_id="smoke")
    got = SceneRunner(engine, stack_tiles=2).analyze_scene(reader).to_host()
    if not _host_identical(got, engine.analyze(mask).to_host()):
        raise SystemExit("scene smoke [stitch]: the stitched result is not "
                         "bit-identical to the whole-scene analysis")
    print(f"scene smoke: {reader.n_tiles} stitched strips of a {h}x{w} "
          f"scene bit-identical to one whole-scene call on {engine.device}",
          flush=True)

    # leg 2: kill -> resume byte-identity through a corrupted checkpoint
    manifest = synthetic_manifest(2, 40, args.res, seed=3, cell=8)
    with tempfile.TemporaryDirectory() as tmp:
        def job(tag, progress=None):
            return BulkJob(engine, manifest, BulkJobConfig(
                out_dir=os.path.join(tmp, tag, "out"),
                ckpt_dir=os.path.join(tmp, tag, "ckpt"),
                tile_h=8, stack_tiles=1, checkpoint_every=1),
                progress=progress)

        straight = job("straight").run()
        if not straight.completed:
            raise SystemExit("scene smoke [resume]: uninterrupted run did "
                             "not complete")
        first = job("killed").run(max_stacks=3)
        if first.completed:
            raise SystemExit("scene smoke [resume]: max_stacks=3 should "
                             "have interrupted the job mid-granule")
        # hard-kill flavour: truncate the newest checkpoint's shard so the
        # resume must warn and fall back to the previous valid step
        steps = sorted(glob.glob(os.path.join(tmp, "killed", "ckpt",
                                              "step_*")))
        shard = glob.glob(os.path.join(steps[-1], "*.npz"))[0]
        with open(shard, "r+b") as f:
            f.truncate(8)
        progress = SceneProgress()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            second = job("killed", progress).run()
        if not any(issubclass(c.category, RuntimeWarning) for c in caught):
            raise SystemExit("scene smoke [resume]: truncated checkpoint "
                             "resumed without a RuntimeWarning fallback")
        if not second.completed or second.resumes < 1:
            raise SystemExit(f"scene smoke [resume]: resumed run ended "
                             f"{second.status} with {second.resumes} resumes")
        for spec in manifest:
            a = os.path.join(tmp, "straight", "out",
                             f"{spec.granule_id}.ychg")
            b = os.path.join(tmp, "killed", "out", f"{spec.granule_id}.ychg")
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() != fb.read():
                    raise SystemExit(
                        f"scene smoke [resume]: {spec.granule_id} output "
                        f"differs between straight and killed+resumed runs")
        offline = read_scene_result(os.path.join(
            tmp, "straight", "out", f"{manifest[0].granule_id}.ychg"))
        snap = progress.snapshot()
        print(f"scene smoke: kill at stack 3 + corrupt newest checkpoint, "
              f"resume wrote byte-identical outputs "
              f"(resumes {second.resumes}, tiles "
              f"{snap.tiles_done}/{snap.tiles_total})", flush=True)

        # leg 3: online/offline agreement over loopback NDJSON. Buckets are
        # square on max(h, w), so (tile_h, W) strips land in the W bucket.
        spec = manifest[0]
        reader = GranuleReader.open(spec, 8)
        tiles = [reader.read_tile(t) for t in range(reader.n_tiles)]
        svc_cfg = ServiceConfig(bucket_sides=(spec.width,),
                                max_batch=args.batch)
        with YCHGService(engine, svc_cfg) as svc, \
                ServerThread(svc) as srv, \
                YCHGClient("127.0.0.1", srv.port) as client:
            svc.attach_scene_progress(progress)
            items = {it.id: it for it in client.analyze_batch(tiles)}
            tile_runs = []
            for i, tile in enumerate(tiles):
                item = items.get(i)
                if item is None or not item.ok:
                    raise SystemExit(
                        f"scene smoke [online]: tile {i} failed over the "
                        f"wire: {item and item.error}")
                if not _host_identical(item.result,
                                       engine.analyze(tile).to_host()):
                    raise SystemExit(f"scene smoke [online]: tile {i} not "
                                     f"bit-identical over the wire")
                tile_runs.append(item.result["runs"])
            online_runs = stitch_tile_runs(tile_runs, tiles)
            if not np.array_equal(online_runs, offline.runs):
                raise SystemExit(
                    "scene smoke [online]: stitching the wire-served tile "
                    "runs does not match the offline scene result")
            metrics = client.metrics_text()
        want = {"ychg_scene_tiles_done": snap.tiles_done,
                "ychg_scene_resumes_total": snap.resumes}
        for name, value in want.items():
            if f"{name} {value}" not in metrics:
                raise SystemExit(f"scene smoke [online]: '{name} {value}' "
                                 f"missing from /metrics with a scene "
                                 f"progress attached")
        print(f"scene smoke: {len(tiles)} tiles over loopback NDJSON "
              f"bit-identical per tile, online stitch == offline scene "
              f"result, scene gauges on /metrics", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("command", nargs="?", choices=["scene"],
                    help="optional subcommand: 'scene' runs a resumable "
                         "granule bulk job (repro_torch.scene)")
    ap.add_argument("--workload", default="ychg", choices=["ychg"])
    ap.add_argument("--op", default="ychg", choices=["ychg", "ccl", "denoise"],
                    help="the operator the service runs on every mask")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--overload", action="store_true",
                    help="add a bounded-queue overload pass and fail unless "
                         "admission control sheds")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the CUDA device; 'cpu' is the only way "
                         "onto the CPU")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve over HTTP until interrupted")
    ap.add_argument("--rpc-listen", default=None, metavar="HOST:PORT",
                    help="with --listen: also serve the framed TCP RPC")
    ap.add_argument("--connect", default=None, metavar="URL",
                    help="run the workload against a running front end "
                         "(http://HOST:PORT)")
    ap.add_argument("--frontend-smoke", action="store_true",
                    help="loopback HTTP end-to-end assert (bit-identical "
                         "round trip, trace, /metrics, 429 on overload)")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated bucket sides (default: --res)")
    ap.add_argument("--max-queue-depth", type=int, default=None)
    ap.add_argument("--bucket-queue-depth", type=int, default=None)
    ap.add_argument("--policy", default="block", choices=["block", "shed"],
                    help="overload policy for --listen/--frontend-smoke")
    ap.add_argument("--scene-smoke", action="store_true",
                    help="scene tier end-to-end assert (stitch identity, "
                         "kill/resume byte identity, online/offline)")
    scn = ap.add_argument_group("scene", "knobs for the 'scene' subcommand")
    scn.add_argument("--scene-height", type=int, default=2048)
    scn.add_argument("--scene-width", type=int, default=1024)
    scn.add_argument("--granules", type=int, default=2,
                     help="synthetic granules (ignored with --manifest)")
    scn.add_argument("--seed", type=int, default=0,
                     help="content seed of the first synthetic granule")
    scn.add_argument("--manifest", default=None, metavar="JSON",
                     help="granule manifest file (repro_torch.scene "
                          "manifest_to_json format)")
    scn.add_argument("--tile-h", type=int, default=256,
                     help="strip height the scene is windowed into")
    scn.add_argument("--stack", type=int, default=4,
                     help="strips per device call")
    scn.add_argument("--out", default="scene_out",
                     help="directory for the .ychg result files")
    scn.add_argument("--ckpt", default="scene_ckpt",
                     help="checkpoint directory (resume point)")
    scn.add_argument("--checkpoint-every", type=int, default=4,
                     help="stacks between mid-granule checkpoints")
    scn.add_argument("--max-stacks", type=int, default=None,
                     help="stop (with a checkpoint) after N stacks")
    args = ap.parse_args(argv)
    if args.command == "scene":
        scene_run(args)
    elif args.scene_smoke:
        scene_smoke(args)
    elif args.frontend_smoke:
        frontend_smoke(args)
    elif args.listen:
        serve_listen(args)
    elif args.connect:
        serve_connect(args)
    else:
        serve_ychg(args)


if __name__ == "__main__":
    main()
