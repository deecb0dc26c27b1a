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

The counterpart of ``repro.launch.serve``'s in-process ``ychg`` pass
(``serve_ychg``), with its ``--op`` and ``--overload`` legs, and of its
``--listen``, ``--connect`` and ``--frontend-smoke`` network modes;
:func:`pipeline_pass` serves masks through an op chain. Every mode runs
the engine on the card unless ``--device cpu`` is given. The fleet, scene
and LM modes come in later slices.
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


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
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
    args = ap.parse_args(argv)
    if args.frontend_smoke:
        frontend_smoke(args)
    elif args.listen:
        serve_listen(args)
    elif args.connect:
        serve_connect(args)
    else:
        serve_ychg(args)


if __name__ == "__main__":
    main()
