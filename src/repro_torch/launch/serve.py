"""The port's serve command: ``--workload ychg`` runs the paper's
image-analysis service in-process, on the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --res 8192 --batch 8                    # on the CUDA device
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --op ccl --res 8192 --batch 8           # another op
  PYTHONPATH=src python -m repro_torch.launch.serve --workload ychg \\
      --res 64 --batch 4 --overload --device cpu

The counterpart of ``repro.launch.serve``'s in-process ``ychg`` pass
(``serve_ychg``), with its ``--op`` and ``--overload`` legs;
:func:`pipeline_pass` serves masks through an op chain. The network front
end, fleet, scene and LM modes come in later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np

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
    serve_ychg(ap.parse_args(argv))


if __name__ == "__main__":
    main()
