"""Service observability: a thread-safe recorder + a frozen snapshot.

The recorder is written from two threads (submit side and the scheduler
loop) under one lock; ``snapshot()`` is the only read surface and returns
an immutable :class:`ServiceMetrics`, so callers never see half-updated
counters.

Latency is held in fixed-boundary log-spaced histograms (one per request
bucket, see :mod:`repro_torch.obs.histogram`) rather than a bounded deque: the
histograms render as real Prometheus ``_bucket``/``_sum``/``_count``
series, and because the boundaries are process-independent constants, a
fleet router can roll worker pages up by plain summation. They hold
*compute* completions only — cache hits are counted in
``completed_from_cache`` but never observed, so p50/p95 describe what a
miss actually costs instead of averaging in the hit rate. Per-stage
timings (cache probe, admission wait, queue wait, flush assembly, device
compute, crop) land in a parallel family of stage histograms.

Mpx/s is real request pixels served over *active* time: each completion
contributes the gap since the previous completion, capped at its own
latency — so idle gaps between bursts no longer deflate throughput (two
bursts separated by a sleep report the same rate as one burst).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.histogram import (
    DEFAULT_LATENCY_BOUNDS,
    Histogram,
    HistogramSnapshot,
    empty_snapshot,
)

LabelPairs = Tuple[Tuple[str, str], ...]
HistSeries = Tuple[Tuple[LabelPairs, HistogramSnapshot], ...]

# Stage taxonomy (docs/observability.md is the contract): every stage
# histogram key must come from this set so dashboards and the fleet
# rollup never meet a surprise label.
STAGES = (
    "cache_probe",   # content-key hash + local cache lookup
    "peer_probe",    # sibling cache RPC on a local miss (peered only)
    "admission",     # admission-gate wait (block policy backpressure)
    "queue_wait",    # admitted -> batch assembly started
    "flush",         # pad_stack + device transfer + dispatch issue
    "compute",       # device execution (dispatch -> block_until_ready)
    "crop",          # per-request result slicing off the padded batch
)

# Smallest latency credited to a completion when accounting active time:
# guards div-by-zero on sub-clock-resolution cache-adjacent completions.
_MIN_ACTIVE_S = 1e-3


def bucket_labels(bucket: Any) -> LabelPairs:
    """Service bucket key -> Prometheus label pairs. Buckets are
    (op, side, dtype) tuples everywhere in the multi-op service (the
    2-tuple (side, dtype) form predates the op dimension and still renders
    for older recordings); anything else gets a single opaque ``bucket``
    label so the renderer never crashes."""
    if isinstance(bucket, tuple) and len(bucket) == 3:
        return (("op", str(bucket[0])), ("side", str(bucket[1])),
                ("dtype", str(bucket[2])))
    if isinstance(bucket, tuple) and len(bucket) == 2:
        return (("side", str(bucket[0])), ("dtype", str(bucket[1])))
    if bucket is None:
        return ()
    return (("bucket", str(bucket)),)


@dataclasses.dataclass(frozen=True)
class ServiceMetrics:
    """One consistent point-in-time view of the service."""

    submitted: int            # requests accepted by submit()
    completed: int            # futures fulfilled (hits + computed)
    completed_from_cache: int  # of those, served straight from the cache
    cache_hits: int
    cache_misses: int
    coalesced: int            # duplicate-in-flight requests joined to a leader
    batches: int              # bucket stacks dispatched to the engine
    queue_depth: int          # waiting + pending-in-bucket at snapshot time
    shed: int                 # submits rejected with ServiceOverloaded
    blocked: int              # submits that waited at the admission gate
    compiled_shapes: Tuple[Tuple[int, int, int], ...]  # distinct dispatched
    hit_rate: float
    p50_latency_ms: float     # submit -> result ready, compute misses only
    p95_latency_ms: float
    mpx_per_s: float          # real (unpadded) request pixels served
    pad_fraction: float       # dispatched pixels that were padding
    backend: str              # engine's resolved backend at snapshot time
    # sheds attributed to the rejected request's (side, dtype) bucket —
    # sorted ((bucket, count), ...) pairs, so fairness regressions (one hot
    # bucket shedding everyone) are visible per bucket, not just in total
    shed_by_bucket: Tuple[Tuple[Any, int], ...] = ()
    peer_hits: int = 0        # local misses served by a sibling's cache
    peer_misses: int = 0      # outbound probes no sibling could answer
    # traffic-class/tenant attribution (docs/traffic.md): every shed also
    # lands in shed_by_class; quota sheds additionally in shed_by_tenant;
    # shed_deadline/shed_quota split the total by the check that tripped
    shed_by_class: Tuple[Tuple[str, int], ...] = ()
    shed_by_tenant: Tuple[Tuple[str, int], ...] = ()
    shed_deadline: int = 0    # DeadlineExceeded sheds at admission
    shed_quota: int = 0       # TenantQuotaExceeded sheds at admission
    # scene/bulk workload attached via service.attach_scene_progress():
    # granule-scale streaming progress (repro.scene), all zero when no
    # scene job is publishing through this service
    scene_tiles_done: int = 0
    scene_tiles_total: int = 0
    scene_resumes: int = 0          # checkpoint restores across the job
    scene_stitch_time_s: float = 0.0  # host-side seam/stitch accumulation
    # end-to-end latency histograms, one series per request bucket
    # (labels like (("side","64"),("dtype","uint8"))); the sum of every
    # series' count equals completed - completed_from_cache
    latency_hists: HistSeries = ()
    # per-stage timing histograms, labels (("stage",...), + bucket labels)
    stage_hists: HistSeries = ()

    @property
    def n_compiled_shapes(self) -> int:
        return len(self.compiled_shapes)

    def latency_hist(self) -> HistogramSnapshot:
        """All request buckets merged into one end-to-end histogram."""
        merged = empty_snapshot(DEFAULT_LATENCY_BOUNDS)
        for _labels, snap in self.latency_hists:
            merged = merged.merge(snap)
        return merged


class MetricsRecorder:
    def __init__(self, latency_window: int = 4096):
        # latency_window is accepted for API compatibility but unused:
        # fixed-boundary histograms are unbounded-in-time by design (the
        # windowing that made percentiles "recent" now belongs to the
        # scrape interval of whatever reads /metrics)
        del latency_window
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.completed_from_cache = 0
        self.coalesced = 0
        self.batches = 0
        self._latency_hists: Dict[Any, Histogram] = {}
        self._stage_hists: Dict[Tuple[str, Any, Optional[str]],
                                Histogram] = {}
        self._shapes: set = set()
        self._real_px = 0
        self._dispatched_px = 0
        self._served_px = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._active_s = 0.0

    def _note_active(self, latency_s: float, now: float) -> None:
        """Credit active time for one completion: the gap since the last
        completion, capped at this request's own latency (so a burst of
        overlapping requests is not double-counted and an idle gap before
        a burst contributes at most one request's latency)."""
        credit = max(latency_s, _MIN_ACTIVE_S)
        anchor = self._t_last if self._t_last is not None else self._t_first
        if anchor is not None:
            credit = min(credit, max(0.0, now - anchor))
        self._active_s += credit

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            if self._t_first is None:
                self._t_first = time.monotonic()

    def record_coalesced(self) -> None:
        with self._lock:
            self.coalesced += 1

    def record_coalesced_rejected(self, n: int) -> None:
        """Riders that coalesced onto a leader which was then shed (or hit
        close()) were never accepted: back their submit/coalesce counts
        out, so submitted - completed keeps tracking real outstanding
        work."""
        with self._lock:
            self.submitted -= n
            self.coalesced -= n

    def record_cache_hit(self, pixels: int,
                         now: Optional[float] = None) -> None:
        """A request served from the cache: counts toward completions and
        served pixels, but stays OUT of the latency histograms — a flood
        of ~0 ms hits would otherwise deflate p50/p95 for compute
        traffic. Contributes (at most) the minimum active-time quantum."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self.completed += 1
            self.completed_from_cache += 1
            self._served_px += pixels
            self._note_active(0.0, now)
            self._t_last = now

    def record_batch(self, shape: Tuple[int, int, int], real_px: int) -> None:
        with self._lock:
            self.batches += 1
            self._shapes.add(shape)
            self._real_px += real_px
            self._dispatched_px += shape[0] * shape[1] * shape[2]

    def record_complete(self, latency_s: float, pixels: int,
                        n_requests: int = 1, bucket: Any = None,
                        now: Optional[float] = None) -> None:
        """A computed batch's requests finished. The latency histogram is
        observed once per request (not per batch) so the histogram count
        stays equal to ``completed - completed_from_cache``."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self.completed += n_requests
            self._served_px += pixels * n_requests
            hist = self._latency_hists.get(bucket)
            if hist is None:
                hist = self._latency_hists[bucket] = Histogram(
                    DEFAULT_LATENCY_BOUNDS)
            for _ in range(n_requests):
                hist.observe(latency_s)
            self._note_active(latency_s, now)
            self._t_last = now

    def observe_stage(self, stage: str, bucket: Any,
                      seconds: float, klass: Optional[str] = None) -> None:
        """One stage timing sample (see STAGES for the taxonomy).

        ``klass`` adds a ``class`` label to the series — the service
        passes it for the class-differentiated stages (``queue_wait``:
        the one a lower priority class actually pays) so an SLO dashboard
        reads per-class wait straight off ``ychg_stage_seconds``.
        Tenants deliberately get NO histogram label (unbounded
        cardinality); per-tenant visibility is the shed counters."""
        key = (stage, bucket, klass)
        with self._lock:
            hist = self._stage_hists.get(key)
            if hist is None:
                hist = self._stage_hists[key] = Histogram(
                    DEFAULT_LATENCY_BOUNDS)
        hist.observe(max(0.0, seconds))

    def snapshot(self, *, queue_depth: int, cache_hits: int,
                 cache_misses: int, backend: str, shed: int = 0,
                 blocked: int = 0,
                 shed_by_bucket: Tuple[Tuple[Any, int], ...] = (),
                 shed_by_class: Tuple[Tuple[str, int], ...] = (),
                 shed_by_tenant: Tuple[Tuple[str, int], ...] = (),
                 shed_deadline: int = 0, shed_quota: int = 0,
                 peer_hits: int = 0, peer_misses: int = 0,
                 scene_tiles_done: int = 0, scene_tiles_total: int = 0,
                 scene_resumes: int = 0, scene_stitch_time_s: float = 0.0,
                 ) -> ServiceMetrics:
        with self._lock:
            latency_hists = tuple(
                (bucket_labels(bucket), hist.snapshot())
                for bucket, hist in sorted(
                    self._latency_hists.items(), key=lambda kv: str(kv[0])))
            stage_hists = tuple(
                ((("stage", stage),) + bucket_labels(bucket)
                 + ((("class", klass),) if klass is not None else ()),
                 hist.snapshot())
                for (stage, bucket, klass), hist in sorted(
                    self._stage_hists.items(), key=lambda kv: str(kv[0])))
            merged = empty_snapshot(DEFAULT_LATENCY_BOUNDS)
            for _labels, snap in latency_hists:
                merged = merged.merge(snap)
            total = cache_hits + cache_misses
            return ServiceMetrics(
                submitted=self.submitted,
                completed=self.completed,
                completed_from_cache=self.completed_from_cache,
                cache_hits=cache_hits,
                cache_misses=cache_misses,
                coalesced=self.coalesced,
                batches=self.batches,
                queue_depth=queue_depth,
                shed=shed,
                blocked=blocked,
                compiled_shapes=tuple(sorted(self._shapes)),
                hit_rate=cache_hits / total if total else 0.0,
                p50_latency_ms=merged.quantile(0.50) * 1e3,
                p95_latency_ms=merged.quantile(0.95) * 1e3,
                mpx_per_s=(
                    self._served_px / self._active_s / 1e6
                    if self._active_s > 0 else 0.0
                ),
                pad_fraction=(
                    1.0 - self._real_px / self._dispatched_px
                    if self._dispatched_px else 0.0
                ),
                backend=backend,
                shed_by_bucket=shed_by_bucket,
                shed_by_class=shed_by_class,
                shed_by_tenant=shed_by_tenant,
                shed_deadline=shed_deadline,
                shed_quota=shed_quota,
                peer_hits=peer_hits,
                peer_misses=peer_misses,
                scene_tiles_done=scene_tiles_done,
                scene_tiles_total=scene_tiles_total,
                scene_resumes=scene_resumes,
                scene_stitch_time_s=scene_stitch_time_s,
                latency_hists=latency_hists,
                stage_hists=stage_hists,
            )
