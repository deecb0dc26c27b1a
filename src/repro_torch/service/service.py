"""`YCHGService` — the batching, caching service over the port's `Engine`.

The port's counterpart of ``repro.service.service``, serving every
registered op (``ychg``, ``ccl``, ``denoise``) and ordered op chains
(``submit_pipeline``).

Between "a request arrives" and "the engine runs" sit three layers, each
independently testable:

  1. a content-addressed LRU **result cache** (``service.cache``): a hit
     fulfils the future immediately and never touches the backend;
     duplicate masks *in flight* coalesce onto one leader request, so a
     burst of identical masks costs one bucket slot. The cache check, the
     coalesce, and the completion-side ``cache.put`` + leader retirement
     all run under one lock, so a duplicate either joins the leader or
     hits the cache — there is no window where it can re-dispatch;
  2. a **micro-batching scheduler** (:mod:`repro.service.scheduler`):
     misses queue into per-``(op, side, dtype)`` shape buckets (an op only
     ever batches with itself) and flush when a bucket reaches its op's
     ``max_batch`` or its oldest request ages past
     ``max_delay_ms``; stacks are padded to the bucket side AND to the
     power-of-two **sub-batch ladder** rung covering the flush occupancy,
     so a lone request pays for one image, not ``max_batch``, while the
     compiled-shape budget stays ``len(bucket_sides) * (log2(max_batch)
     + 1)`` per dtype. ``max_queue_depth`` + ``overload_policy`` add
     admission control: past the bound, ``submit`` blocks (backpressure)
     or raises :class:`ServiceOverloaded` (shed);
  3. a **double-buffered dispatch loop**: up to ``inflight_buckets`` bucket
     computations are outstanding at once, so the batching work for bucket
     n+1 overlaps the device compute of bucket n. The stack is padded
     where the masks are (``batching.pad_stack_device``), and the engine's
     ingest copies it onto the device where it is not there. Completion
     waits on the result's CUDA event, fans
     per-request cropped results out to futures, and records true
     submit->ready latency — cache hits are counted separately and never
     enter the latency window.

The scheduler thread owns layers 2-3; ``submit`` only keys, checks the
cache, and enqueues, so the caller's thread never blocks on the
dispatcher's device work (unless backpressure deliberately blocks it at
``max_queue_depth``).

``Engine.put`` gives the tensor a request carries and its key's content
digest (``service.cache``): on a CUDA engine without a mesh a copy on the
card made by the submitting thread, staged through its page-locked slot,
and digested there; elsewhere a CPU tensor over the host array, digested
with ``hashlib``.
So on a CUDA engine a backlog lives in device memory: one copy of the mask
for each request from its submit until its batch's result is ready, for
those admitted and for the producers parked at the admission gate alike.
``max_queue_depth`` (or ``bucket_queue_depth``) bounds the admitted ones,
the callers' threads the rest (one a thread); with neither bound the
device memory grows with the queue (docs/traffic.md).

Spans cut each host stage at its edges (docs/observability.md): the probe
into ``cache.key_copy`` (to the end of ``put``'s copy; its ``pinned`` meta
says 1 where it was staged, else 0, and its ``copy`` meta is ``put``'s) and
``cache.key_hash`` (its ``where`` meta says ``device`` or ``host``), the
flush into ``scheduler.pad_stack`` and ``scheduler.h2d``, the launch being
the rest.
The copies into fresh memory carry their thread's minor page faults as
``minflt``. A request that arrives at an empty service (no submit in
progress, no leader) carries ``service.idle`` from the moment it emptied.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine import Engine, YCHGResult
from repro_torch.engine.ops import (
    PIPELINE_SEP,
    pipeline_op_key,
    split_pipeline_key,
    validate_pipeline,
)
from repro_torch.obs import NULL_TRACE, maybe_trace, minor_faults
from repro_torch.service.batching import (
    Bucket,
    crop_for,
    pad_stack_device,
    pick_bucket_side,
)
from repro_torch.service.cache import CacheKey, ResultCache, make_key
from repro_torch.service.metrics import MetricsRecorder, ServiceMetrics
from repro_torch.service.scheduler import (
    Scheduler,
    SchedulerConfig,
    ServiceOverloaded,
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Frozen service policy knobs.

    bucket_sides      ascending ladder of square bucket sides; a mask maps
                      to the smallest side holding it and anything past the
                      top is rejected, so compiled shapes stay bounded.
    max_batch         bucket flush size; a flush is padded (blank images)
                      to the smallest power-of-two sub-batch >= its
                      occupancy, capped here — pad compute scales with
                      traffic while compiled shapes stay bounded at
                      ``len(bucket_sides) * (log2(max_batch) + 1)`` per
                      dtype seen.
    max_delay_ms      micro-batching window: the longest a queued request
                      waits for batch-mates before a partial flush.
    cache_entries     LRU capacity (0 disables caching).
    inflight_buckets  bucket computations kept outstanding after a flush
                      (2 = classic double buffering: ingest n+1 overlaps
                      compute n). A flush dispatches before trimming, so
                      one extra job is briefly in flight while the oldest
                      retires.
    latency_window    number of recent latencies kept for p50/p95.
    max_queue_depth   admission bound on accepted-but-unfinished requests;
                      None disables the global bound.
    bucket_queue_depth  the same admission bound applied PER BUCKET (None
                      = off): a flood of one resolution sheds/blocks
                      against its own allowance while every other bucket
                      keeps admitting — the global bound alone is
                      bucket-blind and sheds minority traffic with the
                      flood. Per-bucket shed counts are in
                      ``ServiceMetrics.shed_by_bucket``.
    fair              serve ready buckets deficit-round-robin (True, the
                      default) instead of strictly in arrival order
                      (False) — a hot bucket's backlog dispatches one
                      batch per round, interleaved with other buckets.
    overload_policy   at the bound, ``submit`` either blocks until a slot
                      frees ("block", backpressure) or raises
                      :class:`ServiceOverloaded` ("shed", fail fast).
                      Cache hits and coalesces onto an admitted leader
                      consume no queue slot and are never rejected; a
                      duplicate that joins a leader still waiting at the
                      admission gate shares the leader's fate — if that
                      leader is shed, the duplicate's future fails with
                      the same ServiceOverloaded.
    sub_batches       pad flushes to the power-of-two ladder (True) or
                      always to ``max_batch`` (False; kept so benchmarks
                      can compare the two policies on one schedule).
    op_bucket_sides   per-op overrides of ``bucket_sides``: a mapping (or
                      sorted pair tuple) ``op key -> ladder``. An op (or
                      exact pipeline key like "denoise+ychg") without an
                      entry uses the default ladder. Canonicalised to a
                      sorted tuple of pairs so two configs with the same
                      content always compare equal.
    op_max_batch      per-op overrides of ``max_batch``, same key rules;
                      drives both the flush size and that op's DRR
                      quantum, so a small-batch op earns proportionally
                      small rounds.
    classes           traffic classes in strict priority order, highest
                      first; ``submit(..., klass=...)`` selects one.
                      Strict priority across classes, DRR within
                      (docs/traffic.md).
    default_class     the class of a request submitted without ``klass``.
    tenant_rate       per-tenant token-bucket refill (requests/s);
                      0.0 disables tenant quotas.
    tenant_burst      per-tenant banked-token cap; 0.0 means
                      ``max(1, tenant_rate)``.
    """

    bucket_sides: Tuple[int, ...] = (128, 256, 512, 1024)
    max_batch: int = 8
    max_delay_ms: float = 2.0
    cache_entries: int = 1024
    inflight_buckets: int = 2
    latency_window: int = 4096
    max_queue_depth: Optional[int] = None
    bucket_queue_depth: Optional[int] = None
    overload_policy: str = "block"
    sub_batches: bool = True
    fair: bool = True
    op_bucket_sides: Any = ()
    op_max_batch: Any = ()
    classes: Tuple[str, ...] = ("interactive", "standard", "batch")
    default_class: str = "standard"
    tenant_rate: float = 0.0
    tenant_burst: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "classes", tuple(self.classes))
        self._check_ladder(self.bucket_sides)
        object.__setattr__(self, "op_bucket_sides", tuple(
            sorted((str(op), tuple(sides))
                   for op, sides in dict(self.op_bucket_sides).items())))
        object.__setattr__(self, "op_max_batch", tuple(
            sorted((str(op), int(mb))
                   for op, mb in dict(self.op_max_batch).items())))
        for op, sides in self.op_bucket_sides:
            self._check_ladder(sides, f"op_bucket_sides[{op!r}]")
        for op, mb in self.op_max_batch:
            if mb < 1:
                raise ValueError(
                    f"op_max_batch[{op!r}] must be >= 1, got {mb}")
        if self.inflight_buckets < 1:
            raise ValueError(
                f"inflight_buckets must be >= 1, got {self.inflight_buckets}")
        # the remaining knobs share their names with SchedulerConfig, so
        # constructing it here surfaces bad values at ServiceConfig() time
        # with messages that name the right knob
        self.scheduler_config()

    @staticmethod
    def _check_ladder(sides, name: str = "bucket_sides") -> None:
        if not sides or list(sides) != sorted(set(sides)):
            raise ValueError(
                f"{name} must be a non-empty ascending ladder, got {sides}")

    def bucket_sides_for(self, op_key: str) -> Tuple[int, ...]:
        """The bucket ladder for an op (or exact pipeline key)."""
        return dict(self.op_bucket_sides).get(op_key, self.bucket_sides)

    def max_batch_for(self, op_key: str) -> int:
        """The flush size (and DRR quantum) for an op key."""
        return dict(self.op_max_batch).get(op_key, self.max_batch)

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            max_batch=self.max_batch,
            max_delay_ms=self.max_delay_ms,
            inflight_jobs=self.inflight_buckets,
            max_queue_depth=self.max_queue_depth,
            bucket_queue_depth=self.bucket_queue_depth,
            overload_policy=self.overload_policy,
            sub_batches=self.sub_batches,
            fair=self.fair,
            classes=self.classes,
            default_class=self.default_class,
            tenant_rate=self.tenant_rate,
            tenant_burst=self.tenant_burst,
        )


@dataclasses.dataclass
class _Request:
    # the mask as Engine.put gave it, native shape. The flush pads from it
    # on the dispatcher's stream; it is let go once the batch's result is
    # ready (or that stream has drained, on a failure), so that a device
    # block, allocated on the submitter's stream, is never handed out again
    # while the pad may still read it
    mask: Optional[torch.Tensor]
    key: CacheKey
    bucket: Bucket
    t_submit: float
    futures: List[Future]     # leader's future + any coalesced duplicates
    trace: Any = NULL_TRACE   # request trace the stage spans land in
    own_trace: bool = False   # True: the service created it and finishes it
    # stage-edge timestamps (monotonic). t_gate is stamped by the submitter
    # just before the admission gate; t_admitted just after submit returns
    # (the scheduler thread may dispatch before that write lands, so
    # consumers fall back t_admitted -> t_gate -> t_submit); t_dispatch is
    # stamped by the scheduler thread when the batch is issued.
    t_gate: float = 0.0
    t_admitted: float = 0.0
    t_dispatch: float = 0.0
    # traffic shaping (docs/traffic.md): the scheduler reads these three
    # at admission. None klass means config.default_class; none of them
    # ever enters the cache key, the bucket, or the payload — identical
    # masks are one cache entry whatever class/tenant asked
    klass: Optional[str] = None
    deadline_ms: Optional[float] = None
    tenant: Optional[str] = None


class YCHGService:
    """Single-mask request front end over a shared op-dispatching
    :class:`Engine`.

    ``submit(mask)`` returns a ``concurrent.futures.Future`` resolving to
    the B=1 device-resident ``YCHGResult`` that ``engine.analyze(mask)``
    would produce — bit-identical, including through bucket padding and
    result caching. ``analyze(mask)`` is the blocking convenience form;
    ``submit(mask, op="ccl")`` serves another op, and
    ``submit_pipeline(mask, ["denoise", "ychg"])`` an op chain.
    Use as a context manager, or call ``close()`` to drain and stop.
    ``YCHGService()`` builds the default engine, which runs on the card.

    Pass ``cache`` to share one :class:`ResultCache` between services;
    keys include each engine's resolved backend, config, and the op key,
    so sharing is always safe (policies never serve each other's entries,
    and neither do different ops on the same mask).
    """

    def __init__(self, engine: Optional[Engine] = None,
                 config: ServiceConfig = ServiceConfig(), *,
                 cache: Optional[ResultCache] = None):
        self.engine = engine if engine is not None else Engine()
        self.config = config
        self.cache = cache if cache is not None else ResultCache(
            config.cache_entries)
        self._recorder = MetricsRecorder(config.latency_window)
        self._leaders: Dict[CacheKey, _Request] = {}
        self._lock = threading.Lock()
        self._closed = False
        # submits between their probe's start and their leader's
        # registration (or their return), and when the service last held
        # no request at all (None while it holds one): under _lock
        self._submitting = 0
        self._idle_since: Optional[float] = time.monotonic()
        self._scene_progress: Optional[Any] = None
        self._scheduler = Scheduler(
            config.scheduler_config(),
            dispatch=self._dispatch,
            complete=self._complete,
            fail=self._fail,
            max_batch_for=lambda bucket: config.max_batch_for(bucket[0]),
        )

    # ------------------------------------------------------------ requests

    def submit(self, mask: Any, *, op: Optional[str] = None,
               trace: Optional[Any] = None, klass: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> "Future[YCHGResult]":
        """Enqueue one (H, W) mask; the future resolves to a ready result.

        ``op`` selects the operator (default: the engine's own, normally
        ``"ychg"``); the future resolves to that op's B=1 device-resident
        result pytree. Raises :class:`ServiceOverloaded` when the queue is
        at ``max_queue_depth`` under ``overload_policy="shed"``; blocks
        here (not on device work) under ``"block"``.

        Traffic shaping (docs/traffic.md): ``klass`` picks a priority
        class from ``config.classes`` (default ``config.default_class``;
        unknown classes raise ``ValueError``); ``deadline_ms`` is a
        completion budget — admission sheds with
        :class:`repro_torch.service.scheduler.DeadlineExceeded` when the
        predicted queue delay already exceeds it; ``tenant`` is the quota
        identity — an over-quota tenant sheds with
        :class:`repro_torch.service.scheduler.TenantQuotaExceeded`. All three
        ride OUTSIDE the cache key and payload, so results stay
        bit-identical whatever class asked, and a cache hit or a
        coalesce onto an in-flight leader is served without consuming
        quota or deadline checks (a hit costs ~nothing to serve; only
        admission to compute is shaped).

        ``trace`` joins this request's stage spans to an existing
        :class:`repro_torch.obs.Trace` (a caller that opened one stays
        responsible for finishing it). Without one, the service opens its own trace and
        finishes it when the request resolves.
        """
        op_key = op if op is not None else self.engine.op
        if PIPELINE_SEP in op_key:
            raise ValueError(
                f"op {op_key!r} looks like a pipeline spec; use "
                f"submit_pipeline for ordered op chains")
        backend = self.engine.resolve_backend(op=op_key)
        return self._submit_keyed(mask, op_key, backend, trace,
                                  klass=klass, deadline_ms=deadline_ms,
                                  tenant=tenant)

    def submit_pipeline(self, mask: Any, stages, *,
                        trace: Optional[Any] = None,
                        klass: Optional[str] = None,
                        deadline_ms: Optional[float] = None,
                        tenant: Optional[str] = None) -> "Future":
        """Enqueue one mask through an ordered op chain, on the device.

        ``stages`` is a sequence of op names, e.g. ``["denoise", "ychg"]``;
        every stage but the last must be chainable (its result has an
        image-shaped field the next stage ingests). The future resolves to
        the LAST stage's B=1 result, bit-identical to submitting each
        stage separately and feeding the cropped output forward: the
        pipeline just never leaves the device between stages. Cache
        entries are keyed by the full ``"+"``-joined pipeline key, so a
        pipeline never aliases its prefix ops.
        """
        stages = validate_pipeline(stages)
        op_key = pipeline_op_key(stages)
        backend = PIPELINE_SEP.join(
            self.engine.resolve_backend(op=s) for s in stages)
        return self._submit_keyed(mask, op_key, backend, trace,
                                  klass=klass, deadline_ms=deadline_ms,
                                  tenant=tenant)

    def _submit_keyed(self, mask: Any, op_key: str, backend: str,
                      trace: Optional[Any], *,
                      klass: Optional[str] = None,
                      deadline_ms: Optional[float] = None,
                      tenant: Optional[str] = None) -> "Future":
        if klass is not None and klass not in self.config.classes:
            raise ValueError(
                f"unknown traffic class {klass!r} "
                f"(classes: {self.config.classes!r})")
        if self._closed:
            raise RuntimeError("service is closed")
        tr = trace if trace is not None else maybe_trace()
        own = trace is None
        live = tr.enabled
        t_probe0 = time.monotonic()
        with self._lock:
            self._submitting += 1
            idle0, self._idle_since = self._idle_since, None
        # the mask as put on the card (or the host): every raise below lets
        # it go first, since a raised exception's traceback keeps this
        # frame, and so its locals, for as long as the caller keeps it
        x = None
        try:
            f0 = minor_faults() if live else 0
            a = np.ascontiguousarray(np.asarray(mask))
            if a.ndim != 2:
                raise ValueError(
                    f"submit expects an (H, W) mask, got {a.shape}")
            side = pick_bucket_side(a.shape,
                                    self.config.bucket_sides_for(op_key))
            bucket = (op_key, side, str(a.dtype))
            edge: Dict[str, Any] = {}

            def on_stage(name: str, s0: float, s1: float) -> None:
                edge[name] = s1
                if live and name == "copy":
                    edge["minflt"] = minor_faults() - f0

            x, digest, copy = self.engine.put(a, on_stage=on_stage)
            t_copy, t_hash = edge["copy"], edge["digest"]
            key = make_key(a, backend, self.engine.config,
                           self.engine.mesh, op=op_key, digest=digest)
        except BaseException:
            x = None
            with self._lock:
                self._submitting -= 1
                self._note_if_empty()
            raise
        self._recorder.record_key(copy)
        fut: "Future[YCHGResult]" = Future()
        cached = None
        outcome = "miss"
        # cache check, coalesce, and leader registration are ONE critical
        # section, shared with the completion side's cache.put + leader
        # retirement: a duplicate always sees the leader or the cached
        # result, never the gap between them
        with self._lock:
            self._submitting -= 1
            if self._closed:
                self._note_if_empty()
                x = None
                raise RuntimeError("service is closed")
            cached = self.cache.get(key)
            if cached is not None:
                self._recorder.record_submit()
                self._recorder.record_cache_hit(a.size)
                outcome = "hit"
            else:
                leader = self._leaders.get(key)
                if leader is not None:
                    leader.futures.append(fut)
                    self._recorder.record_submit()
                    self._recorder.record_coalesced()
                    outcome = "coalesced"
                else:
                    req = _Request(mask=x, key=key, bucket=bucket,
                                   t_submit=time.monotonic(), futures=[fut],
                                   trace=tr, own_trace=own, klass=klass,
                                   deadline_ms=deadline_ms, tenant=tenant)
                    self._leaders[key] = req
            self._note_if_empty()
        t_probe1 = time.monotonic()
        self._recorder.observe_stage("cache_probe", bucket,
                                     t_probe1 - t_probe0)
        self._recorder.observe_stage("key_copy", bucket, t_copy - t_probe0)
        self._recorder.observe_stage("key_hash", bucket, t_hash - t_copy)
        if idle0 is not None:
            tr.add("service.idle", idle0, t_probe0)
        tr.add("cache.probe", t_probe0, t_probe1, outcome=outcome)
        if live:
            tr.add("cache.key_copy", t_probe0, t_copy, minflt=edge["minflt"],
                   pinned=int(copy == "staged"), copy=copy)
        tr.add("cache.key_hash", t_copy, t_hash,
               where="host" if copy == "none" else "device")
        if outcome == "hit":
            fut.set_result(cached)
            if own:
                tr.finish()
            return fut
        if outcome == "coalesced":
            # the rider's spans end here; the leader's trace carries the
            # compute stages for the shared result
            if own:
                tr.finish()
            return fut
        # peer probe OUTSIDE the lock (it is a blocking network call in a
        # fleet): the leader is already registered, so duplicates arriving
        # mid-probe coalesce onto it and share the peered result below.
        # Base caches answer None and cost nothing.
        t_peer0 = time.monotonic()
        peered = self.cache.peer_probe(key)
        t_peer1 = time.monotonic()
        if hasattr(self.cache, "set_peers"):
            # only peer-capable caches get a peer_probe stage sample: the
            # base ResultCache answers None in ~0 time and a flood of those
            # samples would bury the real probe distribution
            self._recorder.observe_stage("peer_probe", bucket,
                                         t_peer1 - t_peer0)
            tr.add("cache.peer_probe", t_peer0, t_peer1,
                   outcome="hit" if peered is not None else "miss")
        if peered is not None:
            with self._lock:
                self.cache.put(key, peered)
                self._leaders.pop(key, None)
                self._note_if_empty()
            # the leader + every rider that joined during the probe: all
            # served without consuming an admission slot (same rule as a
            # local cache hit); riders recorded their submits when they
            # coalesced, so completions are recorded per future
            self._recorder.record_submit()
            for f in req.futures:
                self._recorder.record_cache_hit(a.size)
                _fulfil(f, peered)
            if own:
                tr.finish()
            return fut
        # admission happens OUTSIDE the service lock: a blocked submitter
        # must not hold the lock the completion path needs to free a slot.
        # The leader is registered first so duplicates coalesce (for free)
        # even while their leader waits at the admission gate.
        req.t_gate = time.monotonic()
        try:
            self._scheduler.submit(req)
        except BaseException as e:
            x = req.mask = None
            with self._lock:
                self._leaders.pop(key, None)
                self._note_if_empty()
            # once the leader is popped no more riders can join, so
            # req.futures is stable: fail fut + anyone who coalesced while
            # the leader waited at the gate, and back their submits out of
            # the counters — they were never accepted either
            if len(req.futures) > 1:
                self._recorder.record_coalesced_rejected(
                    len(req.futures) - 1)
            for f in req.futures:
                if not f.done() and f.set_running_or_notify_cancel():
                    f.set_exception(e)
            tr.add("scheduler.admission", req.t_gate, time.monotonic(),
                   outcome=type(e).__name__)
            if own:
                tr.finish()
            raise
        req.t_admitted = time.monotonic()
        self._recorder.observe_stage("admission", bucket,
                                     req.t_admitted - req.t_gate)
        tr.add("scheduler.admission", req.t_gate, req.t_admitted)
        # counted only once actually admitted: a shed submit is not
        # "accepted", so submitted - completed tracks real outstanding work
        self._recorder.record_submit()
        return fut

    def _note_if_empty(self) -> None:
        """Under ``_lock``: stamp the moment the service came to hold no
        request (no submit in progress, no leader), which the next
        submit's ``service.idle`` span starts from."""
        if (not self._submitting and not self._leaders
                and self._idle_since is None):
            self._idle_since = time.monotonic()

    def analyze(self, mask: Any, timeout: Optional[float] = None, *,
                op: Optional[str] = None) -> YCHGResult:
        """Blocking convenience: ``submit(mask, op=op).result(timeout)``."""
        return self.submit(mask, op=op).result(timeout)

    def pipeline(self, mask: Any, stages,
                 timeout: Optional[float] = None):
        """Blocking convenience: ``submit_pipeline(...).result(timeout)``."""
        return self.submit_pipeline(mask, stages).result(timeout)

    def attach_scene_progress(self, progress: Any) -> None:
        """Publish a scene/bulk job's progress through ``metrics()``.

        ``progress`` is duck-typed (so this layer never imports
        ``repro_torch.scene``): anything whose ``snapshot()`` exposes
        ``tiles_done`` / ``tiles_total`` / ``resumes`` / ``stitch_time_s``
        — in practice a :class:`repro_torch.scene.SceneProgress`. Pass
        ``None`` to detach.
        """
        self._scene_progress = progress

    def metrics(self) -> ServiceMetrics:
        scene = (self._scene_progress.snapshot()
                 if self._scene_progress is not None else None)
        return self._recorder.snapshot(
            queue_depth=self._scheduler.backlog(),
            cache_hits=self.cache.hits,
            cache_misses=self.cache.misses,
            peer_hits=self.cache.peer_hits,
            peer_misses=self.cache.peer_misses,
            shed=self._scheduler.shed,
            blocked=self._scheduler.blocked,
            shed_by_bucket=tuple(
                sorted(self._scheduler.shed_by_bucket.items())),
            shed_by_class=tuple(
                sorted(self._scheduler.shed_by_class.items())),
            shed_by_tenant=tuple(
                sorted(self._scheduler.shed_by_tenant.items())),
            shed_deadline=self._scheduler.shed_deadline,
            shed_quota=self._scheduler.shed_quota,
            backend=self.engine.resolve_backend(),
            scene_tiles_done=scene.tiles_done if scene else 0,
            scene_tiles_total=scene.tiles_total if scene else 0,
            scene_resumes=scene.resumes if scene else 0,
            scene_stitch_time_s=scene.stitch_time_s if scene else 0.0,
        )

    # ----------------------------------------------------------- lifecycle

    def close(self, timeout: float = 60.0) -> None:
        """Drain queued work, stop the scheduler. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._scheduler.close(timeout)

    def __enter__(self) -> "YCHGService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------- scheduler callbacks

    def _dispatch(self, bucket: Bucket, requests: List[_Request],
                  batch_size: int) -> YCHGResult:
        t0 = time.monotonic()
        op_key, side, _ = bucket
        for r in requests:
            # queue wait: admitted -> this flush started assembling. The
            # submitter's t_admitted write may not have landed yet (the
            # scheduler can flush before submit() returns), so fall back
            # through the race-free stamps
            start = r.t_admitted or r.t_gate or r.t_submit
            klass = r.klass or self.config.default_class
            self._recorder.observe_stage("queue_wait", bucket,
                                         max(0.0, t0 - start), klass=klass)
            # class/tenant ride the queue-wait span as metadata: the wait
            # is the one number traffic shaping changes per class
            meta = {"klass": klass}
            if r.tenant is not None:
                meta["tenant"] = r.tenant
            r.trace.add("scheduler.queue_wait", start, t0, **meta)
        live = any(r.trace.enabled for r in requests)
        p0 = time.monotonic()
        f0 = minor_faults() if live else 0
        # where the masks are (on the card: on this thread's stream)
        stack = pad_stack_device([r.mask for r in requests], side, batch_size)
        p1 = time.monotonic()
        pad_meta = {"minflt": minor_faults() - f0} if live else {}
        self._recorder.observe_stage("pad_stack", bucket, p1 - p0)
        for r in requests:
            r.trace.add("scheduler.pad_stack", p0, p1, **pad_meta)

        def _stage_span(name: str, s0: float, s1: float) -> None:
            # the engine's copy of the host stack onto the device (its
            # "ingest"; the previous bucket's computation may still be in
            # flight), then for a pipeline one ``pipeline.<op>`` a stage:
            # a span on every rider's trace and a stage histogram sample
            if name == "ingest":
                stage, span = "h2d", "scheduler.h2d"
            else:
                stage = span = f"pipeline.{name}"
            self._recorder.observe_stage(stage, bucket, max(0.0, s1 - s0))
            for r in requests:
                r.trace.add(span, s0, s1)

        if PIPELINE_SEP in op_key:
            # per-request native (h, w) so each stage's output is re-zeroed
            # outside the request's canvas: exactly what a fresh pad of the
            # cropped intermediate would look like, which is what makes
            # pipeline == sequential bit-exact. Blank pad rows get (0, 0).
            hw = np.zeros((batch_size, 2), np.int32)
            for i, r in enumerate(requests):
                hw[i] = r.mask.shape
            result = self.engine.run_pipeline(
                stack, split_pipeline_key(op_key), valid_hw=hw,
                on_stage=_stage_span)
        else:
            result = self.engine.analyze_batch(  # async launch
                stack, op=op_key, on_stage=_stage_span)
        t1 = time.monotonic()
        self._recorder.observe_stage("flush", bucket, t1 - t0)
        for r in requests:
            r.t_dispatch = t1
            r.trace.add("scheduler.flush", t0, t1,
                        batch=batch_size, occupancy=len(requests))
        self._recorder.record_batch(
            tuple(stack.shape), sum(r.mask.numel() for r in requests))
        return result

    def _complete(self, result: YCHGResult, requests: List[_Request]) -> None:
        # any escape here would fail the whole slice via the scheduler's
        # retire guard, so the fan-out routes its own failures to _fail —
        # which skips already-fulfilled futures, so a partial fan-out fails
        # only the requests it missed
        try:
            result.block_until_ready()  # waits on the result's CUDA event
            shapes = [req.mask.shape for req in requests]
            for req in requests:   # the pad that read them came before it
                req.mask = None
            now = time.monotonic()
            if requests:
                t_disp = requests[0].t_dispatch or now
                self._recorder.observe_stage(
                    "compute", requests[0].bucket, max(0.0, now - t_disp))
            crop = crop_for(requests[0].bucket[0]) if requests else None
            for row, req in enumerate(requests):
                tc0 = time.monotonic()
                out = crop(result, row, shapes[row])
                # atomic with submit's cache-check/coalesce: insert before
                # retiring the leader, so a duplicate in this instant hits
                # the cache instead of re-dispatching the computation
                with self._lock:
                    self.cache.put(req.key, out)
                    self._leaders.pop(req.key, None)
                    self._note_if_empty()
                tc1 = time.monotonic()
                self._recorder.observe_stage("crop", req.bucket, tc1 - tc0)
                self._recorder.record_complete(
                    now - req.t_submit, shapes[row].numel(), len(req.futures),
                    bucket=req.bucket)
                # spans go on BEFORE the futures resolve: a waiter that
                # owns this trace finishes it the moment its future fires
                tr = req.trace
                tr.add("engine.compute", req.t_dispatch or now, now,
                       rows=len(requests))
                tr.add("engine.crop", tc0, tc1, row=row)
                for fut in req.futures:
                    _fulfil(fut, out)
                if req.own_trace:
                    tr.finish()
        except Exception as e:
            self._fail(requests, e)

    def _fail(self, requests: List[_Request], exc: Exception) -> None:
        held = [r.mask for r in requests if r.mask is not None]
        if held and self.engine.puts_on_card:
            # a failed flush may have left the pad's reads of them queued on
            # this thread's stream: let it drain before they go
            torch.cuda.current_stream(held[0].device).synchronize()
        for r in requests:
            r.mask = None
        now = time.monotonic()
        for req in requests:
            with self._lock:
                self._leaders.pop(req.key, None)
                self._note_if_empty()
            # span before the futures fire, same as _complete: a waiter
            # that owns this trace finishes it as soon as it unblocks
            req.trace.add("service.fail", now, now,
                          error=type(exc).__name__)
            for fut in req.futures:
                if not fut.done() and fut.set_running_or_notify_cancel():
                    fut.set_exception(exc)
            if req.own_trace:
                req.trace.finish()


def _fulfil(fut: Future, value: Any) -> None:
    """Resolve a future the client may have cancelled in the meantime.

    ``submit`` hands out plain ``Future``s that are never marked running,
    so a client-side ``cancel()`` always succeeds; an unguarded
    ``set_result`` would then raise ``InvalidStateError`` inside the
    scheduler thread and kill it — hanging every other outstanding request.
    """
    if fut.set_running_or_notify_cancel():
        fut.set_result(value)


# the canonical name for the multi-op service; YCHGService remains the
# historical (and still accurate: yCHG-first) spelling of the same class
Service = YCHGService

# re-exported here so service-level callers see the error next to the knob
# that produces it
__all__ = ["Service", "ServiceConfig", "ServiceOverloaded", "YCHGService"]
