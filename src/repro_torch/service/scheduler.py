"""The service's dispatch scheduler, extracted and engine-free.

One :class:`Scheduler` thread owns the whole path between "a request was
admitted" and "its job retired": per-bucket pending queues, age/size flush,
the bounded in-flight window, and admission control. It knows nothing about
masks, engines, caches, or futures — callers hand it request objects (any
object with ``.bucket`` and ``.t_submit``) plus three callbacks:

  dispatch(bucket, requests, batch_size) -> handle
      start the batch computation (asynchronously if possible) and return
      an opaque job handle; raising fails exactly those requests;
  complete(handle, requests)
      block until the job is ready and fan results out; called on the
      scheduler thread, never with the scheduler's lock held;
  fail(requests, exc)
      route an error to every request in the slice.

which is what makes the policy logic unit-testable with a fake dispatch
function (`tests/test_scheduler.py`) — no device, no engine, no cache.

Two policies live here:

**Batch-size sub-buckets.** A flush is padded to the smallest power of two
>= its occupancy, capped at ``max_batch`` (:func:`pick_sub_batch`), instead
of always to ``max_batch``: a lone request at low traffic no longer pays
for ``max_batch - 1`` blank images (~8x less pad compute at B=1 with the
default ladder), while compiled shapes stay bounded — the batch dimension
only ever takes the :func:`sub_batch_ladder` values, so the shape budget is
``len(bucket_sides) * (log2(max_batch) + 1)`` per dtype.

**Admission control.** ``max_queue_depth`` bounds admitted-but-unretired
requests. At the bound, ``submit`` either blocks until a retirement frees a
slot (``overload_policy="block"``: backpressure, the producer slows to the
service's pace) or raises :class:`ServiceOverloaded` immediately
(``"shed"``: fail fast, the producer handles the rejection). Shed and
blocked counts are exposed for the service's metrics.

**Per-bucket fairness.** A single global bound is bucket-blind: a flood of
one hot bucket fills the queue and the bound sheds *everyone*, including
the trickle of another bucket that the service could easily serve. Two
mechanisms fix that:

  * ``bucket_queue_depth`` bounds admitted-but-unretired requests *per
    bucket*, with per-bucket shed counters — a flooded bucket sheds
    against its own bound while every other bucket admits freely;
  * ``fair=True`` (the default) serves ready buckets **deficit round
    robin**: the ingest drain banks arrivals first, then each active
    bucket is visited in turn with a quantum of ``max_batch`` request
    credits per round, flushing while its deficit covers the next flush's
    occupancy. A hot bucket with a deep backlog dispatches one batch per
    round, interleaved with everyone else, instead of flushing its whole
    backlog in arrival order ahead of an aged minority request. Banked
    deficit is capped at one quantum beyond the largest flush, so credit
    accrued across rounds can never pay for a peer-starving mega-burst.
    ``fair=False`` keeps the legacy arrival-order flushes so benchmarks
    can measure exactly what fairness buys (``benchmarks/bench_frontend``).

**Traffic classes.** Real traffic is not one crowd: an interactive caller
and an overnight backfill should not compete as equals. ``classes`` names
the priority classes in strict order (first = highest); a request opts in
with a ``.klass`` attribute (default ``default_class``). Scheduling is
**strict priority across classes, DRR within a class**: the dispatch flows
are ``(class, bucket)`` pairs, and ``_serve_ready`` only serves the
highest class that has a ready flow — a lower class dispatches exactly
when no higher class could. Within one class the per-bucket DRR above is
unchanged, so the per-bucket fairness above composes instead of being
replaced. Admission bounds stay class-blind (depth is depth), but every
shed is attributed to its class for the metrics.

**Deadlines.** A request may carry ``.deadline_ms`` — a completion budget,
not a hint. At admission the scheduler predicts this request's completion
delay from the :class:`DrainRate` estimator (the same rolling
completions-per-second window behind the frontend's 429 ``Retry-After``)
as ``(depth + 1) / rate`` and shes with the typed
:class:`DeadlineExceeded` — carrying an honest ``retry_after_s`` — when
the prediction already exceeds the budget. Work that is already dead is
never enqueued; the queue never carries a corpse. A cold estimator (no
completions observed yet) admits: shedding needs evidence.

**Tenant quotas.** A request may carry ``.tenant`` — an identity string.
With ``tenant_rate > 0``, each tenant draws from its own
:class:`TokenBucket` (``tenant_rate`` tokens/s, ``tenant_burst`` burst);
an empty bucket sheds with :class:`TenantQuotaExceeded` and the exact
time until the next token as ``retry_after_s``. Quota and deadline sheds
are **always** sheds, even under ``overload_policy="block"`` — parking a
request that is over quota (or already dead) would grant it the very
capacity the policy denies it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Hashable, List, Optional, Tuple

from repro_torch.obs import auto_dump


class ServiceOverloaded(RuntimeError):
    """Submit rejected: the queue is at ``max_queue_depth`` under
    ``overload_policy="shed"``. Typed so producers can catch exactly the
    overload case (retry later, degrade, load-shed upstream) without
    swallowing real errors."""


class DeadlineExceeded(ServiceOverloaded):
    """Submit shed at admission: the drain-rate estimator predicts this
    request would complete after its ``deadline_ms`` budget, so enqueueing
    it would only burn capacity on work that is already dead. Subclasses
    :class:`ServiceOverloaded` so every existing 429 mapping applies;
    ``retry_after_s`` is the honest wait for the backlog the prediction
    blamed."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class TenantQuotaExceeded(ServiceOverloaded):
    """Submit shed at admission: the request's tenant token bucket is
    empty. ``retry_after_s`` is the exact time until the bucket refills
    one token at ``tenant_rate`` — not an estimate."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DrainRate:
    """Rolling completions-per-second estimator with injectable clocks.

    The scheduler feeds it one sample per retirement
    (``observe(completed_total)``); ``rate()`` is the slope across the
    window, ``None`` until two samples with forward progress exist — a
    cold estimator must never justify a shed. Tests pass explicit ``now``
    values so the arithmetic is pinned with synthetic timestamps, never
    wall clocks (the tests/README.md timing policy)."""

    def __init__(self, window: int = 32):
        self._samples: "Deque[Tuple[float, int]]" = deque(maxlen=window)

    def observe(self, completed_total: int,
                now: Optional[float] = None) -> None:
        self._samples.append(
            (time.monotonic() if now is None else now, completed_total))

    def rate(self) -> Optional[float]:
        if len(self._samples) < 2:
            return None
        t0, c0 = self._samples[0]
        t1, c1 = self._samples[-1]
        if t1 <= t0 or c1 <= c0:
            return None
        return (c1 - c0) / (t1 - t0)


class TokenBucket:
    """Per-tenant rate limiter: ``rate`` tokens/s up to ``burst`` banked.

    ``take(now)`` refills by elapsed time, then either spends one token
    (returns ``0.0``: admitted) or returns the seconds until one token
    exists (shed, and the honest ``Retry-After``). The clock is an
    argument, not ``time.monotonic()``, so the refill algebra is testable
    with exact synthetic timestamps."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = rate
        self.burst = burst
        self._tokens = burst
        self._last: Optional[float] = None

    def take(self, now: float) -> float:
        if self._last is not None:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return 0.0
        return (1.0 - self._tokens) / self.rate


def _clamp_retry(seconds: float) -> float:
    """An honest but bounded Retry-After: never 0 (a tight retry loop),
    never absurd (same clamp as the frontend's 429 estimator)."""
    return min(30.0, max(0.05, seconds))


def pick_sub_batch(occupancy: int, max_batch: int) -> int:
    """Batch size for a flush: smallest power of two >= ``occupancy``,
    capped at ``max_batch`` (so a non-power-of-two ``max_batch`` is itself
    the top rung)."""
    if occupancy < 1:
        raise ValueError(f"occupancy must be >= 1, got {occupancy}")
    b = 1
    while b < occupancy:
        b *= 2
    return min(b, max_batch)


def sub_batch_ladder(max_batch: int) -> Tuple[int, ...]:
    """Every batch size :func:`pick_sub_batch` can return: the powers of
    two below ``max_batch``, then ``max_batch`` — ``log2(max_batch) + 1``
    rungs, the per-(side, dtype) compiled-shape budget."""
    rungs: List[int] = []
    b = 1
    while b < max_batch:
        rungs.append(b)
        b *= 2
    rungs.append(max_batch)
    return tuple(rungs)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Scheduler policy knobs (the service derives this from ServiceConfig).

    max_batch        bucket flush size and the sub-batch ladder's cap.
    max_delay_ms     micro-batching window before a partial flush.
    inflight_jobs    dispatched jobs kept outstanding after a flush — N
                     means N (a >= retire bound made it behave as N-1, so
                     double buffering never overlapped two computations).
                     A flush dispatches before trimming, so N+1 jobs are
                     briefly in flight while the oldest retires: a ready
                     batch is never blocked behind an old computation.
    max_queue_depth  bound on admitted-but-unretired requests; None = no
                     global admission control.
    bucket_queue_depth  the same bound applied PER BUCKET (None = off):
                     a hot bucket sheds/blocks against its own allowance
                     while other buckets keep admitting — the fairness
                     complement to the bucket-blind global bound. Both
                     bounds may be active at once; the bucket bound is
                     checked first and attributed per bucket.
    overload_policy  what submit does at a bound: "block" (wait for a
                     slot) or "shed" (raise ServiceOverloaded).
    sub_batches      pad flushes to the power-of-two ladder (True) or
                     always to max_batch (False, the pre-ladder behaviour,
                     kept for apples-to-apples benchmarking).
    fair             serve ready buckets deficit-round-robin (True, the
                     default: one max_batch-worth of requests per bucket
                     per round) or in arrival order (False, the legacy
                     policy, kept for apples-to-apples benchmarking).
    classes          priority classes in STRICT order, highest first. A
                     request selects one with ``.klass``; dispatch flows
                     are (class, bucket) pairs — strict priority across
                     classes, DRR fairness within one. A single-class
                     config is exactly the pre-class scheduler.
    default_class    the class of a request with no ``.klass`` (must be
                     a member of ``classes``).
    tenant_rate      per-tenant token-bucket refill, requests/second;
                     0.0 disables quotas entirely.
    tenant_burst     per-tenant banked-token cap; 0.0 means
                     ``max(1, tenant_rate)``.
    """

    max_batch: int = 8
    max_delay_ms: float = 2.0
    inflight_jobs: int = 2
    max_queue_depth: Optional[int] = None
    bucket_queue_depth: Optional[int] = None
    overload_policy: str = "block"
    sub_batches: bool = True
    fair: bool = True
    classes: Tuple[str, ...] = ("interactive", "standard", "batch")
    default_class: str = "standard"
    tenant_rate: float = 0.0
    tenant_burst: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "classes", tuple(self.classes))
        if not self.classes or len(set(self.classes)) != len(self.classes):
            raise ValueError(
                f"classes must be a non-empty tuple of unique names, "
                f"got {self.classes!r}")
        if self.default_class not in self.classes:
            raise ValueError(
                f"default_class {self.default_class!r} not in "
                f"classes {self.classes!r}")
        if self.tenant_rate < 0:
            raise ValueError(
                f"tenant_rate must be >= 0, got {self.tenant_rate}")
        if self.tenant_burst < 0:
            raise ValueError(
                f"tenant_burst must be >= 0, got {self.tenant_burst}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.inflight_jobs < 1:
            raise ValueError(
                f"inflight_jobs must be >= 1, got {self.inflight_jobs}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1 or None, "
                f"got {self.max_queue_depth}")
        if self.bucket_queue_depth is not None and self.bucket_queue_depth < 1:
            raise ValueError(
                f"bucket_queue_depth must be >= 1 or None, "
                f"got {self.bucket_queue_depth}")
        if self.overload_policy not in ("block", "shed"):
            raise ValueError(
                f"overload_policy must be 'block' or 'shed', "
                f"got {self.overload_policy!r}")


@dataclasses.dataclass
class _Job:
    requests: List[Any]
    handle: Any               # whatever dispatch() returned


_SHUTDOWN = object()


class Scheduler:
    """Bucketed micro-batching dispatch loop with admission control.

    ``submit(request)`` admits (or blocks/sheds) and enqueues; one daemon
    thread drains the queue into per-bucket pending lists, flushes on size
    or age, keeps at most ``inflight_jobs`` dispatched jobs outstanding,
    and retires jobs through the ``complete`` callback. ``close()`` drains
    everything already admitted, then stops the thread.

    Pass ``autostart=False`` to enqueue before the loop runs — tests use
    this to pin exact ingest orderings without sleeps.
    """

    def __init__(self, config: SchedulerConfig,
                 dispatch: Callable[[Hashable, List[Any], int], Any],
                 complete: Callable[[Any, List[Any]], None],
                 fail: Callable[[List[Any], Exception], None],
                 *, autostart: bool = True,
                 max_batch_for: Optional[Callable[[Hashable], int]] = None):
        self.config = config
        # per-bucket flush-size override (the multi-op service derives a
        # bucket's cap from its operator); None = config.max_batch for all.
        # The DRR quantum and deficit cap follow the same per-bucket value,
        # so a small-batch op earns proportionally small rounds.
        self._max_batch_for = max_batch_for
        self._dispatch = dispatch
        self._complete = complete
        self._fail = fail
        self._q: "queue.Queue" = queue.Queue()
        # dispatch flows are (class_index, bucket) pairs: strict priority
        # across the first element, DRR across the second
        self._pending: Dict[Tuple[int, Hashable], List[Any]] = {}
        self._inflight: "Deque[_Job]" = deque()   # scheduler thread only
        # DRR state, scheduler thread only: _rr is the ring of flows with
        # pending requests (activation order), _deficit the per-flow
        # request credits banked across rounds
        self._rr: "Deque[Tuple[int, Hashable]]" = deque()
        self._deficit: Dict[Tuple[int, Hashable], int] = {}
        self._class_index = {k: i for i, k in enumerate(config.classes)}
        self._cond = threading.Condition()
        self._depth = 0       # admitted and not yet retired
        self._depth_by_bucket: Dict[Hashable, int] = {}
        self._shed = 0
        self._shed_by_bucket: Dict[Hashable, int] = {}
        self._shed_by_class: Dict[str, int] = {}
        self._shed_by_tenant: Dict[str, int] = {}
        self._shed_deadline = 0
        self._shed_quota = 0
        self._blocked = 0
        self._completed = 0   # retired requests, feeds the drain estimator
        self._drain_rate = DrainRate()
        self._tenants: Dict[str, TokenBucket] = {}
        self._closed = False
        self._started = False
        self._thread = threading.Thread(
            target=self._loop, name="ychg-scheduler", daemon=True)
        if autostart:
            self.start()

    # ------------------------------------------------------------ admission

    def submit(self, request: Any) -> None:
        """Admit and enqueue one request; called from any thread.

        At ``max_queue_depth`` (global) or ``bucket_queue_depth`` (this
        request's bucket): blocks until a retirement frees a slot (policy
        "block") or raises :class:`ServiceOverloaded` (policy "shed").
        Raises ``RuntimeError`` once closed — including for a blocked
        submitter woken by ``close()``. The blocking park happens inside
        ``Condition.wait``, which RELEASES the lock, so a parked producer
        never deadlocks a concurrent ``close()`` or the completion path
        that must take the lock to free its slot
        (``tests/test_scheduler.py::test_blocked_producers_never_deadlock_close``).
        """
        bucket = getattr(request, "bucket", None)
        klass = self.class_of(request)
        if klass not in self._class_index:
            raise ValueError(
                f"unknown traffic class {klass!r} "
                f"(classes: {self.config.classes!r})")
        tenant = getattr(request, "tenant", None)
        deadline_ms = getattr(request, "deadline_ms", None)
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            # quota and deadline are ALWAYS shed-at-admission (never
            # block): parking an over-quota or already-dead request
            # would grant it the capacity the check denies it
            if tenant is not None and self.config.tenant_rate > 0:
                wait_s = self._tenant_bucket(tenant).take(time.monotonic())
                if wait_s > 0.0:
                    self._count_shed(bucket, klass, tenant=tenant)
                    self._shed_quota += 1
                    raise TenantQuotaExceeded(
                        f"tenant {tenant!r} over quota "
                        f"(tenant_rate={self.config.tenant_rate}/s): next "
                        f"token in {wait_s:.3f}s",
                        retry_after_s=_clamp_retry(wait_s))
            if deadline_ms is not None:
                predicted_s = self.predicted_wait_s()
                dead = deadline_ms <= 0 or (
                    predicted_s is not None
                    and predicted_s * 1e3 > deadline_ms)
                if dead:
                    late_s = (predicted_s if predicted_s is not None
                              else 0.0) - max(deadline_ms, 0.0) / 1e3
                    self._count_shed(bucket, klass)
                    self._shed_deadline += 1
                    raise DeadlineExceeded(
                        f"deadline {deadline_ms}ms unmeetable: predicted "
                        f"completion delay "
                        f"{0.0 if predicted_s is None else predicted_s:.3f}s "
                        f"behind {self._depth} admitted request(s)",
                        retry_after_s=_clamp_retry(late_s))
            over = self._over_bound(bucket)
            if over is not None:
                if self.config.overload_policy == "shed":
                    self._count_shed(bucket, klass)
                    raise ServiceOverloaded(over)
                self._blocked += 1
                while (self._over_bound(bucket) is not None
                       and not self._closed):
                    self._cond.wait()
                if self._closed:
                    raise RuntimeError("scheduler is closed")
            self._depth += 1
            self._depth_by_bucket[bucket] = (
                self._depth_by_bucket.get(bucket, 0) + 1)
            # enqueue under the lock: close() also puts its sentinel under
            # the lock, so an admitted request can never land behind the
            # sentinel and silently never resolve
            self._q.put(request)

    def _over_bound(self, bucket: Hashable) -> Optional[str]:
        """The admission-rejection message, or None when a slot is free.
        Caller holds the lock. The per-bucket bound is checked first so a
        flooded bucket's rejection is attributed to ITS allowance even
        when the global bound is also at capacity."""
        bbound = self.config.bucket_queue_depth
        if bbound is not None:
            depth = self._depth_by_bucket.get(bucket, 0)
            if depth >= bbound:
                return (f"bucket {bucket!r} depth {depth} at "
                        f"bucket_queue_depth={bbound} "
                        f"(overload_policy='{self.config.overload_policy}')")
        bound = self.config.max_queue_depth
        if bound is not None and self._depth >= bound:
            return (f"queue depth {self._depth} at max_queue_depth="
                    f"{bound} (overload_policy="
                    f"'{self.config.overload_policy}')")
        return None

    def class_of(self, request: Any) -> str:
        """The request's traffic class (``default_class`` when unset)."""
        k = getattr(request, "klass", None)
        return self.config.default_class if k is None else k

    def _flow_of(self, request: Any) -> Tuple[int, Hashable]:
        """The dispatch flow a request belongs to: (class rank, bucket).
        Class validated at submit; an unknown class here (a request that
        bypassed submit) falls back to the default class rather than
        wedging the loop."""
        ci = self._class_index.get(
            self.class_of(request),
            self._class_index[self.config.default_class])
        return (ci, getattr(request, "bucket", None))

    def _tenant_bucket(self, tenant: str) -> TokenBucket:
        """This tenant's token bucket, created on first sight. Caller
        holds the lock."""
        tb = self._tenants.get(tenant)
        if tb is None:
            burst = self.config.tenant_burst or max(
                1.0, self.config.tenant_rate)
            tb = TokenBucket(self.config.tenant_rate, burst)
            self._tenants[tenant] = tb
        return tb

    def _count_shed(self, bucket: Hashable, klass: str,
                    tenant: Optional[str] = None) -> None:
        """Attribute one shed to its bucket, class, and (when the quota
        tripped) tenant. Caller holds the lock."""
        self._shed += 1
        self._shed_by_bucket[bucket] = self._shed_by_bucket.get(bucket, 0) + 1
        self._shed_by_class[klass] = self._shed_by_class.get(klass, 0) + 1
        if tenant is not None:
            self._shed_by_tenant[tenant] = (
                self._shed_by_tenant.get(tenant, 0) + 1)

    def predicted_wait_s(self) -> Optional[float]:
        """Predicted completion delay for a request admitted NOW — the
        admitted-but-unretired depth (plus this request) over the drain
        rate. ``None`` while the estimator is cold (no shed without
        evidence). Caller may hold the lock (reads one int + the
        estimator, which only the completion path mutates)."""
        rate = self._drain_rate.rate()
        if rate is None or rate <= 0:
            return None
        return (self._depth + 1) / rate

    # ------------------------------------------------------------- introspection

    @property
    def shed(self) -> int:
        """Submits rejected with ServiceOverloaded (policy "shed")."""
        with self._cond:
            return self._shed

    @property
    def shed_by_bucket(self) -> Dict[Hashable, int]:
        """Sheds attributed to the rejected request's bucket (all sheds
        carry a bucket, whichever bound tripped)."""
        with self._cond:
            return dict(self._shed_by_bucket)

    @property
    def depth_by_bucket(self) -> Dict[Hashable, int]:
        """Admitted-but-unretired requests per bucket (what
        bucket_queue_depth bounds)."""
        with self._cond:
            return dict(self._depth_by_bucket)

    @property
    def shed_by_class(self) -> Dict[str, int]:
        """Sheds attributed to the rejected request's traffic class
        (every shed carries a class, whichever check tripped)."""
        with self._cond:
            return dict(self._shed_by_class)

    @property
    def shed_by_tenant(self) -> Dict[str, int]:
        """Quota sheds attributed to the over-quota tenant."""
        with self._cond:
            return dict(self._shed_by_tenant)

    @property
    def shed_deadline(self) -> int:
        """Submits shed because the predicted delay exceeded their
        deadline (DeadlineExceeded)."""
        with self._cond:
            return self._shed_deadline

    @property
    def shed_quota(self) -> int:
        """Submits shed by a tenant token bucket (TenantQuotaExceeded)."""
        with self._cond:
            return self._shed_quota

    @property
    def completed_total(self) -> int:
        """Requests retired (completed or failed after dispatch)."""
        with self._cond:
            return self._completed

    @property
    def blocked(self) -> int:
        """Submits that had to wait for a slot (policy "block")."""
        with self._cond:
            return self._blocked

    @property
    def depth(self) -> int:
        """Admitted-but-unretired requests (what max_queue_depth bounds)."""
        with self._cond:
            return self._depth

    def backlog(self) -> int:
        """Requests waiting to be dispatched: queued + pending-in-bucket
        (excludes in-flight jobs, which are already on the device)."""
        with self._cond:
            return self._q.qsize() + sum(
                len(v) for v in self._pending.values())

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._started = True
        self._thread.start()

    def close(self, timeout: float = 60.0) -> None:
        """Drain admitted work, stop the loop, wake blocked submitters.

        If the loop thread was never started (``autostart=False``), the
        drain runs inline on the caller — an admitted request is never
        silently dropped. Once it has ended, the callbacks (the service's
        bound methods) are let go, so a dropped service needs no collector."""
        with self._cond:
            first = not self._closed
            if first:
                self._closed = True
                self._q.put(_SHUTDOWN)
            self._cond.notify_all()
            started = self._started
        if started:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return   # still draining past the timeout: it needs them
        elif first:
            self._drain()
        self._dispatch = self._complete = self._fail = None
        self._max_batch_for = None

    # --------------------------------------------------------------- the loop

    def _loop(self) -> None:
        # an unhandled escape from the dispatch loop kills the thread and
        # hangs every outstanding future — the least this process can do
        # on the way down is leave the flight recorder's evidence behind
        try:
            self._run_loop()
        except BaseException:
            auto_dump("scheduler-loop-error")
            raise

    def _run_loop(self) -> None:
        served_last = False
        while True:
            with self._cond:
                oldest = (min(rs[0].t_submit for rs in self._pending.values())
                          if self._pending else None)
            if served_last:
                # the last round flushed something, so more flows may be
                # ready NOW (full, or aged): poll the queue without
                # sleeping — this poll between rounds is what lets a
                # higher-class arrival preempt a lower class's backlog at
                # flush granularity
                timeout = 0.0
            elif oldest is not None:
                timeout = max(0.0, oldest + self._delay() - time.monotonic())
            elif self._inflight:
                timeout = 0.0   # work outstanding: poll, don't sleep
            else:
                timeout = 0.1
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                item = None
            # drain the whole backlog before any age-based flush: under a
            # burst, queued requests are older than max_delay_ms by the
            # time they are seen, and flushing per item would degenerate to
            # one batch per request exactly when batching matters most
            shutdown = False
            ingested = item is not None
            while item is not None:
                if item is _SHUTDOWN:
                    shutdown = True
                    break
                full_flow = self._enqueue_pending(item)
                # legacy (fair=False) flushes a flow the moment it fills,
                # i.e. strictly in arrival order; fair mode banks the whole
                # drain first so _serve_ready can interleave buckets
                if full_flow is not None and not self.config.fair:
                    self._flush(full_flow)
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    item = None
            if shutdown:
                break
            served = self._serve_ready()
            served_last = served > 0
            # idle: retire ONE job, then loop back to poll the queue, so a
            # request arriving mid-drain is bucketed after at most one
            # completion instead of waiting behind every outstanding job
            if (not ingested and oldest is None and not served
                    and self._inflight):
                self._retire_one()
        self._drain()

    def _delay(self) -> float:
        return self.config.max_delay_ms / 1e3

    def _max_batch(self, bucket: Hashable) -> int:
        if self._max_batch_for is None:
            return self.config.max_batch
        return self._max_batch_for(bucket)

    def _enqueue_pending(
            self, item: Any) -> Optional[Tuple[int, Hashable]]:
        """Bank one ingested request in its (class, bucket) flow
        (activating the flow in the DRR ring if new); returns the flow
        when it is now full, else None."""
        flow = self._flow_of(item)
        with self._cond:
            reqs = self._pending.get(flow)
            if reqs is None:
                self._pending[flow] = reqs = []
                if flow not in self._rr:
                    self._rr.append(flow)
            reqs.append(item)
            if len(reqs) >= self._max_batch(flow[1]):
                return flow
            return None

    def _ready_flows(self, now: float) -> List[Tuple[int, Hashable]]:
        """Flows due for a flush — full, or oldest request aged past the
        delay window — restricted to the HIGHEST priority class with any
        ready flow (strict priority), in ring (activation) order within
        it. A lower class is served exactly when no higher class is
        ready."""
        delay = self._delay()
        with self._cond:
            ready = {f for f, rs in self._pending.items()
                     if len(rs) >= self._max_batch(f[1])
                     or now - rs[0].t_submit >= delay}
        if not ready:
            return []
        for f in ready:
            if f not in self._rr:   # ring self-repair: a bookkeeping bug
                self._rr.append(f)  # may cost fairness, never liveness
        best = min(ci for ci, _ in ready)
        return [f for f in self._rr if f in ready and f[0] == best]

    def _serve_ready(self) -> int:
        """Serve ONE round over the ready flows; returns flushes made.

        ``_ready_flows`` restricts the round to the highest priority
        class with work ready, and the run loop polls the ingest queue
        between rounds — so an arrival in a higher class preempts a
        lower class's NEXT flush (never an in-progress batch: preemption
        granularity is one flush), even mid-backlog.

        Fair mode is textbook deficit round robin in request units: each
        round visits every ready flow of the serving class once in ring
        order, banks a quantum of ``max_batch`` credits, and flushes
        while the deficit covers the next flush's occupancy — so a bucket
        with a deep backlog dispatches ~one full batch per round,
        interleaved with every other bucket of its class, and an emptied
        flow forfeits its credit (no hoarding). Legacy mode flushes ready
        flows in ring order with no quantum, which together with the
        ingest-time flush-on-full reproduces the old arrival-order
        policy.
        """
        served = 0
        now = time.monotonic()
        ready = self._ready_flows(now)
        if not ready:
            return served
        if not self.config.fair:
            for b in ready:
                self._flush(b)
                served += 1
            return served
        for b in ready:
            # per-bucket quantum: each bucket's round is worth its own
            # max_batch in request credits, and the banked deficit is
            # CAPPED at one quantum beyond the largest possible flush
            # (= that same max_batch): DRR's fairness guarantee is only
            # as good as the bank stays bounded — credit accrued while
            # a bucket sits pending-but-unready must never later pay
            # for a mega-burst that flushes its whole backlog ahead of
            # every other bucket (tests/test_scheduler.py pins the
            # no-mega-burst behavior)
            quantum = self._max_batch(b[1])
            deficit_cap = quantum + quantum
            self._deficit[b] = min(
                self._deficit.get(b, 0) + quantum, deficit_cap)
            while True:
                with self._cond:
                    rs = self._pending.get(b)
                    occ = min(len(rs), quantum) if rs else 0
                    is_ready = rs is not None and (
                        len(rs) >= quantum
                        or now - rs[0].t_submit >= self._delay())
                if not is_ready or self._deficit.get(b, 0) < occ:
                    break
                self._deficit[b] -= occ
                self._flush(b)
                served += 1
        return served

    def _drain(self) -> None:
        """Shutdown drain: ingest everything still admitted, then flush
        flow by flow — class priority first, ring order within a class,
        each flush capped at ``max_batch`` — until nothing is pending,
        and retire every in-flight job."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _SHUTDOWN:
                continue
            self._enqueue_pending(item)
        while True:
            with self._cond:
                # class priority, then ring order, with a direct-listing
                # fallback so a ring bookkeeping bug could only ever cost
                # fairness, not the drain's termination
                ring = {f: i for i, f in enumerate(self._rr)}
                flows = sorted(self._pending,
                               key=lambda f: (f[0], ring.get(f, len(ring))))
            if not flows:
                break
            for flow in flows:
                self._flush(flow)
        while self._inflight:
            self._retire_one()

    def _flush(self, flow: Tuple[int, Hashable]) -> None:
        """Dispatch one batch from a flow at its sub-batch size; keep at
        most ``inflight_jobs`` outstanding. A flush takes at most
        ``max_batch`` requests — anything beyond stays pending (and keeps
        its age), so no flush ever exceeds the compiled-shape ladder.
        The dispatch callback still receives the plain bucket: the class
        is a scheduling concern, not a batching one, and a flush is
        always single-class (flows never mix classes) so padding and
        compiled shapes are untouched."""
        bucket = flow[1]
        max_batch = self._max_batch(bucket)
        with self._cond:
            reqs = self._pending[flow]
            requests = reqs[:max_batch]
            rest = reqs[max_batch:]
            if rest:
                self._pending[flow] = rest
            else:
                del self._pending[flow]
                self._deficit.pop(flow, None)
                try:
                    self._rr.remove(flow)
                except ValueError:
                    pass
        batch = (pick_sub_batch(len(requests), max_batch)
                 if self.config.sub_batches else max_batch)
        try:
            handle = self._dispatch(bucket, requests, batch)
        except Exception as e:   # config/backend errors -> fail this slice
            self._fail(requests, e)
            self._release(requests)
            return
        self._inflight.append(_Job(requests, handle))
        # strictly past the bound: inflight_jobs means N outstanding, not
        # N-1 (a >= here silently halved the double-buffering window)
        while len(self._inflight) > self.config.inflight_jobs:
            self._retire_one()

    def _retire_one(self) -> None:
        job = self._inflight.popleft()
        try:
            self._complete(job.handle, job.requests)
        except Exception as e:   # a raising complete() must not kill the loop
            self._fail(job.requests, e)
        finally:
            self._release(job.requests)

    def _release(self, requests: List[Any]) -> None:
        """Free the admission slots of a retired/failed slice (one bucket
        per slice) and wake any producers parked at a bound."""
        with self._cond:
            self._depth -= len(requests)
            self._completed += len(requests)
            # one drain-rate sample per retirement: the rolling slope of
            # (monotonic, completed_total) is what deadline admission
            # divides depth by
            self._drain_rate.observe(self._completed)
            if requests:
                b = getattr(requests[0], "bucket", None)
                left = self._depth_by_bucket.get(b, 0) - len(requests)
                if left > 0:
                    self._depth_by_bucket[b] = left
                else:
                    self._depth_by_bucket.pop(b, None)
            self._cond.notify_all()
