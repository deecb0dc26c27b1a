"""Request tracing: spans, cross-process trace ids, and a flight recorder.

Design constraints, in priority order:

1. **~Zero cost when disabled.** ``maybe_trace`` returns the shared
   ``NULL_TRACE`` singleton whose methods are constant-time no-ops; hot
   paths hold one attribute check, no allocation, no lock. The bench gate
   enforces this stays inside the existing tolerances.
2. **Monotonic clocks, wall alignment.** Spans are timed with
   ``time.monotonic()`` (immune to NTP steps). Each process records one
   (wall, mono) epoch pair at import; export converts mono timestamps to
   the wall axis so spans from router + workers line up on one Perfetto
   timeline to within clock-sync error.
3. **Creator finishes.** The tier that *creates* a Trace (frontend
   handler, router request, scene granule, or ``YCHGService.submit`` when
   called without one) calls ``finish()``; everyone handed an existing
   trace only adds spans. ``finish`` is idempotent, so belt-and-braces
   finishing in error paths is safe.

The flight recorder keeps the most recent N *completed* traces in a ring
and serialises them as Chrome-trace JSON (the ``traceEvents`` array form)
for ``GET /debug/traces``, ``serve.py --trace-dump``, and the SIGTERM /
dispatch-crash auto-dump.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

# One (wall, mono) epoch pair per process: chrome export maps a monotonic
# timestamp t to wall-axis microseconds as (_WALL0 + (t - _MONO0)) * 1e6,
# so traces from different processes share one timeline.
_WALL0 = time.time()
_MONO0 = time.monotonic()


def mono_to_wall_us(t_mono: float) -> float:
    return (_WALL0 + (t_mono - _MONO0)) * 1e6


class _State:
    """Process-global tracing switches (env-seeded, configure()-mutable)."""

    def __init__(self):
        self.enabled = os.environ.get("YCHG_TRACE", "1") != "0"
        self.dump_path: Optional[str] = os.environ.get("YCHG_TRACE_DUMP")
        self.capacity = 256


_STATE = _State()
_UNSET = object()


def configure(enabled=_UNSET, dump_path=_UNSET, capacity=_UNSET) -> None:
    """Override tracing switches (serve.py --trace-dump lands here)."""
    if enabled is not _UNSET:
        _STATE.enabled = bool(enabled)
    if dump_path is not _UNSET:
        _STATE.dump_path = dump_path
    if capacity is not _UNSET:
        _recorder.resize(int(capacity))
        _STATE.capacity = int(capacity)


def tracing_enabled() -> bool:
    return _STATE.enabled


def new_trace_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One named interval inside a trace. Use as a context manager or via
    Trace.add() with explicit timestamps."""

    __slots__ = ("name", "t0", "t1", "meta", "_trace")

    def __init__(self, trace: "Trace", name: str, **meta):
        self._trace = trace
        self.name = name
        self.t0 = 0.0
        self.t1 = 0.0
        self.meta = meta

    def __enter__(self) -> "Span":
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.monotonic()
        self._trace._record(self)
        return None


class Trace:
    """A bag of spans sharing one trace id. Lock-light: span appends take
    one short lock; cross-thread adds (scheduler/dispatch threads joining
    a submit-side trace) are the norm, not the exception."""

    __slots__ = ("trace_id", "process", "_spans", "_lock", "_finished")

    def __init__(self, trace_id: Optional[str] = None,
                 process: str = "service"):
        self.trace_id = trace_id or new_trace_id()
        self.process = process
        self._spans: List[Tuple[str, float, float, dict]] = []
        self._lock = threading.Lock()
        self._finished = False

    @property
    def enabled(self) -> bool:
        return True

    def span(self, name: str, **meta) -> Span:
        return Span(self, name, **meta)

    def add(self, name: str, t0: float, t1: float, **meta) -> None:
        """Record an interval from timestamps already in hand (monotonic
        seconds). The instrumented code paths mostly use this: they note
        time.monotonic() at stage edges they needed anyway."""
        with self._lock:
            self._spans.append((name, t0, min_t1(t0, t1), meta))

    def _record(self, span: Span) -> None:
        self.add(span.name, span.t0, span.t1, **span.meta)

    def spans(self) -> List[Tuple[str, float, float, dict]]:
        with self._lock:
            return list(self._spans)

    def finish(self) -> None:
        """Hand the trace to the flight recorder; idempotent."""
        with self._lock:
            if self._finished or not self._spans:
                self._finished = True
                return
            self._finished = True
        _recorder.record(self)


class _NullTrace:
    """Shared do-nothing stand-in used whenever tracing is off. Every
    method is a constant-time no-op so call sites need no branching."""

    __slots__ = ()
    trace_id = ""
    process = ""
    enabled = False

    def span(self, name: str, **meta) -> "_NullSpan":
        return _NULL_SPAN

    def add(self, name: str, t0: float, t1: float, **meta) -> None:
        return None

    def spans(self) -> list:
        return []

    def finish(self) -> None:
        return None


class _NullSpan:
    __slots__ = ()
    name = ""
    t0 = 0.0
    t1 = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_TRACE = _NullTrace()
_NULL_SPAN = _NullSpan()


def maybe_trace(trace_id: Optional[str] = None,
                process: str = "service"):
    """A live Trace when tracing is enabled, else NULL_TRACE."""
    if not _STATE.enabled:
        return NULL_TRACE
    return Trace(trace_id, process=process)


def min_t1(t0: float, t1: float) -> float:
    # monotonic should make t1 >= t0 automatic; clamp anyway so a caller
    # mixing up argument order cannot produce negative-duration spans
    return t1 if t1 >= t0 else t0


class FlightRecorder:
    """Bounded ring of the most recent completed traces in this process."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._ring = collections.deque(self._ring, maxlen=capacity)

    def record(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)

    def traces(self) -> List[Trace]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def chrome_events(self) -> List[Dict]:
        """Chrome-trace 'X' (complete) events for every recorded trace.
        pid is the real OS pid so a fleet dump shows router and workers as
        separate process tracks; tid groups spans by trace id so parallel
        requests stay on separate rows."""
        pid = os.getpid()
        events = []
        for trace in self.traces():
            for name, t0, t1, meta in trace.spans():
                args = {"trace_id": trace.trace_id}
                if meta:
                    args.update({k: str(v) for k, v in meta.items()})
                events.append({
                    "name": name,
                    "cat": trace.process,
                    "ph": "X",
                    "ts": mono_to_wall_us(t0),
                    "dur": max(0.0, (t1 - t0) * 1e6),
                    "pid": pid,
                    "tid": trace.trace_id,
                    "args": args,
                })
        return events

    def to_chrome_json(self) -> str:
        return json.dumps({"traceEvents": self.chrome_events(),
                           "displayTimeUnit": "ms"})

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(self.to_chrome_json())


_recorder = FlightRecorder(_STATE.capacity)


def recorder() -> FlightRecorder:
    return _recorder


def auto_dump(reason: str) -> Optional[str]:
    """Dump the flight recorder to the configured path (SIGTERM handler,
    dispatch-loop crash). Returns the path written, or None when no dump
    path is configured or the write failed — never raises: a failing dump
    must not mask the original error."""
    path = _STATE.dump_path
    if not path:
        return None
    try:
        _recorder.dump(path)
        return path
    except OSError:
        return None
