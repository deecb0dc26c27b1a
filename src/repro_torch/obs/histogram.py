"""Fixed-boundary log-spaced histograms for stage/latency timing.

Boundaries are FIXED (module constants, never derived from traffic): two
processes observing with the same bounds produce bucket vectors that sum
exactly, which is what lets the fleet router roll worker histograms up by
plain addition and still serve a correct Prometheus histogram. That
exactness is the whole reason these are not t-digests or windowed deques.

``quantile`` deliberately returns the **upper edge of the bucket** holding
the nearest-rank sample, with no intra-bucket interpolation: one sample
must report p50 == p95 (both ranks land in the same bucket), and a
quantile must never under-report below an observed sample's bucket. The
(lower, upper) edges are exposed via ``quantile_bounds`` so tests can
assert the true empirical percentile is bracketed.

``observe`` is lock-free: one list-index increment and one float add,
GIL-atomic enough for metrics (same discipline as the engine registry's
call counters — best-effort observability, not billing). Snapshots are
immutable and mergeable.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Tuple

# Request latencies and coarse stage times: 10 us .. 60 s, log-ish spacing
# (1/2.5/5 per decade). The +Inf bucket is implicit.
DEFAULT_LATENCY_BOUNDS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Engine dispatch cost (the synchronous spec.run call): sub-us resolution
# at the bottom because the dispatch budget is ~5 us/call.
DISPATCH_BOUNDS: Tuple[float, ...] = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 1e-3, 1e-2, 0.1, 1.0,
)


@dataclasses.dataclass(frozen=True)
class HistogramSnapshot:
    """Immutable point-in-time histogram: len(counts) == len(bounds) + 1
    (the trailing bucket is the implicit +Inf overflow)."""

    bounds: Tuple[float, ...]
    counts: Tuple[int, ...]
    sum: float
    count: int

    def cumulative(self) -> Tuple[int, ...]:
        total, out = 0, []
        for c in self.counts:
            total += c
            out.append(total)
        return tuple(out)

    def quantile_bounds(self, q: float) -> Tuple[float, float]:
        """(lower, upper) edges of the bucket holding the nearest-rank
        sample for quantile ``q``; (0.0, 0.0) when empty. The overflow
        bucket reports (top bound, top bound) — finite on purpose, so a
        gauge fed from it never renders +Inf."""
        if self.count == 0:
            return 0.0, 0.0
        rank = min(self.count, max(1, math.ceil(q * self.count)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                return lo, hi
        return 0.0, self.bounds[-1]

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile, reported as its bucket's upper edge."""
        return self.quantile_bounds(q)[1]

    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}")
        return HistogramSnapshot(
            bounds=self.bounds,
            counts=tuple(a + b for a, b in zip(self.counts, other.counts)),
            sum=self.sum + other.sum,
            count=self.count + other.count,
        )


def empty_snapshot(
        bounds: Tuple[float, ...] = DEFAULT_LATENCY_BOUNDS
        ) -> HistogramSnapshot:
    return HistogramSnapshot(bounds=tuple(bounds),
                             counts=(0,) * (len(bounds) + 1),
                             sum=0.0, count=0)


class Histogram:
    """Mutable fixed-boundary histogram; ``observe`` is lock-free."""

    __slots__ = ("bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_LATENCY_BOUNDS):
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"bounds must be a non-empty ascending ladder, got {bounds}")
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        # bisect_left gives the first bound >= value, i.e. the Prometheus
        # le-inclusive bucket; values past the top land in the overflow
        self._counts[bisect.bisect_left(self.bounds, value)] += 1
        self._sum += value
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._sum

    def snapshot(self) -> HistogramSnapshot:
        return HistogramSnapshot(bounds=self.bounds,
                                 counts=tuple(self._counts),
                                 sum=self._sum, count=self._count)
