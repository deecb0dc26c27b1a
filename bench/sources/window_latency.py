"""Latency over the window, by the host's clock: the nearest-rank
quantile ``spec["q"]`` of every request's time from its due time to its
answer, a failed request counted as infinite, times ``spec["scale"]``."""

from __future__ import annotations

from typing import Optional

from bench import harness


def read(spec: dict, obs) -> Optional[float]:
    if not obs.window.latencies_s:
        return None
    return harness.STATS["quantile"](obs.window, spec, 0.0)
