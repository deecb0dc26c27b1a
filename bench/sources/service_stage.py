"""A stage of the service: its ``ServiceMetrics.stage_hists`` series.

The series of ``spec["stage"]`` are summed over their bucket and class
labels, differenced between the snapshots at the window's start and end,
and read as the mean seconds a sample, times ``spec["scale"]``. A stage is
sampled once a request (``cache_probe``, ``queue_wait``) or once a batch
(``flush``), which is what its metric is "a".
"""

from __future__ import annotations

from typing import Optional


def _totals(snapshot, stage: str) -> tuple:
    total, count = 0.0, 0
    for labels, hist in snapshot.stage_hists:
        if dict(labels).get("stage") == stage:
            total += hist.sum
            count += hist.count
    return total, count


def read(spec: dict, obs) -> Optional[float]:
    if obs.service_before is None or obs.service_after is None:
        return None
    s0, n0 = _totals(obs.service_before, spec["stage"])
    s1, n1 = _totals(obs.service_after, spec["stage"])
    if n1 <= n0:
        return None
    return (s1 - s0) / (n1 - n0) * spec.get("scale", 1.0)
