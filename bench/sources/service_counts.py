"""Counts of the service: the share of batch slots that carried a request.

Requests computed over the window (completions less cache hits) over the
batches dispatched times ``max_batch``, as a percentage; the counts are
``ServiceMetrics``' own, differenced between the window's snapshots.
"""

from __future__ import annotations

from typing import Optional


def read(spec: dict, obs) -> Optional[float]:
    a, b = obs.service_before, obs.service_after
    if a is None or b is None or not obs.max_batch:
        return None
    batches = b.batches - a.batches
    computed = ((b.completed - b.completed_from_cache)
                - (a.completed - a.completed_from_cache))
    if batches <= 0:
        return None
    return 100.0 * computed / (batches * obs.max_batch)
