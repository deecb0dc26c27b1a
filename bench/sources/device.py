"""The device's timeline from ``torch.profiler`` (``bench.devtrace``).

``idle_pct``: the share of the window in which neither a kernel nor a copy
ran on the card. ``roofline``: the least time the card needs for the work
of the stacks dispatched in the window (``bench.roofline``, from their
shapes, at the published peaks), over the device time of every kernel
that ran in it, as a percentage.
"""

from __future__ import annotations

from typing import Optional

from bench import roofline


def read(spec: dict, obs) -> Optional[float]:
    dev = obs.device
    if dev is None or dev.window_s <= 0:
        return None
    if spec["stat"] == "idle_pct":
        return 100.0 * (1.0 - dev.busy_s / dev.window_s)
    if spec["stat"] == "roofline":
        if not obs.dispatched or dev.kernel_s <= 0:
            return None
        work = getattr(roofline, f"{spec['work']}_work")
        least = sum(roofline.least_s(*work(*shape, size))
                    for shape, size in obs.dispatched)
        return 100.0 * least / dev.kernel_s
    raise ValueError(f"unknown device statistic {spec['stat']!r}")
