"""The device's timeline of the measured window, from ``torch.profiler``.

``Recorder`` traces the window, marks its start with a named range on the
host so that the trace's clock and the host's monotonic clock can be
aligned, then traces the card alone. It exports the Chrome trace to a
file under TMPDIR and reads back every kernel, copy and memset that ran on
the card.
``DeviceTrace`` holds them clipped to the window: the time the device was
busy (the union of those intervals), each kernel's time, and the idle gaps,
each named by the program's host span that covers it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "bench.window_mark"
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    """Device operations of the window, in seconds of the host's clock."""

    w0: float
    w1: float
    ops: List[Tuple[str, str, float, float]]  # (name, cat, start, end)
    spans: List[tuple]

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, _, s, e in sorted(self.ops, key=lambda o: o[2]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    @property
    def kernel_s(self) -> float:
        return sum(e - s for _, cat, s, e in self.ops if cat == "kernel")

    def gaps(self) -> List[Tuple[float, float]]:
        out, t = [], self.w0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def _host_name(self, t: float) -> str:
        """The shortest program span that covers ``t``."""
        best: Optional[tuple] = None
        for name, s0, s1, _ in self.spans:
            if s0 <= t <= s1 and (best is None or s1 - s0 < best[1]):
                best = (name, s1 - s0)
        return best[0] if best else "no program span"

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, s, e in self.ops:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_name((a + b) / 2), b - a]
                              for a, b in gaps]}


class Recorder:
    """``torch.profiler`` over the window, read back as a DeviceTrace."""

    def __init__(self, torch, device: str):
        self.torch = torch
        self.device = device
        self._prof = None
        self._mark_mono = 0.0

    def start(self) -> None:
        prof = self.torch.profiler
        acts = [prof.ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(prof.ProfilerActivity.CUDA)
        self._prof = prof.profile(activities=acts)
        self._prof.__enter__()
        self._mark_mono = time.monotonic()
        with prof.record_function(MARK):
            pass
        if self.device == "cuda":
            # the host's ops were wanted for the mark alone: a window of
            # tens of thousands of requests would otherwise fill the trace
            self._prof.toggle_collection_dynamic(
                False, [prof.ProfilerActivity.CPU])

    def stop(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def read(self, obsv) -> Optional[DeviceTrace]:
        """The window's device operations; None where the trace holds
        none (a run on the CPU, or a profiler that saw no device)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        mark = [e for e in events if e.get("name") == MARK
                and e.get("ph") == "X"]
        if not mark:
            return None
        # trace microseconds -> host monotonic seconds
        offset = self._mark_mono - float(mark[0]["ts"]) * 1e-6
        w0, w1 = obsv.window.t0, obsv.window.t1
        ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            s = float(e["ts"]) * 1e-6 + offset
            t = s + float(e.get("dur", 0.0)) * 1e-6
            s, t = max(s, w0), min(t, w1)
            if t > s:
                ops.append((e["name"], e["cat"], s, t))
        if not ops:
            return None
        return DeviceTrace(w0, w1, ops, obsv.spans or [])
