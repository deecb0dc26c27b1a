"""Closed loop: each client keeps one request outstanding.

Parameters: ``res``, ``pool``, ``coverage``, ``patch``, ``buffers``,
``clients``, ``warm_seconds`` and ``sample``, as for ``open_loop``. Client
threads draw request indices in turn, make the mask, submit it and wait
for its answer until the window ends; the rate is the pixels of the answers back inside the
window over its length. Requests still out when it ends are waited for
(a minute at most) and checked, and do not count toward the rate.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

import numpy as np

from bench import harness
from bench.drivers._serving import WARM_LOAD_BASE, Serving

LATE_S = 60.0


class Driver:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.p = ctx.workload["params"]
        self.serving = None
        self.sample: List[int] = []
        self.unanswered = 0
        self.index_base = 0   # first request index of the next window

    def setup(self) -> None:
        self.serving = Serving(self.ctx)
        # the cell's own load for warm_seconds, on requests of its own, so
        # that the window starts in the steady state
        self.index_base = WARM_LOAD_BASE
        self.window(self.p["warm_seconds"])
        self.serving.results = {}
        if self.serving.dispatched is not None:
            self.serving.dispatched.clear()
        self.index_base = 0

    def window(self, seconds: float) -> harness.Observations:
        s, p = self.serving, self.p
        before = s.metrics()
        t0 = time.monotonic()
        t_end = t0 + seconds
        latency: Dict[int, float] = {}
        finished: Dict[int, float] = {}
        nxt = [0]
        lock = threading.Lock()

        def client():
            while time.monotonic() < t_end:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                mask = s.take(self.index_base + i)
                t_sub = time.monotonic()
                latency[i] = math.inf
                try:
                    r = s.service.submit(mask, op="ychg").result(
                        timeout=max(0.0, t_end + LATE_S - t_sub))
                except Exception as e:
                    self.ctx.log(f"request {i} failed: {e!r}")
                    continue
                finally:
                    s.give(mask)
                finished[i] = time.monotonic()
                latency[i] = finished[i] - t_sub
                s.keep(self.index_base + i, r)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(p["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 2 * LATE_S)
        after = s.metrics()
        n = nxt[0]
        answered = [i for i in range(n) if math.isfinite(latency.get(i,
                                                                     math.inf))]
        in_window = sum(1 for i in answered if finished[i] <= t_end)
        self.unanswered = (n - len(answered)) if n else 1
        rng = np.random.default_rng([self.ctx.seed % (2**63), 2])
        self.sample = sorted(self.index_base + int(i) for i in rng.choice(
            answered, size=min(p["sample"], len(answered)), replace=False)) \
            if answered else []
        window = harness.Window(
            t0=t0, t1=t_end, pixels=in_window * p["res"] ** 2,
            attempted=n, failed=n - len(answered),
            latencies_s=[latency.get(i, math.inf) for i in range(n)])
        return harness.Observations(
            window=window, service_before=before, service_after=after,
            max_batch=s.max_batch, dispatched=s.dispatched)

    def collect(self) -> None:
        self.serving.collect(self.sample)

    def close(self) -> None:
        if self.serving is not None:
            self.serving.close()

    def check(self) -> dict:
        return self.serving.check(self.sample, self.unanswered)
