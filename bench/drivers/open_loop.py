"""Open loop: requests due on a fixed schedule, whatever the service does.

Parameters (``params`` of the workload file): ``res`` (mask side),
``pool`` (base snowfields), ``coverage``, ``patch`` (side of each
request's unique patch), ``buffers`` (the ring of request masks), ``rate`` (requests a second), ``clients``
(submitting threads), ``warm_seconds`` (the cell's load before the
window, on requests of its own), ``sample`` (answers compared with the
reference).

The window holds round(rate x seconds) requests. Their gaps are the
quantiles of an exponential distribution of mean 1/rate, scaled to fill
the window exactly, in an order drawn from the seed: every seed offers
the same arrivals in another order. Each client thread takes the next
request, makes its mask, sleeps until it is due and submits it; a
callback stamps the moment its future resolves. A request's latency runs
from its due time to that moment; one that fails, or is not back a
minute after the window closes, is infinite. The rate is the pixels of
the requests answered over the time from the window's start to the last
answer.
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
LEAD_S = 0.25


def due_offsets(n: int, rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times of ``n`` requests in (0, seconds], from the window start."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[np.random.default_rng([seed % (2**63), 1]).permutation(n)]
    return np.cumsum(gaps) * (seconds / gaps.sum())


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
        n = max(1, int(round(p["rate"] * seconds)))
        before = s.metrics()
        t0 = time.monotonic() + LEAD_S
        due = t0 + due_offsets(n, p["rate"], seconds, self.ctx.seed)
        done: Dict[int, float] = {}
        futures: Dict[int, object] = {}
        lag = np.zeros(n)
        nxt = [0]
        lock = threading.Lock()

        def stamp(i, fut):
            done[i] = time.monotonic()

        def client():
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= n:
                    return
                mask = s.take(self.index_base + i)
                wait = due[i] - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                lag[i] = time.monotonic() - due[i]
                try:
                    fut = s.service.submit(mask, op="ychg")
                except Exception as e:  # a shed or failed submit
                    self.ctx.log(f"request {i} refused: {e!r}")
                    s.give(mask)
                    continue
                futures[i] = fut
                fut.add_done_callback(lambda f, i=i: stamp(i, f))
                fut.add_done_callback(lambda f, m=mask: s.give(m))

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(p["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        deadline = t0 + seconds + LATE_S
        got = set()
        for i, fut in futures.items():
            try:
                s.keep(self.index_base + i, fut.result(
                    timeout=max(0.0, deadline - time.monotonic())))
                got.add(i)
            except Exception as e:
                self.ctx.log(f"request {i} failed: {e!r}")
        # a future's waiters wake before its callbacks run: let each stamp
        # land
        for i in got:
            t_wait = time.monotonic() + 1.0
            while i not in done and time.monotonic() < t_wait:
                time.sleep(1e-4)
        after = s.metrics()
        latencies = [done[i] - due[i] if i in got and i in done
                     else math.inf for i in range(n)]
        answered = [i for i in range(n) if math.isfinite(latencies[i])]
        self.unanswered = n - len(answered)
        t1 = max([done[i] for i in answered], default=t0 + seconds)
        self.ctx.log(f"generator lag: median {np.median(lag) * 1e3:.3f} ms, "
                     f"max {lag.max() * 1e3:.3f} ms over {n} requests")
        rng = np.random.default_rng([self.ctx.seed % (2**63), 2])
        self.sample = sorted(self.index_base + int(i) for i in rng.choice(
            answered, size=min(p["sample"], len(answered)), replace=False)) \
            if answered else []
        window = harness.Window(
            t0=t0, t1=t1, pixels=len(answered) * p["res"] ** 2,
            attempted=n, failed=self.unanswered, latencies_s=latencies)
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
