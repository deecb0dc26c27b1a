"""What the serving drivers share: the service, its masks and its check.

The system is ``YCHGService`` over ``Engine``, built from the
configuration's ``engine`` and ``service`` sections; the control in its
place answers each request with the reference as the configuration's
``control`` bends it. Masks
are a pool of snowfields made on the device from the seed, each request a
copy of one with its own patch (``bench.gen.modis.patched``), so no two
requests are alike and the content hash never hits. The copies go into a
ring of ``buffers`` host arrays, touched once at set-up and taken back
when a request's answer is in: the clients make no fresh allocation whose
page faults would contend with the service's own.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from bench import harness
from bench.gen import modis
from bench.reference import ychg as ref

# request indices of the warm load, apart from those of the window
WARM_LOAD_BASE = 1 << 40


class ControlResult:
    def __init__(self, fields: Dict[str, np.ndarray]):
        self.fields = fields

    def to_host(self) -> Dict[str, np.ndarray]:
        return self.fields


class ControlService:
    """The reference in the service's place, departing from the definition
    as the configuration's ``control`` says."""

    def __init__(self, control: dict, workers: int = 4):
        self.control = control
        self._pool = ThreadPoolExecutor(workers)

    def submit(self, mask: np.ndarray, op: str = "ychg") -> Future:
        return self._pool.submit(
            lambda: ControlResult(ref.analyze(mask, **self.control)))

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class Serving:
    """The service of the cell, its mask pool, and the answers kept."""

    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        p = ctx.workload["params"]
        self.res = p["res"]
        self.patch = p["patch"]
        self.base = modis.snowfield_pool(
            ctx.torch, p["pool"], self.res, ctx.seed,
            coverage=p["coverage"], device=ctx.device)
        self._free: "queue.Queue[np.ndarray]" = queue.Queue()
        for _ in range(p["buffers"]):
            self._free.put(self.base[0].copy())
        self.max_batch = ctx.config["service"].get("max_batch", 8)
        self.dispatched: Optional[List[tuple]] = [] if ctx.trace else None
        self.service = self._build()
        self.results: Dict[int, object] = {}
        self.host: Dict[int, Dict[str, np.ndarray]] = {}
        self._lock = threading.Lock()

    def _build(self):
        if self.ctx.control:
            return ControlService(self.ctx.config["control"])
        from repro_torch.engine import Engine, EngineConfig
        from repro_torch.service import ServiceConfig, YCHGService

        engine = Engine(EngineConfig(**self.ctx.config["engine"]),
                        device=self.ctx.device)
        svc = dict(self.ctx.config["service"])
        svc["bucket_sides"] = tuple(svc.get("bucket_sides", ()))
        service = YCHGService(engine, ServiceConfig(**svc))
        self._warm_engine(engine, service)
        if self.dispatched is not None:
            harness.count_dispatch(engine, self.dispatched)
        return service

    def _warm_engine(self, engine, service) -> None:
        """Every stack shape the cell's bucket can dispatch: the sub-batch
        ladder 1, 2, 4, ... up to max_batch at the bucket's side."""
        from repro_torch.service.batching import pick_bucket_side

        side = pick_bucket_side((self.res, self.res),
                                service.config.bucket_sides)
        b = 1
        while b < 2 * self.max_batch:
            stack = np.zeros((min(b, self.max_batch), side, side), np.uint8)
            engine.analyze_batch(stack).block_until_ready()
            b *= 2

    def mask(self, index: int) -> np.ndarray:
        """A fresh array holding request ``index``'s mask."""
        return modis.patched(self.base[index % len(self.base)],
                             self.ctx.seed, index, self.patch)

    def take(self, index: int) -> np.ndarray:
        """Request ``index``'s mask in a buffer of the ring (waits for a
        free one); hand it back with ``give`` once the answer is in."""
        buf = self._free.get()
        np.copyto(buf, self.base[index % len(self.base)])
        modis.apply_patch(buf, self.ctx.seed, index, self.patch)
        return buf

    def give(self, buf: np.ndarray) -> None:
        self._free.put(buf)

    def metrics(self):
        m = getattr(self.service, "metrics", None)
        return m() if m is not None else None

    def keep(self, index: int, result) -> None:
        with self._lock:
            self.results[index] = result

    def collect(self, sample: List[int]) -> None:
        """Host copies of the sampled answers; every device result is let
        go."""
        for i in sample:
            r = self.results.get(i)
            if r is not None:
                self.host[i] = r.to_host()
        self.results = {}

    def close(self) -> None:
        if self.service is not None:
            self.service.close()
            self.service = None

    def check(self, sample: List[int], unanswered: int) -> dict:
        """``unanswered``: requests of the window that failed or never
        came back (a window with none at all counts one); wrong elements
        over the sampled answers, against the reference."""
        wrong = compared = 0
        for i in sample:
            got = self.host.get(i)
            if got is None:
                continue  # counted under unanswered
            wrong += ref.mismatches(got, ref.analyze(self.mask(i)))
            compared += 1
        self.ctx.log(f"check: {compared} answers compared with the "
                     f"reference")
        return {"unanswered": {"value": unanswered, "limit": 0},
                "wrong_elements": {"value": wrong, "limit": 0}}
