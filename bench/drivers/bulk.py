"""Bulk: a manifest of memory-mapped granules run as one resumable job.

Parameters: ``res``, ``hyperedges``, ``granules`` (manifest length, more
than a window can finish), ``warm_granules``. The granule is a (res, res)
``striped`` pattern with ``hyperedges`` cells (``bench.gen.modis``), its
rows and columns rolled by the seed within the pattern's blank margin, so
that the seed moves the content and not the count.

The granule is written as an ``.npy`` file under TMPDIR at set-up; the
manifest repeats it under distinct ids. The system is ``BulkJob`` over
``Engine``, from the configuration's ``engine`` and ``bulk`` sections; the
window is one ``run(should_stop=...)`` that stops at its end. The rate is
the real pixels of the tile rows done over the time ``run`` took. The
control in its place writes each granule's result from the reference as
the configuration's ``control`` bends it.
"""

from __future__ import annotations

import os
import time
import types
from typing import Dict

import numpy as np

from bench import harness
from bench.gen import modis
from bench.reference import ychg as ref
from bench.reference import ychg_file


def striped_rolled(res: int, hyperedges: int, seed: int) -> np.ndarray:
    img = modis.striped(res, hyperedges)
    side = int(np.ceil(np.sqrt(hyperedges)))
    margin = res - side * (res // side)
    rng = np.random.default_rng([seed % (2**63), 3])
    dy, dx = (int(v) for v in rng.integers(0, margin + 1, size=2))
    return np.roll(img, (dy, dx), axis=(0, 1))


class ControlJob:
    """The reference in the bulk job's place, departing from the
    definition as the configuration's ``control`` says."""

    def __init__(self, manifest, config, control: dict):
        self.manifest = manifest
        self.config = config
        self.control = control
        os.makedirs(config.out_dir, exist_ok=True)

    def run(self, should_stop):
        written, tiles = [], 0
        tile_h = self.config.tile_h
        for spec in self.manifest:
            if should_stop():
                break
            fields = ref.analyze(np.load(spec.path, mmap_mode="r"),
                                 **self.control)
            n_tiles = -(-spec.height // tile_h)
            header = {"granule_id": spec.granule_id, "height": spec.height,
                      "width": spec.width, "tile_h": tile_h,
                      "n_tiles": n_tiles}
            written.append(ychg_file.write(
                os.path.join(self.config.out_dir,
                             f"{spec.granule_id}.ychg"), header, fields))
            tiles += n_tiles
        return types.SimpleNamespace(granules_done=len(written),
                                     tiles_done=tiles, written=written,
                                     status="interrupted")


class Driver:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.p = ctx.workload["params"]
        self.report = None
        self.manifest = []
        self.path = ""

    # ------------------------------------------------------------- set-up

    def _granule_file(self) -> str:
        p = self.p
        path = os.path.join(self.ctx.tmp, "granule.npy")
        np.save(path, striped_rolled(p["res"], p["hyperedges"],
                                     self.ctx.seed))
        return path

    def _job(self, manifest, name: str):
        from repro_torch.scene import BulkJob, BulkJobConfig, SceneProgress

        cfg = BulkJobConfig(out_dir=os.path.join(self.ctx.tmp, name, "out"),
                            ckpt_dir=os.path.join(self.ctx.tmp, name, "ckpt"),
                            **self.ctx.config["bulk"])
        if self.ctx.control:
            return ControlJob(manifest, cfg, self.ctx.config["control"])
        return BulkJob(self.engine, manifest, cfg, progress=SceneProgress())

    def setup(self) -> None:
        from repro_torch.scene import GranuleSpec

        self.path = self._granule_file()
        res = self.p["res"]
        self.manifest = [
            GranuleSpec(granule_id=f"g{k:06d}", height=res, width=res,
                        kind="memmap", path=self.path)
            for k in range(self.p["granules"])]
        self.engine = None
        self.dispatched = [] if self.ctx.trace else None
        if not self.ctx.control:
            from repro_torch.engine import Engine, EngineConfig

            self.engine = Engine(EngineConfig(**self.ctx.config["engine"]),
                                 device=self.ctx.device)
        warm = [GranuleSpec(granule_id=f"warm{k:03d}", height=res,
                            width=res, kind="memmap", path=self.path)
                for k in range(self.p["warm_granules"])]
        self._job(warm, "warm").run(should_stop=lambda: False)
        if self.dispatched is not None:
            harness.count_dispatch(self.engine, self.dispatched)

    # ------------------------------------------------------------- window

    def real_pixels(self, tiles_done: int) -> int:
        tile_h = self.ctx.config["bulk"]["tile_h"]
        px = 0
        for spec in self.manifest:
            n = -(-spec.height // tile_h)
            take = min(n, tiles_done)
            px += min(spec.height, take * tile_h) * spec.width
            tiles_done -= take
            if tiles_done == 0:
                break
        return px

    def window(self, seconds: float) -> harness.Observations:
        job = self._job(self.manifest, "window")
        t0 = time.monotonic()
        t_end = t0 + seconds
        self.report = job.run(should_stop=lambda: time.monotonic() >= t_end)
        t1 = time.monotonic()
        r = self.report
        window = harness.Window(
            t0=t0, t1=t1, pixels=self.real_pixels(r.tiles_done),
            attempted=r.granules_done, failed=0)
        return harness.Observations(window=window, dispatched=self.dispatched)

    def collect(self) -> None:
        pass

    def close(self) -> None:
        self.engine = None

    # -------------------------------------------------------------- check

    def check(self) -> dict:
        """Every result file the window wrote, read back by the frozen
        reader and compared with the reference of its granule's data."""
        r = self.report
        want: Dict[str, dict] = {}
        by_id = {s.granule_id: s for s in self.manifest}
        tile_h = self.ctx.config["bulk"]["tile_h"]
        wrong = missing = 0
        for path in r.written:
            gid = os.path.basename(path)[:-len(".ychg")]
            spec = by_id.get(gid)
            try:
                header, fields = ychg_file.read(path)
            except (OSError, ValueError, KeyError) as e:
                self.ctx.log(f"{path}: unreadable: {e!r}")
                missing += 1
                continue
            if spec is None:
                wrong += 1
                continue
            if spec.path not in want:
                want[spec.path] = ref.analyze(np.load(spec.path,
                                                      mmap_mode="r"))
            expect = {"granule_id": gid, "height": spec.height,
                      "width": spec.width, "tile_h": tile_h,
                      "n_tiles": -(-spec.height // tile_h)}
            wrong += sum(header.get(k) != v for k, v in expect.items())
            wrong += ref.mismatches(fields, want[spec.path])
        missing += r.granules_done - len(r.written)
        if r.granules_done == 0:
            missing += 1
        self.ctx.log(f"check: {len(r.written)} result files compared with "
                     f"the reference")
        return {"unanswered": {"value": missing, "limit": 0},
                "wrong_elements": {"value": wrong, "limit": 0}}
