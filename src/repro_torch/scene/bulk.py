"""BulkJob — a manifest of granules as one resumable, checkpointed batch.

The port's counterpart of ``repro.scene.bulk``, with the same checkpoint
tree, step numbering and result files, so a job begun by either package
resumes in the other with byte-identical outputs.

The job walks its manifest in order, streaming each granule's tile stacks
through a :class:`SceneRunner` and writing one deterministic result file
per granule (``<out_dir>/<granule_id>.ychg``, atomic temp+rename). Its
whole restartable state is tiny — which granule, which tile row, the
stitched run accumulator, and the carry row — and is checkpointed through
:class:`repro_torch.checkpoint.Checkpointer` every ``checkpoint_every`` stacks
and at every granule boundary.

Resume contract (asserted by tests/test_torch_scene.py and ``serve.py
--scene-smoke``): kill the job at any point — SIGTERM between stacks, or a hard kill
that corrupts the newest checkpoint (the Checkpointer falls back to the
newest *valid* one) — restart it with the same manifest and directories,
and the bytes written to ``out_dir`` are identical to an uninterrupted
run. That holds because (a) tile content is a pure function of the
granule spec (synthetic) or the backing file (memmap), (b) the engine is
deterministic, (c) the stitch is exact integer arithmetic whose partial
sums are exactly what the checkpoint stores, and (d) the result encoding
is content-determined (no timestamps). Work after the last checkpoint is
simply recomputed — at most ``checkpoint_every`` stacks.

Checkpoint steps are ``granule_index * 10**9 + next_tile``: monotone over
the whole job, and human-readable in the checkpoint directory.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.checkpoint import Checkpointer
from repro_torch.engine import Engine
from repro_torch.obs import NULL_TRACE, maybe_trace, minor_faults
from repro_torch.scene.granule import GranuleReader, GranuleSpec
from repro_torch.scene.result import write_scene_result
from repro_torch.scene.runner import (
    DEFAULT_STACK_TILES,
    SceneProgress,
    SceneRunner,
    SceneState,
)

_GRANULE_STRIDE = 10**9  # tiles per granule bound encoded into step numbers

# restore() template: dtypes matter (values are cast onto these), shapes
# are taken from the checkpoint itself
_STATE_LIKE = {
    "granule": np.zeros((), np.int64),
    "next_tile": np.zeros((), np.int64),
    "runs": np.zeros(1, np.int32),
    "prev_bottom": np.zeros(1, np.uint8),
    "resumes": np.zeros((), np.int64),
}


@dataclasses.dataclass(frozen=True)
class BulkJobConfig:
    out_dir: str
    ckpt_dir: str
    tile_h: int = 256
    stack_tiles: int = DEFAULT_STACK_TILES
    checkpoint_every: int = 4      # stacks between mid-granule checkpoints
    keep: int = 3                  # Checkpointer GC depth


@dataclasses.dataclass(frozen=True)
class BulkJobReport:
    """What one ``run()`` call did (counts are for this run only)."""

    status: str                    # "completed" | "interrupted"
    granules_done: int
    tiles_done: int
    stacks_done: int
    resumes: int                   # cumulative across the job's lifetime
    written: List[str]             # result files written this run
    elapsed_s: float

    @property
    def completed(self) -> bool:
        return self.status == "completed"


class BulkJob:
    """Run a granule manifest to completion, resumably.

    ``BulkJob(None, ...)`` builds ``Engine()``, which runs on the card and
    raises where there is none.
    """

    def __init__(self, engine: Optional[Engine],
                 manifest: Sequence[GranuleSpec], config: BulkJobConfig, *,
                 progress: Optional[SceneProgress] = None):
        if not manifest:
            raise ValueError("empty granule manifest")
        ids = [s.granule_id for s in manifest]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate granule_id in manifest: {ids}")
        self.manifest = list(manifest)
        self.config = config
        self.runner = SceneRunner(engine, stack_tiles=config.stack_tiles)
        self.progress = progress
        self._ckpt = Checkpointer(config.ckpt_dir, keep=config.keep)
        os.makedirs(config.out_dir, exist_ok=True)

    def output_path(self, spec: GranuleSpec) -> str:
        return os.path.join(self.config.out_dir, f"{spec.granule_id}.ychg")

    # ------------------------------------------------------------ checkpoint

    def _save(self, granule_idx: int, state: SceneState, resumes: int) -> None:
        tree = {
            "granule": np.int64(granule_idx),
            "next_tile": np.int64(state.next_tile),
            "runs": state.runs,
            "prev_bottom": state.prev_bottom,
            "resumes": np.int64(resumes),
        }
        self._ckpt.save(granule_idx * _GRANULE_STRIDE + state.next_tile, tree)

    def _restore(self) -> Optional[tuple[int, SceneState, int]]:
        """(granule index, state, prior resume count) from the newest
        valid checkpoint, or None for a cold start. Corrupt checkpoints
        are skipped (with a warning) by ``Checkpointer.latest_step``."""
        step = self._ckpt.latest_step()
        if step is None:
            return None
        tree = self._ckpt.restore(step, like=_STATE_LIKE)
        gi = int(np.asarray(tree["granule"]))
        state = SceneState(
            next_tile=int(np.asarray(tree["next_tile"])),
            runs=np.asarray(tree["runs"], np.int32).copy(),
            prev_bottom=np.asarray(tree["prev_bottom"], np.uint8).copy(),
        )
        if gi < len(self.manifest):
            spec = self.manifest[gi]
            if state.runs.shape != (spec.width,):
                raise ValueError(
                    f"checkpoint step {step} has width "
                    f"{state.runs.shape[0]} but manifest granule "
                    f"{spec.granule_id!r} is {spec.width} wide — was the "
                    f"manifest changed under a live checkpoint directory?")
        return gi, state, int(np.asarray(tree["resumes"]))

    # ------------------------------------------------------------------ run

    def run(self, *, max_stacks: Optional[int] = None,
            should_stop: Optional[Callable[[], bool]] = None
            ) -> BulkJobReport:
        """Process until done, stopped, or out of budget.

        ``should_stop`` is polled between stacks (wire a SIGTERM handler
        to it); ``max_stacks`` bounds this run's device work (tests use it
        to stop deterministically mid-granule). Either exit checkpoints
        the current state first, so the next ``run()`` resumes from the
        last completed tile row.
        """
        t_start = time.perf_counter()
        cfg = self.config
        start_gi, state, resumes = 0, None, 0
        restored = self._restore()
        if restored is not None:
            start_gi, state, resumes = restored
            resumes += 1
            if self.progress is not None:
                self.progress.note_resume()
        if self.progress is not None:
            self.progress.set_totals(
                tiles=sum(-(-s.height // cfg.tile_h) for s in self.manifest),
                granules=len(self.manifest))

        stacks_done = tiles_done = granules_done = 0
        written: List[str] = []
        tr = NULL_TRACE  # current granule's trace (one trace per granule)

        def save_ckpt(gi: int, st: SceneState) -> None:
            c0 = time.monotonic()
            self._save(gi, st, resumes)
            tr.add("scene.checkpoint", c0, time.monotonic(),
                   granule=gi, tile=st.next_tile)

        def interrupted(gi: int, st: SceneState) -> BulkJobReport:
            save_ckpt(gi, st)
            tr.finish()
            return BulkJobReport(
                status="interrupted", granules_done=granules_done,
                tiles_done=tiles_done, stacks_done=stacks_done,
                resumes=resumes, written=written,
                elapsed_s=time.perf_counter() - t_start)

        for gi in range(start_gi, len(self.manifest)):
            spec = self.manifest[gi]
            reader = GranuleReader.open(spec, cfg.tile_h)
            if state is None:
                state = SceneState.fresh(reader.width)
            tr = maybe_trace(process="scene")
            since_ckpt = 0
            while state.next_tile < reader.n_tiles:
                if should_stop is not None and should_stop():
                    return interrupted(gi, state)
                if max_stacks is not None and stacks_done >= max_stacks:
                    return interrupted(gi, state)
                n = min(cfg.stack_tiles, reader.n_tiles - state.next_tile)
                live = tr.enabled
                r0 = time.monotonic()
                f0 = minor_faults() if live else 0
                stack = reader.read_stack(state.next_tile, n)
                r1 = time.monotonic()
                faults = {"minflt": minor_faults() - f0} if live else {}
                tr.add("scene.read", r0, r1, granule=spec.granule_id,
                       tile=state.next_tile, tiles=n, **faults)
                # inside scene.compute: the engine's ingest copy, then the
                # kernels' wait and the runs' copy back (runs_back)
                res = self.runner.engine.analyze_batch(
                    stack, on_stage=lambda _name, i0, i1: tr.add(
                        "scene.ingest", i0, i1, granule=spec.granule_id))
                b0 = time.monotonic()
                runs = res.runs.cpu().numpy()
                c1 = time.monotonic()
                tr.add("scene.runs_back", b0, c1, granule=spec.granule_id)
                tr.add("scene.compute", r1, c1, granule=spec.granule_id,
                       tiles=n)
                self.runner.update(state, stack, runs)
                tr.add("scene.stitch", c1, time.monotonic(),
                       granule=spec.granule_id)
                stacks_done += 1
                tiles_done += n
                since_ckpt += 1
                if self.progress is not None:
                    self.progress.note_tiles(n)
                if since_ckpt >= cfg.checkpoint_every:
                    save_ckpt(gi, state)
                    since_ckpt = 0
            w0 = time.monotonic()
            result = self.runner.finalize(reader, state, self.progress)
            written.append(write_scene_result(self.output_path(spec), result))
            tr.add("scene.write", w0, time.monotonic(),
                   granule=spec.granule_id)
            granules_done += 1
            if self.progress is not None:
                self.progress.note_granule_done()
            # granule boundary checkpoint: a restart resumes *after* the
            # write above (rewriting it would be byte-identical anyway,
            # but this skips the recompute)
            state = (SceneState.fresh(self.manifest[gi + 1].width)
                     if gi + 1 < len(self.manifest) else None)
            save_ckpt(gi + 1,
                      state if state is not None else SceneState.fresh(1))
            tr.finish()
        return BulkJobReport(
            status="completed", granules_done=granules_done,
            tiles_done=tiles_done, stacks_done=stacks_done, resumes=resumes,
            written=written, elapsed_s=time.perf_counter() - t_start)
