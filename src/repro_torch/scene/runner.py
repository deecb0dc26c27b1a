"""SceneRunner — tile-stack streaming analysis with exact seam stitching.

The port's counterpart of ``repro.scene.runner``.

Why tiling is exact here (the stitch invariant the tests pin): yCHG step 1
is a per-column count of rising edges down the scene. Split the scene into
full-width strips and count each strip independently, and every run that
*crosses* a strip boundary is counted twice — once by the strip that ends
it and once by the strip that starts it, because the lower strip sees its
first row with no predecessor. The overcount at each seam is exactly

    seam[j] = (bottom row of upper strip)[j] foreground
              AND (top row of lower strip)[j] foreground

so ``scene_runs = sum(strip_runs) - sum(seams)`` reproduces the
whole-scene count **bit for bit** (pure int32 arithmetic, no tolerance).
This is the split-H kernels' row-above identity lifted from H segments to
host-scale strips; step 2 (births/deaths/transitions) is then computed
once from the stitched run vector with the same ``core.ychg`` formulas the
engine backends are held bit-identical to, so the full seven-field result
equals a single whole-scene ``engine.analyze`` call — dtypes included.

Foreground at the seams is :func:`repro_torch.core.ychg.foreground`, the
test every backend applies: float32 subnormals are background. (The
reference tests its seam rows with NumPy's ``!= 0``, which keeps them; the
two agree on every mask but a float32 one with subnormals in a seam row,
where only the port's stitch still equals its whole-scene call.)

The runner streams (stack_tiles, tile_h, W) stacks through
``engine.analyze_stream``, which reads and ingests stack n+1 before it
hands back result n, so the host reads strips while the card runs the
previous stack; the ingest itself is a synchronous pageable copy for now,
so copies do not overlap kernels. Each stack's run counts are copied to
the host once. Inside each strip, the engine's
own routing rule picks the full-column or the split-H kernel. State
between stacks is three small host arrays (:class:`SceneState`), which is
what makes bulk jobs checkpointable: a resumed job restores the state and
continues from the next tile row.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ychg
from repro_torch.engine import Engine
from repro_torch.obs import maybe_trace
from repro_torch.scene.granule import GranuleReader
from repro_torch.scene.result import SceneResult

DEFAULT_STACK_TILES = 4


def _foreground(rows: np.ndarray) -> np.ndarray:
    """Host bool array: ``core.ychg.foreground`` of a host array."""
    return ychg.foreground(torch.from_numpy(np.array(rows))).numpy()


# --------------------------------------------------------------- progress


@dataclasses.dataclass(frozen=True)
class SceneProgressSnapshot:
    """Point-in-time view of a scene/bulk job (immutable)."""

    tiles_done: int = 0
    tiles_total: int = 0
    granules_done: int = 0
    granules_total: int = 0
    resumes: int = 0
    stitch_time_s: float = 0.0


class SceneProgress:
    """Thread-safe progress sink shared by runner, bulk job, and metrics.

    Attach to a :class:`repro_torch.service.YCHGService` via
    ``service.attach_scene_progress(progress)`` and the counters surface
    in ``ServiceMetrics`` and on the frontend ``/metrics`` page.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._snap = SceneProgressSnapshot()

    def set_totals(self, *, tiles: int, granules: int) -> None:
        with self._lock:
            self._snap = dataclasses.replace(
                self._snap, tiles_total=tiles, granules_total=granules)

    def note_tiles(self, n: int) -> None:
        with self._lock:
            self._snap = dataclasses.replace(
                self._snap, tiles_done=self._snap.tiles_done + n)

    def note_granule_done(self) -> None:
        with self._lock:
            self._snap = dataclasses.replace(
                self._snap, granules_done=self._snap.granules_done + 1)

    def note_resume(self) -> None:
        with self._lock:
            self._snap = dataclasses.replace(
                self._snap, resumes=self._snap.resumes + 1)

    def note_stitch(self, dt_s: float) -> None:
        with self._lock:
            self._snap = dataclasses.replace(
                self._snap, stitch_time_s=self._snap.stitch_time_s + dt_s)

    def snapshot(self) -> SceneProgressSnapshot:
        with self._lock:
            return self._snap


# ------------------------------------------------------------------ state


@dataclasses.dataclass
class SceneState:
    """Resumable per-granule accumulator: everything a restart needs.

    ``runs`` is the seam-corrected per-column run count over tiles
    ``[0, next_tile)``; ``prev_bottom`` is the binarised last real row of
    the most recent strip (the carry row for the next seam). All three
    are plain host arrays, so the state round-trips through
    :class:`repro_torch.checkpoint.Checkpointer` as a tree.
    """

    next_tile: int
    runs: np.ndarray         # (W,) int32
    prev_bottom: np.ndarray  # (W,) uint8 (0/1)

    @classmethod
    def fresh(cls, width: int) -> "SceneState":
        return cls(next_tile=0, runs=np.zeros(width, np.int32),
                   prev_bottom=np.zeros(width, np.uint8))


def seam_joins(bottom_row: np.ndarray, top_row: np.ndarray) -> np.ndarray:
    """(W,) int32 count of runs continuing across one strip boundary."""
    return (_foreground(bottom_row) & _foreground(top_row)).astype(np.int32)


def stitch_tile_runs(tile_runs: Sequence[np.ndarray],
                     tiles: Sequence[np.ndarray]) -> np.ndarray:
    """Stitch per-strip run counts analysed *independently* (no carry).

    ``tile_runs[i]`` must be the (W,) step-1 output for strip ``tiles[i]``
    — e.g. per-tile results replayed through the HTTP front end — and the
    strips must be consecutive and overlap-free. Returns the whole-scene
    (W,) int32 run vector, bit-identical to analysing the unsplit scene.
    """
    if len(tile_runs) != len(tiles):
        raise ValueError(f"{len(tile_runs)} run vectors for "
                         f"{len(tiles)} tiles")
    total = np.zeros_like(np.asarray(tile_runs[0], np.int32))
    prev_bottom: Optional[np.ndarray] = None
    for runs, tile in zip(tile_runs, tiles):
        tile = np.asarray(tile)
        total += np.asarray(runs, np.int32)
        if prev_bottom is not None:
            total -= seam_joins(prev_bottom, tile[0])
        prev_bottom = tile[-1]
    return total


# ----------------------------------------------------------------- runner


class SceneRunner:
    """Streams one granule's tile stacks through an engine and stitches.

    The engine is used as-is: its backend policy and tile sizes apply per
    stack. ``stack_tiles`` strips batch into one ``(stack_tiles, tile_h,
    W)`` device computation. ``SceneRunner()`` builds ``Engine()``, which
    runs on the card and raises where there is none.
    """

    def __init__(self, engine: Optional[Engine] = None, *,
                 stack_tiles: int = DEFAULT_STACK_TILES):
        if stack_tiles < 1:
            raise ValueError(f"stack_tiles must be >= 1, got {stack_tiles}")
        self.engine = engine if engine is not None else Engine()
        self.stack_tiles = stack_tiles

    # -- incremental API (what BulkJob drives) ------------------------------

    def update(self, state: SceneState, stack: np.ndarray,
               runs_b: np.ndarray) -> SceneState:
        """Fold one analysed stack into the accumulator (in place).

        ``stack`` is the (b, tile_h, W) host strips; ``runs_b`` the
        matching (b, W) step-1 output. Seam corrections use the strips'
        own boundary rows, so the math is exact whatever ``b`` was.
        """
        stack = np.asarray(stack)
        runs_b = np.asarray(runs_b)
        b = stack.shape[0]
        tops = _foreground(stack[:, 0, :])
        bottoms = _foreground(stack[:, -1, :])
        prevs = np.concatenate(
            [(state.prev_bottom != 0)[None], bottoms[:-1]], axis=0)
        seams = tops & prevs
        state.runs += (runs_b.sum(axis=0, dtype=np.int32)
                       - seams.sum(axis=0, dtype=np.int32))
        state.prev_bottom = bottoms[-1].astype(np.uint8)
        state.next_tile += b
        return state

    def finalize(self, reader: GranuleReader, state: SceneState,
                 progress: Optional[SceneProgress] = None) -> SceneResult:
        """Stitched runs -> the full seven-field scene result.

        Step 2 runs once over the stitched (W,) vector with the exact
        ``core.ychg`` formulas (dtypes included), so the output equals a
        single whole-scene ``engine.analyze`` call bit for bit.
        """
        if state.next_tile != reader.n_tiles:
            raise ValueError(
                f"granule {reader.granule_id!r}: finalize at tile "
                f"{state.next_tile} of {reader.n_tiles}")
        t0 = time.perf_counter()
        runs = torch.from_numpy(np.ascontiguousarray(state.runs, np.int32))
        t = ychg.hyperedge_transitions(runs)
        result = SceneResult(
            granule_id=reader.granule_id,
            height=reader.height,
            width=reader.width,
            tile_h=reader.tile_h,
            n_tiles=reader.n_tiles,
            runs=runs.numpy().copy(),
            cut_vertices=(2 * runs).numpy(),
            transitions=t["transitions"].numpy(),
            births=t["births"].numpy(),
            deaths=t["deaths"].numpy(),
            n_hyperedges=torch.sum(t["births"], dim=-1,
                                   dtype=torch.int32).numpy(),
            n_transitions=torch.sum(t["transitions"], dim=-1,
                                    dtype=torch.int32).numpy(),
        )
        if progress is not None:
            progress.note_stitch(time.perf_counter() - t0)
        return result

    # -- one-call streaming API ---------------------------------------------

    def analyze_scene(self, reader: GranuleReader, *,
                      progress: Optional[SceneProgress] = None,
                      state: Optional[SceneState] = None,
                      trace=None) -> SceneResult:
        """Stream the whole granule (from ``state`` if given) and stitch.

        Stacks flow through ``engine.analyze_stream``. When tracing is on,
        each stack leaves ``scene.read`` / ``scene.compute`` (stream wait)
        / ``scene.stitch`` spans plus one ``scene.finalize`` span on the
        trace.
        """
        tr = trace if trace is not None else maybe_trace(process="scene")
        own = trace is None
        state = state if state is not None else SceneState.fresh(reader.width)
        pending: "collections.deque[np.ndarray]" = collections.deque()

        def stacks() -> Iterator[np.ndarray]:
            t = state.next_tile
            while t < reader.n_tiles:
                n = min(self.stack_tiles, reader.n_tiles - t)
                r0 = time.monotonic()
                s = reader.read_stack(t, n)
                tr.add("scene.read", r0, time.monotonic(),
                       granule=reader.granule_id, tile=t, tiles=n)
                pending.append(s)
                yield s
                t += n

        try:
            t_wait = time.monotonic()
            for res in self.engine.analyze_stream(stacks()):
                runs = res.runs.cpu().numpy()  # one copy to the host a stack
                t_got = time.monotonic()
                stack = pending.popleft()
                tr.add("scene.compute", t_wait, t_got,
                       granule=reader.granule_id, tiles=stack.shape[0])
                s0 = time.monotonic()
                self.update(state, stack, runs)
                s1 = time.monotonic()
                tr.add("scene.stitch", s0, s1, granule=reader.granule_id)
                if progress is not None:
                    progress.note_stitch(s1 - s0)
                    progress.note_tiles(stack.shape[0])
                t_wait = time.monotonic()
            f0 = time.monotonic()
            result = self.finalize(reader, state, progress)
            tr.add("scene.finalize", f0, time.monotonic(),
                   granule=reader.granule_id)
            return result
        finally:
            if own:
                tr.finish()
