"""The plain reference: yCHG in NumPy, written from the definition.

For an (H, W) mask, foreground is ``mask != 0`` (the benchmark's masks are
uint8, where every test of foreground agrees).

  runs[j]          maximal vertical foreground runs in column j: the rows
                   i where column j is foreground and row i - 1 is not
                   (row -1 counts as background)
  cut_vertices[j]  2 * runs[j]
  delta[j]         runs[j] - runs[j - 1], with runs[-1] taken as 0
  births[j]        max(delta[j], 0)
  deaths[j]        max(-delta[j], 0)
  transitions[j]   delta[j] != 0
  n_hyperedges     sum of births
  n_transitions    number of columns with a transition

Counts are int32, ``transitions`` bool, the totals 0-d int32 arrays. Masks
are read in blocks of rows, so a memory-mapped granule never has to be
whole in memory. This module imports nothing of the program.

The controls depart from the definition by a step that would tempt a
faster program: ``row_step=2`` reads every other row (half the bytes);
``strip_h`` counts each strip of rows on its own and drops the seam
correction that stitches strips into a granule.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
          "n_hyperedges", "n_transitions")
BLOCK_ROWS = 1024


def column_runs(mask: np.ndarray, *, row_step: int = 1,
                strip_h: Optional[int] = None,
                block_rows: int = BLOCK_ROWS) -> np.ndarray:
    """(W,) int32 maximal foreground runs of each column of ``mask``.

    ``row_step`` and ``strip_h`` serve the controls only: every
    ``row_step``-th row alone, or strips of ``strip_h`` rows each counted
    as if the row above it were background (no seam correction)."""
    h, w = mask.shape
    runs = np.zeros(w, np.int64)
    step = block_rows * row_step
    strip = strip_h or h
    for s0 in range(0, h, strip):
        s1 = min(h, s0 + strip)
        prev = np.zeros(w, bool)
        for r0 in range(s0, s1, step):
            fg = np.asarray(mask[r0:min(s1, r0 + step):row_step]) != 0
            runs += fg[0] & ~prev
            if fg.shape[0] > 1:
                runs += np.count_nonzero(fg[1:] & ~fg[:-1], axis=0)
            prev = fg[-1]
    return runs.astype(np.int32)


def from_runs(runs: np.ndarray) -> Dict[str, np.ndarray]:
    """Every field from the (W,) int32 run counts."""
    runs = np.asarray(runs, np.int32)
    delta = runs - np.concatenate([np.zeros(1, np.int32), runs[:-1]])
    births = np.maximum(delta, 0).astype(np.int32)
    deaths = np.maximum(-delta, 0).astype(np.int32)
    transitions = delta != 0
    return {
        "runs": runs,
        "cut_vertices": (2 * runs).astype(np.int32),
        "transitions": transitions,
        "births": births,
        "deaths": deaths,
        "n_hyperedges": np.array(births.sum(dtype=np.int64), np.int32),
        "n_transitions": np.array(np.count_nonzero(transitions), np.int32),
    }


def analyze(mask: np.ndarray, **control) -> Dict[str, np.ndarray]:
    """Every field of one (H, W) mask; ``control`` as ``column_runs``
    takes it."""
    if mask.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got {mask.shape}")
    return from_runs(column_runs(mask, **control))


def mismatches(got: Dict[str, np.ndarray],
               want: Dict[str, np.ndarray]) -> int:
    """Elements of ``got`` that differ from ``want``, over every field. A
    field that is missing, or has another shape or dtype, counts as wrong
    in every element of ``want``'s."""
    wrong = 0
    for f in FIELDS:
        w = want[f]
        g = got.get(f) if isinstance(got, dict) else None
        if g is None:
            wrong += max(1, w.size)
            continue
        g = np.asarray(g)
        if g.shape != w.shape or g.dtype != w.dtype:
            wrong += max(1, w.size)
            continue
        wrong += int(np.count_nonzero(g != w))
    return wrong
