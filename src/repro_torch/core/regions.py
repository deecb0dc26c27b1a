"""Beyond-paper: materialise the yConvex hyperedges (not just count them).

The poster stops at the per-column counts and the transition signal; the
underlying yCHG model papers [1,3] need the actual hyperedges (maximal
y-convex sub-regions) for contour tracking and area estimation. This module
builds a y-convex decomposition by chaining column runs:

  * every column's foreground splits into maximal runs (intervals);
  * run A (column j) and run B (column j+1) are 4-connected iff their row
    intervals overlap;
  * a hyperedge is a maximal chain of one-to-one connected runs across
    consecutive columns. Chains break at branch points (a run with 2+ right
    neighbours) and merge points (2+ left neighbours) — exactly the columns
    the paper's step-2 transition signal flags, plus same-count reconnection
    events the count-based signal cannot see (documented limitation of the
    poster's simplification; tests cover both).

This is a greedy decomposition (splits at every branch/merge), valid but not
necessarily minimal. Host-side NumPy: this is a data-plane op on mask tiles,
not a device hot loop.

The port's copy of ``repro.core.regions``. Every entry point takes a NumPy
array, or a tensor on any device, which is copied to the host once at
entry (``.cpu().numpy()``, so of a dtype NumPy has). Foreground is NumPy's
``!= 0``, as in the JAX package's copy: a float32 subnormal is
foreground here, as in ``core.serial``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Run:
    col: int
    row_start: int  # inclusive
    row_end: int    # exclusive


@dataclasses.dataclass(frozen=True)
class Hyperedge:
    """A maximal y-convex chain of runs over consecutive columns."""

    runs: Tuple[Run, ...]

    @property
    def col_span(self) -> Tuple[int, int]:
        return self.runs[0].col, self.runs[-1].col + 1

    @property
    def area(self) -> int:
        return sum(r.row_end - r.row_start for r in self.runs)


def _host(img) -> np.ndarray:
    """``img`` as a NumPy array: a tensor copied to the host once."""
    if isinstance(img, torch.Tensor):
        return img.cpu().numpy()
    return np.asarray(img)


def extract_runs(img: np.ndarray) -> List[List[Run]]:
    """Per-column maximal foreground runs. img: (H, W) mask."""
    x = _host(img) != 0
    h, w = x.shape
    out: List[List[Run]] = []
    padded = np.zeros((h + 2,), dtype=bool)
    for j in range(w):
        padded[1:-1] = x[:, j]
        d = np.diff(padded.astype(np.int8))
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        out.append([Run(j, int(s), int(e)) for s, e in zip(starts, ends)])
    return out


def _overlaps(a: Run, b: Run) -> bool:
    return a.row_start < b.row_end and b.row_start < a.row_end


def decompose(img: np.ndarray) -> List[Hyperedge]:
    """Greedy y-convex decomposition by chaining one-to-one connected runs."""
    cols = extract_runs(_host(img))
    w = len(cols)
    # neighbour counts between column j and j+1
    edges: List[Hyperedge] = []
    # open chains: list of (list_of_runs) whose tail is in column j-1
    open_chains: List[List[Run]] = []
    for j in range(w):
        runs_here = cols[j]
        prev_runs = cols[j - 1] if j > 0 else []
        # adjacency between prev column runs and this column's runs
        right_nbrs = {i: [] for i in range(len(prev_runs))}
        left_nbrs = {k: [] for k in range(len(runs_here))}
        for i, a in enumerate(prev_runs):
            for k, b in enumerate(runs_here):
                if _overlaps(a, b):
                    right_nbrs[i].append(k)
                    left_nbrs[k].append(i)
        # map: open chain tail run -> index in prev_runs
        tail_index = {}
        for ci, chain in enumerate(open_chains):
            for i, a in enumerate(prev_runs):
                if chain[-1] is a:
                    tail_index[ci] = i
        next_open: List[List[Run]] = []
        consumed = set()
        for ci, chain in enumerate(open_chains):
            i = tail_index.get(ci)
            ext = None
            if i is not None and len(right_nbrs[i]) == 1:
                k = right_nbrs[i][0]
                if len(left_nbrs[k]) == 1:
                    ext = k
            if ext is not None and ext not in consumed:
                chain.append(runs_here[ext])
                consumed.add(ext)
                next_open.append(chain)
            else:
                edges.append(Hyperedge(tuple(chain)))
        for k, r in enumerate(runs_here):
            if k not in consumed:
                next_open.append([r])
        open_chains = next_open
    for chain in open_chains:
        edges.append(Hyperedge(tuple(chain)))
    return edges


def label_image(img: np.ndarray) -> Tuple[np.ndarray, int]:
    """(H, W) int32 label map (0 = background, k = hyperedge k) and the count."""
    x = _host(img)
    labels = np.zeros(x.shape, dtype=np.int32)
    edges = decompose(x)
    for idx, e in enumerate(edges, start=1):
        for r in e.runs:
            labels[r.row_start : r.row_end, r.col] = idx
    return labels, len(edges)


def total_area(img: np.ndarray) -> int:
    """Area of the ROI via y-convex decomposition (ref [3]'s application)."""
    return sum(e.area for e in decompose(_host(img)))
