"""The paper's serial CPU baseline, kept deliberately faithful.

The ICS'13 poster compares against "the existing serial implementation" on a
2-core i5-480M: a scalar scan that walks every column top-to-bottom counting
cut-vertices, then a second scalar pass comparing neighbour columns. We keep
two baselines:

  * ``analyze_scalar``  — honest per-pixel Python loops (the shape of the
    original C/C++ serial code; dominated by interpreter overhead here, so
    benchmarks report it separately and never use it for large images).
  * ``analyze_numpy``   — the same serial algorithm expressed with NumPy
    column sweeps (a fair single-core CPU baseline for the speedup curves;
    this is what benchmarks/run.py's "serial" series means).

Both return plain Python/NumPy values and must agree exactly with the JAX
package's ``repro.core.serial`` — tests enforce this. The port keeps its
own copy (it imports nothing of the JAX package), NumPy only.

Unlike the device paths, NumPy keeps float32 subnormals: a subnormal
pixel is foreground here, as it is in the JAX package's ``serial`` and
``scalar`` backends, while ``core.ychg.foreground`` (like XLA) flushes it
to background.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def column_runs_scalar(img: np.ndarray) -> np.ndarray:
    """Scalar step 1: loop columns, loop rows, count rising edges."""
    img = np.asarray(img)
    h, w = img.shape
    runs = np.zeros(w, dtype=np.int32)
    for j in range(w):
        prev = 0
        count = 0
        for i in range(h):
            cur = 1 if img[i, j] else 0
            if cur and not prev:
                count += 1
            prev = cur
        runs[j] = count
    return runs


def _transitions(runs: np.ndarray) -> Dict[str, np.ndarray]:
    """Scalar-equivalent step 2 (vectorised; O(W) either way)."""
    prev = np.concatenate([[0], runs[:-1]]).astype(np.int32)
    delta = runs.astype(np.int32) - prev
    return {
        "transitions": delta != 0,
        "births": np.maximum(delta, 0),
        "deaths": np.maximum(-delta, 0),
    }


def analyze_scalar(img: np.ndarray) -> Dict[str, np.ndarray]:
    runs = column_runs_scalar(img)
    t = _transitions(runs)
    return _pack(runs, t)


def column_runs_numpy(img: np.ndarray) -> np.ndarray:
    """Serial algorithm, NumPy-expressed (single core): one pass over the image."""
    x = np.asarray(img) != 0
    prev = np.zeros_like(x)
    prev[1:, :] = x[:-1, :]
    rising = x & ~prev
    return rising.sum(axis=0).astype(np.int32)


def analyze_numpy(img: np.ndarray) -> Dict[str, np.ndarray]:
    runs = column_runs_numpy(img)
    t = _transitions(runs)
    return _pack(runs, t)


def _pack(runs: np.ndarray, t: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {
        "runs": runs,
        "cut_vertices": 2 * runs,
        "transitions": t["transitions"],
        "births": t["births"],
        "deaths": t["deaths"],
        "n_hyperedges": np.int32(t["births"].sum()),
        "n_transitions": np.int32(t["transitions"].sum()),
    }
