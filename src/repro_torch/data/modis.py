"""Synthetic MODIS-like binary masks with the paper's experimental knobs.

The paper evaluates on MODIS/Terra snow-cover L3 500m grids [ref 4], varying
(a) resolution at fixed hyperedge structure (cropping/scaling a 21000x21000
scene) and (b) hyperedge count at fixed resolution (147 -> 4,124,319). The
dataset is not redistributable offline, so this module synthesises masks
with exactly those controllables:

  * ``snowfield(res, seed)`` — smooth blobby coverage (low-frequency
    thresholded noise), hyperedge count roughly constant as resolution
    scales (structure scales with the image, like cropping a real scene);
  * ``striped(res, n_hyperedges)`` — deterministic vertical-run pattern
    hitting an exact target hyperedge count (the paper's knob (b)): stripes
    of alternating runs give one hyperedge per (row-band, col-band) cell.

Both return uint8 (H, W) masks. NumPy host-side; the pipeline ships them to
device as uint8 tiles.
"""

from __future__ import annotations

import numpy as np


def snowfield(res: int, seed: int = 0, coverage: float = 0.45,
              octaves: int = 4) -> np.ndarray:
    """Smooth multi-octave noise threshold -> blobby snow-cover-like mask."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((res, res), np.float32)
    for o in range(octaves):
        n = max(2, res >> (octaves - o + 2))
        coarse = rng.standard_normal((n, n)).astype(np.float32)
        # bilinear upsample to res
        yi = np.linspace(0, n - 1, res)
        xi = np.linspace(0, n - 1, res)
        y0 = np.floor(yi).astype(int); y1 = np.minimum(y0 + 1, n - 1)
        x0 = np.floor(xi).astype(int); x1 = np.minimum(x0 + 1, n - 1)
        wy = (yi - y0)[:, None]; wx = (xi - x0)[None, :]
        up = (
            coarse[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
            + coarse[np.ix_(y1, x0)] * wy * (1 - wx)
            + coarse[np.ix_(y0, x1)] * (1 - wy) * wx
            + coarse[np.ix_(y1, x1)] * wy * wx
        )
        acc += up / (2.0**o)
    thr = np.quantile(acc, 1.0 - coverage)
    return (acc > thr).astype(np.uint8)


def striped(res: int, n_hyperedges: int) -> np.ndarray:
    """Deterministic mask with ~exactly ``n_hyperedges`` yConvex hyperedges.

    Grid of (rb x cb) cells, each cell a solid rectangle separated by blank
    rows/cols: each rectangle is one y-convex hyperedge (runs appear at its
    left edge and die at its right edge). rb*cb >= n_hyperedges; surplus
    cells are blanked to hit the target exactly.
    """
    assert n_hyperedges >= 0
    img = np.zeros((res, res), np.uint8)
    if n_hyperedges == 0:
        return img
    side = int(np.ceil(np.sqrt(n_hyperedges)))
    # cell size: at least 2 px (1 filled + 1 blank separator)
    if 2 * side > res:
        raise ValueError(
            f"resolution {res} too small for {n_hyperedges} hyperedges"
        )
    cell = res // side
    fill = max(1, cell - 1)
    placed = 0
    for r in range(side):
        for c in range(side):
            if placed >= n_hyperedges:
                break
            y0, x0 = r * cell, c * cell
            img[y0 : y0 + fill, x0 : x0 + fill] = 1
            placed += 1
    return img


def resolution_series(base: int = 1000, stop: int = 21000, num: int = 8):
    """The paper's knob (a): resolutions from small to the 21000 scene."""
    return [int(r) for r in np.linspace(base, stop, num)]


def hyperedge_series():
    """The paper's knob (b): 147 -> 4,124,319 hyperedges (geometric)."""
    return [147, 1_000, 10_000, 100_000, 1_000_000, 4_124_319]
