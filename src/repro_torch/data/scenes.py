"""Arbitrarily large synthetic MODIS-like scenes, readable by row window.

``modis.snowfield`` materialises a whole ``res x res`` mask at once (its
threshold is a global quantile), which caps it at what fits in host RAM.
Scene-scale streaming needs the opposite contract: a granule that may be
tens of gigapixels, of which a reader only ever touches a few tile rows at
a time. So every pixel here is a **pure function of (seed, y, x)** — an
integer-hashed value lattice on a ``cell``-pitch grid, bilinearly
interpolated and thresholded — which gives the same blobby snow-cover-like
structure at cell scale while guaranteeing exact row-decomposability:

    scene_rows(h, w, 0, h, seed=s) == vstack(scene_rows(h, w, a, b, seed=s)
                                             for consecutive [a, b) windows)

bit for bit, whatever the windowing. That identity is what makes tiled
scene analysis (``repro_torch.scene``) checkpointable and resumable: a
restarted job re-reads exactly the rows it needs and nothing else.

A copy of ``repro.data.scenes`` (the port imports nothing of the JAX
package): the same constants and arithmetic, so the same spec gives the
same pixels in either package, and a job begun in one resumes in the other.
"""

from __future__ import annotations

import numpy as np

# splitmix64-style mixing constants (fixed forever: scene content is part
# of the resume contract — changing these changes every synthetic granule)
_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xC2B2AE3D27D4EB4F)
_C3 = np.uint64(0xD6E8FEB86659FD93)
_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)


def _lattice(seed: int, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Deterministic uniform-ish values in [0, 1) on the (ys x xs) lattice."""
    with np.errstate(over="ignore"):
        y = ys.astype(np.uint64)[:, None]
        x = xs.astype(np.uint64)[None, :]
        h = y * _C1 + x * _C2 + np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * _C3
        h ^= h >> np.uint64(33)
        h *= _M1
        h ^= h >> np.uint64(33)
        h *= _M2
        h ^= h >> np.uint64(33)
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def scene_rows(height: int, width: int, row0: int, row1: int, *,
               seed: int = 0, cell: int = 64, coverage: float = 0.45,
               dtype=np.uint8) -> np.ndarray:
    """Rows ``[row0, row1)`` of the synthetic scene -> (row1-row0, width).

    Pure in (seed, cell, coverage, coordinates): windowed reads compose
    exactly, and ``height`` only bounds the valid row range (content does
    not depend on it, so cropping a scene is the same as reading less).
    """
    if not (0 <= row0 <= row1 <= height):
        raise ValueError(
            f"row window [{row0}, {row1}) outside scene height {height}")
    if cell < 1:
        raise ValueError(f"cell must be >= 1, got {cell}")
    if row0 == row1:
        return np.zeros((0, width), dtype)
    ys = np.arange(row0, row1)
    xs = np.arange(width)
    cy0, fy = ys // cell, ((ys % cell) / cell)[:, None]
    cx0, fx = xs // cell, ((xs % cell) / cell)[None, :]
    v = (_lattice(seed, cy0, cx0) * (1 - fy) * (1 - fx)
         + _lattice(seed, cy0, cx0 + 1) * (1 - fy) * fx
         + _lattice(seed, cy0 + 1, cx0) * fy * (1 - fx)
         + _lattice(seed, cy0 + 1, cx0 + 1) * fy * fx)
    return (v > (1.0 - coverage)).astype(dtype)


def scene(height: int, width: int, *, seed: int = 0, cell: int = 64,
          coverage: float = 0.45, dtype=np.uint8) -> np.ndarray:
    """Materialise the whole (height, width) scene (small scenes / tests)."""
    return scene_rows(height, width, 0, height, seed=seed, cell=cell,
                      coverage=coverage, dtype=dtype)
