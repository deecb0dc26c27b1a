"""The benchmark's own MODIS-like masks, made from the run's seed.

``snowfield`` follows the program's ``data/modis.py::snowfield`` (smooth
multi-octave noise, bilinearly upsampled and thresholded at a coverage),
written in torch so that a pool of 8192^2 masks is made on the card in a
few large calls. ``striped`` is the paper's knob (b) pattern, vectorised:
a grid of solid rectangles, one y-convex hyperedge each, the first
``n_hyperedges`` cells in row-major order filled. ``patch`` makes a mask's
content unique to its request, so a content-addressed cache never hits.

Every function here is deterministic in its arguments; the harness hands
the same host arrays to the program and to the reference.
"""

from __future__ import annotations

import math

import numpy as np


def snowfield_pool(torch, n: int, res: int, seed: int, *,
                   coverage: float = 0.45, octaves: int = 4,
                   device: str = "cuda") -> np.ndarray:
    """``n`` (res, res) uint8 snow masks as one host array (n, res, res).

    Made on ``device`` with a ``torch.Generator`` seeded from ``seed``; the
    threshold is each mask's own (1 - coverage) quantile, taken as a k-th
    smallest value (``torch.quantile`` refuses inputs this large).
    """
    import torch.nn.functional as F

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    acc = torch.zeros((n, 1, res, res), dtype=torch.float32, device=device)
    for o in range(octaves):
        cells = max(2, res >> (octaves - o + 2))
        coarse = torch.randn((n, 1, cells, cells), generator=gen,
                             device=device, dtype=torch.float32)
        acc += F.interpolate(coarse, size=(res, res), mode="bilinear",
                             align_corners=True) / (2.0 ** o)
    flat = acc.view(n, res * res)
    k = min(res * res, max(1, int(round((1.0 - coverage) * res * res))))
    thr = flat.kthvalue(k, dim=1, keepdim=True).values
    masks = (flat > thr).to(torch.uint8).view(n, res, res)
    out = masks.cpu().numpy()
    del acc, flat, masks
    return out


def striped(res: int, n_hyperedges: int) -> np.ndarray:
    """(res, res) uint8 mask with exactly ``n_hyperedges`` hyperedges.

    The same cells as ``data/modis.py::striped``: a side x side grid with
    side = ceil(sqrt(n)), cell = res // side, each cell's top-left
    (cell - 1)^2 filled, cells taken row by row until n are placed.
    """
    if n_hyperedges < 0:
        raise ValueError(f"n_hyperedges must be >= 0, got {n_hyperedges}")
    img = np.zeros((res, res), np.uint8)
    if n_hyperedges == 0:
        return img
    side = math.isqrt(n_hyperedges - 1) + 1
    if 2 * side > res:
        raise ValueError(
            f"resolution {res} too small for {n_hyperedges} hyperedges")
    cell = res // side
    fill = max(1, cell - 1)
    full_rows, rest = divmod(n_hyperedges, side)
    in_cell = (np.arange(res) % cell) < fill
    rows = in_cell & (np.arange(res) // cell < side)
    cols = rows.copy()
    row_band = np.arange(res) // cell
    col_band = row_band
    # every cell of the first ``full_rows`` bands of rows
    full = rows & (row_band < full_rows)
    img[np.ix_(full, cols)] = 1
    if rest:
        part_rows = rows & (row_band == full_rows)
        part_cols = cols & (col_band < rest)
        img[np.ix_(part_rows, part_cols)] = 1
    return img


def patch_params(seed: int, index: int, shape: tuple[int, int],
                 size: int) -> tuple[int, int, np.ndarray]:
    """(row, col, bits) of request ``index``'s patch: a size x size block
    of random bits at a random place, all drawn from (seed, index)."""
    h, w = shape
    rng = np.random.default_rng([seed % (2**63), index])
    ph, pw = min(size, h), min(size, w)
    r = int(rng.integers(0, h - ph + 1))
    c = int(rng.integers(0, w - pw + 1))
    bits = rng.integers(0, 2, size=(ph, pw), dtype=np.uint8)
    bits[0, 0] = 1  # never an all-zero patch: every request differs
    return r, c, bits


def apply_patch(mask: np.ndarray, seed: int, index: int, size: int) -> None:
    """XOR request ``index``'s patch into ``mask``, in place."""
    r, c, bits = patch_params(seed, index, mask.shape, size)
    mask[r:r + bits.shape[0], c:c + bits.shape[1]] ^= bits


def patched(base: np.ndarray, seed: int, index: int, size: int) -> np.ndarray:
    """A fresh copy of ``base`` with request ``index``'s patch XORed in."""
    out = base.copy()
    apply_patch(out, seed, index, size)
    return out
