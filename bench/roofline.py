"""The yardstick of the kernels: published peaks and the work of each op.

The published rates of one NVIDIA H100 SXM (data sheet, dense, at its
full 700 W power limit), and the bytes and operations an op needs from its
shapes alone: each input byte read once, each output byte written once,
whatever kernel implements the op. Copied from ``launch/roofline.py``'s
``*_work`` counts and frozen here, so that a change to the program cannot
change what its kernels are measured against.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES_PER_S = 3.35e12
# simple int32 operations: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# ychg: compare, and-not, add a pixel
YCHG_OPS_PER_PIXEL = 3
# ychg's step 2: subtract, compare, two max, negate, the doubled cut
# vertex and the two sums of the totals, a column
YCHG_OPS_PER_COLUMN = 8

Work = Tuple[int, int]   # (bytes, int32 operations)


def ychg_work(b: int, h: int, w: int, itemsize: int) -> Work:
    """Op ``ychg`` on a (B, H, W) stack: the stack read once; runs, cut
    vertices, births and deaths (int32) and transitions (bool) a column,
    and the two int32 totals an image, written once."""
    n = b * h * w
    return (n * itemsize + b * w * (4 * 4 + 1) + b * 2 * 4,
            YCHG_OPS_PER_PIXEL * n + YCHG_OPS_PER_COLUMN * b * w)


def least_s(nbytes: float, ops: float) -> float:
    """The least seconds the card needs for ``nbytes`` and ``ops``."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S)
