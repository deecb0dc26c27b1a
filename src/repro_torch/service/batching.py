"""Shape bucketing: bounded launch shapes, bit-exact crop-back.

The port's counterpart of ``repro.service.batching``. The service never
dispatches a request's native shape: every mask is padded (bottom/right,
with zeros) into a square bucket from a fixed ladder, and every batch is
padded (blank trailing images) to the power-of-two sub-batch rung covering
its occupancy, so the shapes the kernels ever see are
``{(b, side, side) : b in sub_batch_ladder(max_batch), (side, dtype) seen}``.

Why crop-back is bit-exact for yCHG: every output is per *column* —
``runs[j]`` counts rising edges down column j, and the step-2 signals at
column j depend only on columns j-1 and j. Zero rows appended below a
column add no rising edge; zero columns appended to the right leave every
original column untouched (the first pad column may register a death, but
it is cropped away). Cropping the per-column arrays back to the request's
width and recomputing the two int32 reductions over the cropped columns
therefore reproduces ``engine.analyze(mask)`` exactly, dtypes included.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ychg import YCHGSummary
from repro_torch.engine.engine import YCHGResult, _from_summary, record_event
from repro_torch.engine.ops import PIPELINE_SEP

# A bucket is (op key, side, dtype name): masks only stack with their own
# dtype AND their own operator.
Bucket = Tuple[str, int, str]


def pick_bucket_side(shape: Tuple[int, int], sides: Sequence[int]) -> int:
    """Smallest ladder side that holds an (H, W) mask; raises past the top."""
    h, w = shape
    need = max(h, w)
    for side in sides:
        if side >= need:
            return side
    raise ValueError(
        f"mask {shape} exceeds the largest service bucket "
        f"({sides[-1]}x{sides[-1]}); configure larger bucket_sides"
    )


def pad_stack(masks: Sequence[np.ndarray], side: int, batch: int,
              dtype: np.dtype) -> np.ndarray:
    """Stack masks into a zero-padded (batch, side, side) host array."""
    stack = np.zeros((batch, side, side), dtype)
    for i, m in enumerate(masks):
        stack[i, : m.shape[0], : m.shape[1]] = m
    return stack


def crop_result(batched: YCHGResult, row: int, width: int) -> YCHGResult:
    """Request ``row`` of a bucket result, cropped to its native width.

    Returns the B=1 ``batched=False`` view ``engine.analyze`` would have
    produced for the unpadded mask. The per-column planes are views into
    the bucket result (no copy); the two totals are recomputed over the
    cropped columns as int32 sums, the dtypes ``core.ychg.analyze`` uses.
    """
    sl = slice(row, row + 1)
    births = batched.births[sl, :width]
    transitions = batched.transitions[sl, :width]
    summary = YCHGSummary(
        runs=batched.runs[sl, :width],
        cut_vertices=batched.cut_vertices[sl, :width],
        transitions=transitions,
        births=births,
        deaths=batched.deaths[sl, :width],
        n_hyperedges=torch.sum(births, dim=-1, dtype=torch.int32),
        n_transitions=torch.sum(transitions, dim=-1, dtype=torch.int32),
    )
    return _from_summary(summary, batched=False,
                         event=record_event(births.device))


def _crop_ychg_op(batched: YCHGResult, row: int,
                  shape: Tuple[int, int]) -> YCHGResult:
    return crop_result(batched, row, shape[1])


# the ccl and denoise crops come with those ops
_CROPS = {
    "ychg": _crop_ychg_op,
}


def crop_for(op_key: str):
    """The crop-back for an op (or pipeline key — its terminal stage).

    Returns ``(batched_result, row, (h, w)) -> B=1 unbatched result``.
    Raises ``KeyError`` for an op without a registered crop.
    """
    return _CROPS[op_key.split(PIPELINE_SEP)[-1]]
