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

``ccl`` and ``denoise`` return full (H, W) canvases, so their crops slice
both axes. Both are pad-invariant by construction (``kernels.ccl`` and
``kernels.denoise`` give the argument), so the slice IS the single-image
answer; for ccl that includes ``n_components``, because zero padding never
starts a component and the canonical re-ranking follows the native
row-major order. Those crops copy the request's region out of the batch:
a view would keep the whole (B, side, side) batch alive in the result
cache.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ychg import YCHGSummary
from repro_torch.engine.engine import YCHGResult, _from_summary, record_event
from repro_torch.engine.ops import CCLResult, DenoiseResult, split_pipeline_key

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


def pad_stack_device(masks: Sequence[torch.Tensor], side: int,
                     batch: int) -> torch.Tensor:
    """:func:`pad_stack` for tensors: a zero-padded (batch, side, side)
    stack of their dtype on their device (the card's or the CPU).

    Only the pad region is zeroed (below and right of each mask, and the
    blank trailing images), and the copies run as bytes, so every dtype
    pads alike, bool and the 64-bit integers included. Runs on the current
    stream.
    """
    first = masks[0]
    item = first.element_size()
    stack = torch.empty((batch, side, side * item), dtype=torch.uint8,
                        device=first.device)
    for i, m in enumerate(masks):
        h, w = m.shape
        if m.numel():
            stack[i, :h, :w * item].copy_(m.contiguous().view(torch.uint8))
        stack[i, :h, w * item:].zero_()
        stack[i, h:].zero_()
    stack[len(masks):].zero_()
    return stack.view(first.dtype)


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


def _copy_region(t: torch.Tensor, row: int, shape: Tuple[int, int]):
    """Image ``row``'s native (h, w) region as a (1, h, w) contiguous copy."""
    h, w = shape
    return t[row:row + 1, :h, :w].clone(memory_format=torch.contiguous_format)


def _crop_ccl_op(batched: CCLResult, row: int,
                 shape: Tuple[int, int]) -> CCLResult:
    lab = _copy_region(batched.labels, row, shape)
    n = batched.n_components[row:row + 1].clone()
    return CCLResult(lab, n, batched=False, event=record_event(lab.device))


def _crop_denoise_op(batched: DenoiseResult, row: int,
                     shape: Tuple[int, int]) -> DenoiseResult:
    img = _copy_region(batched.image, row, shape)
    return DenoiseResult(img, batched=False, event=record_event(img.device))


_CROPS = {
    "ychg": _crop_ychg_op,
    "ccl": _crop_ccl_op,
    "denoise": _crop_denoise_op,
}


def crop_for(op_key: str):
    """The crop-back for an op (or pipeline key — its terminal stage).

    Returns ``(batched_result, row, (h, w)) -> B=1 unbatched result``.
    Raises ``KeyError`` for an op without a registered crop.
    """
    return _CROPS[split_pipeline_key(op_key)[-1]]
