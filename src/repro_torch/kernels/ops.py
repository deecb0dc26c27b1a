"""Public wrapper over the fused yCHG kernels: ``analyze_fused``.

The routing rule is the JAX package's (``repro/kernels/ops.py``): the
split-H kernel runs when ``H * block_w`` exceeds ``vmem_budget``, so the
port routes every stack exactly as the reference does. That budget is a
TPU VMEM size and means nothing on Hopper, where the choice is one of
occupancy; retuning the rule is queued in ``ROADMAP.md``.
"""

from __future__ import annotations

import torch

from repro_torch.core.ychg import YCHGSummary
from repro_torch.kernels import ychg_fused as _f

Tensor = torch.Tensor

# raw int8 tile budget (bytes) past which the reference streams over H
_FULL_COLUMN_VMEM_BUDGET = 4 * 1024 * 1024


def _empty_summary(w: int, device: torch.device) -> YCHGSummary:
    plane = torch.empty((0, w), dtype=torch.int32, device=device)
    total = torch.empty((0,), dtype=torch.int32, device=device)
    return YCHGSummary(
        runs=plane, cut_vertices=plane.clone(),
        transitions=torch.empty((0, w), dtype=torch.bool, device=device),
        births=plane.clone(), deaths=plane.clone(),
        n_hyperedges=total, n_transitions=total.clone())


def analyze_fused(
    img: Tensor,
    *,
    block_w: int = 128,
    block_h: int = 2048,
    vmem_budget: int | None = None,
) -> YCHGSummary:
    """Both yCHG steps for an (H, W) mask or a (B, H, W) stack in one kernel
    call; bit-identical to ``core.ychg.analyze`` (dtypes, shapes, values).

    ``block_w`` enters only the routing rule; ``block_h`` is the split-H
    kernel's segment height. A non-contiguous input is copied first.
    """
    if vmem_budget is None:
        vmem_budget = _FULL_COLUMN_VMEM_BUDGET
    squeeze = img.ndim == 2
    imgs = img[None] if squeeze else img
    if imgs.ndim != 3:
        raise ValueError(f"expected (H, W) or (B, H, W) mask, got "
                         f"{tuple(img.shape)}")
    b, h, w = imgs.shape
    if b == 0:  # nothing to launch
        return _empty_summary(w, imgs.device)
    imgs = imgs.contiguous()
    if h * block_w > vmem_budget:
        out = _f.ychg_fused_splith(imgs, block_h=block_h)
    else:
        out = _f.ychg_fused_full(imgs)
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return YCHGSummary(
        runs=out["runs"],
        cut_vertices=2 * out["runs"],
        transitions=out["transitions"],
        births=out["births"],
        deaths=out["deaths"],
        n_hyperedges=out["n_hyperedges"],
        n_transitions=out["n_transitions"],
    )
