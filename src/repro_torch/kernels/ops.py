"""Public wrappers over the yCHG kernels.

  ``colscan_runs``, ``transitions``  the paper's two kernels for one
      (H, W) mask (``kernels.ychg_colscan``): step 1, step 2;
  ``analyze_batch``, ``analyze``  the paper's two-kernel path for a
      (B, H, W) stack or one (H, W) mask: one host call, a step-1 and a
      step-2 launch a mask, step 2 also writing the cut vertices and the
      per-image totals (``kernels.ychg_colscan.ychg_colscan_analyze``), so
      no PyTorch op runs on a mask's result;
  ``analyze_fused``  both steps for a (B, H, W) stack in one kernel call
      (``kernels.ychg_fused``).

The routing rule is the JAX package's (``repro/kernels/ops.py``): the
split-H kernel runs when ``H * block_w`` exceeds ``vmem_budget``, so the
port routes every mask exactly as the reference does. That budget is a
TPU VMEM size and means nothing on Hopper, where the choice is one of
occupancy; retuning the rule is queued in ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.ychg import YCHGSummary
from repro_torch.kernels import ychg_colscan as _c
from repro_torch.kernels import ychg_fused as _f

Tensor = torch.Tensor

# raw int8 tile budget (bytes) past which the reference streams over H
_FULL_COLUMN_VMEM_BUDGET = 4 * 1024 * 1024


def colscan_runs(
    img: Tensor,
    *,
    block_w: int = 128,
    block_h: int = 2048,
    vmem_budget: int | None = None,
) -> Tensor:
    """Step 1: per-column maximal-run counts, (H, W) mask -> (W,) int32.

    ``block_w`` enters only the routing rule; ``block_h`` is the split-H
    kernel's segment height. A non-contiguous input is copied first.
    """
    if vmem_budget is None:
        vmem_budget = _FULL_COLUMN_VMEM_BUDGET
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got {tuple(img.shape)}")
    h, _ = img.shape
    img = img.contiguous()
    if h * block_w > vmem_budget:
        return _c.ychg_colscan_splith(img, block_h=block_h)
    return _c.ychg_colscan_full(img)


def transitions(runs: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Step 2: (W,) int32 run counts -> (transitions bool, births int32,
    deaths int32)."""
    out = _c.ychg_diff(runs.contiguous())
    return out["transitions"], out["births"], out["deaths"]


def analyze_batch(
    imgs: Tensor,
    *,
    block_w: int = 128,
    block_h: int = 2048,
    vmem_budget: int | None = None,
) -> Dict[str, Tensor]:
    """Both steps for a (B, H, W) stack on the two-kernel path, one host
    call for the stack; the seven fields of ``core.ychg.analyze`` as a dict
    of (B, W) planes and (B,) int32 totals.

    Step 1 takes the route ``colscan_runs`` takes for one mask of the
    stack. A non-contiguous input is copied first.
    """
    if vmem_budget is None:
        vmem_budget = _FULL_COLUMN_VMEM_BUDGET
    if imgs.ndim != 3:
        raise ValueError(f"expected a (B, H, W) stack, got "
                         f"{tuple(imgs.shape)}")
    split = imgs.shape[1] * block_w > vmem_budget
    return _c.ychg_colscan_analyze(imgs.contiguous(),
                                   block_h=block_h if split else None)


def analyze(
    img: Tensor,
    *,
    block_w: int = 128,
    block_h: int = 2048,
    vmem_budget: int | None = None,
) -> Dict[str, Tensor]:
    """Both steps for one (H, W) mask, one kernel each (``analyze_batch``
    with B = 1); the seven fields of ``core.ychg.analyze`` as a dict."""
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got {tuple(img.shape)}")
    out = analyze_batch(img[None], block_w=block_w, block_h=block_h,
                        vmem_budget=vmem_budget)
    return {k: v[0] for k, v in out.items()}


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
