"""Plain-PyTorch yConvex Hypergraph (yCHG) construction — the paper's algorithm.

The port's counterpart of ``repro.core.ychg`` and the reference every CUDA
kernel of ``repro_torch.kernels`` is held to, bit for bit, dtypes included.

  step 1: each column j counts its maximal vertical foreground runs,
          ``runs[j]`` = number of rising edges scanning down the column
          (``cut_vertices[j] = 2*runs[j]``: a top and a bottom per run).

  step 2: ``runs[j]`` against ``runs[j-1]`` (column 0's predecessor is 0):
          ``births = max(delta, 0)``, ``deaths = max(-delta, 0)``,
          ``transitions = delta != 0``.

Dtypes follow the JAX package, which runs with x64 off: every count is
int32 and ``transitions`` is bool. ``torch.sum`` of int32 or bool returns
int64, so every reduction here names ``dtype=torch.int32``. Images may be
bool or any integer or float dtype (nonzero = foreground, as
:func:`foreground` decides it), with any leading batch dims.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# float32 exponent field: all zero for +-0 and every subnormal
F32_EXPONENT_BITS = 0x7F800000


def foreground(img: Tensor) -> Tensor:
    """The reference's foreground test, ``img != 0`` as the JAX package
    computes it; a bool tensor of ``img``'s shape.

    XLA on the CPU (and the TPU) flushes float32 subnormals to zero, so a
    float32 value whose exponent bits are all zero (+-0 and every
    subnormal) is background; NaN and +-inf are foreground. float64 is
    rounded to float32 first, as the JAX package does with x64 off.
    float16 and bfloat16 are not flushed: XLA:CPU's compiled compare keeps
    their subnormals (the JAX package's eager ``core.ychg.analyze`` is the
    one exception, for bfloat16; the port follows its jitted and kernel
    paths).
    """
    if img.dtype == torch.bool:
        return img
    if img.dtype == torch.float64:
        img = img.float()
    if img.dtype == torch.float32:
        return (img.view(torch.int32) & F32_EXPONENT_BITS) != 0
    return img != 0


def _shift_down(x: Tensor, dim: int) -> Tensor:
    """``x`` moved one step along ``dim``, the vacated first slot zero."""
    first = torch.zeros_like(x.narrow(dim, 0, min(1, x.shape[dim])))
    return torch.cat([first, x.narrow(dim, 0, max(0, x.shape[dim] - 1))], dim)


def column_runs(img: Tensor) -> Tensor:
    """Step 1: (..., H, W) mask -> (..., W) int32 maximal runs per column."""
    x = foreground(img)
    # a run starts at row i where x[i] & ~x[i-1]; row 0 starts one if set
    rising = x & ~_shift_down(x, -2)
    return torch.sum(rising, dim=-2, dtype=torch.int32)


def hyperedge_transitions(runs: Tensor) -> dict[str, Tensor]:
    """Step 2: (..., W) int32 run counts -> transitions (bool), births and
    deaths (int32), each (..., W); ``runs[-1]`` is taken as 0."""
    delta = runs - _shift_down(runs, -1)
    return {
        "transitions": delta != 0,
        "births": torch.clamp(delta, min=0),
        "deaths": torch.clamp(-delta, min=0),
    }


def hyperedge_count(img: Tensor) -> Tensor:
    """Number of yConvex hyperedges of the ROI (sum of births). (...,) int32."""
    births = hyperedge_transitions(column_runs(img))["births"]
    return torch.sum(births, dim=-1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class YCHGSummary:
    """Full output of the two-step algorithm for one (batch of) image(s)."""

    runs: Tensor           # (..., W) int32  step-1 per-column run counts
    cut_vertices: Tensor   # (..., W) int32  2*runs
    transitions: Tensor    # (..., W) bool   step-2 change signal
    births: Tensor         # (..., W) int32
    deaths: Tensor         # (..., W) int32
    n_hyperedges: Tensor   # (...,)   int32  total births
    n_transitions: Tensor  # (...,)   int32  number of transition columns


def analyze(img: Tensor) -> YCHGSummary:
    """Run both steps. img: (..., H, W) mask on any device."""
    runs = column_runs(img)
    t = hyperedge_transitions(runs)
    return YCHGSummary(
        runs=runs,
        cut_vertices=2 * runs,
        transitions=t["transitions"],
        births=t["births"],
        deaths=t["deaths"],
        n_hyperedges=torch.sum(t["births"], dim=-1, dtype=torch.int32),
        n_transitions=torch.sum(t["transitions"], dim=-1, dtype=torch.int32),
    )


def check_conservation(summary: YCHGSummary) -> Tensor:
    """Invariant: births - deaths telescopes to the final column's run count.

    sum(births) - sum(deaths) == runs[..., -1]. Returns a bool tensor (...,).
    """
    lhs = (torch.sum(summary.births, dim=-1, dtype=torch.int32)
           - torch.sum(summary.deaths, dim=-1, dtype=torch.int32))
    return lhs == summary.runs[..., -1]
