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
:func:`foreground` decides it), with any leading batch dims. 64-bit
integers keep their low 32 bits (:func:`narrow_wide_ints`), as the JAX
package's ``jnp.asarray`` does with x64 off.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# float32 exponent field: all zero for +-0 and every subnormal
F32_EXPONENT_BITS = 0x7F800000
# 64-bit integer dtypes and the 32-bit ones jnp.asarray reduces them to
_NARROWED = {torch.int64: torch.int32, torch.uint64: torch.uint32}


def narrow_wide_ints(x: Tensor) -> Tensor:
    """int64 as int32 and uint64 as uint32, each keeping its low 32 bits, as
    ``jnp.asarray`` reduces them with x64 off (2**32 becomes 0, 2**40 + 1
    becomes 1); any other tensor is returned as it is. Both casts wrap, on
    the CPU and on the card (torch 2.11 on an H100 casts uint64 to uint32
    and compares and converts uint32 on CUDA tensors).
    """
    if x.dtype in _NARROWED:
        return x.to(_NARROWED[x.dtype])
    return x


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
    paths). int64 and uint64 are tested on their low 32 bits
    (:func:`narrow_wide_ints`).
    """
    if img.dtype == torch.bool:
        return img
    img = narrow_wide_ints(img)
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


# The layout of each YCHGSummary field for a batch of B images W wide.
FIELD_LAYOUT = {"runs": "int32 plane", "cut_vertices": "int32 plane",
                "transitions": "bool plane", "births": "int32 plane",
                "deaths": "int32 plane", "n_hyperedges": "int32 total",
                "n_transitions": "int32 total"}


def zeroed_outputs(fields: tuple[str, ...], b: int, w: int,
                   device: torch.device) -> dict[str, Tensor]:
    """The named summary fields for B images W wide, in the order given, as
    views of one zeroed buffer, laid out as ``FIELD_LAYOUT`` says: an int32
    plane is (B, W), a bool plane (B, W), an int32 total (B,). The CUDA
    kernels write into them, and add into the totals (split-H into the
    runs too)."""
    by_kind = {kind: [f for f in fields if FIELD_LAYOUT[f] == kind]
               for kind in ("int32 plane", "int32 total", "bool plane")}
    planes, totals, flags = by_kind.values()
    n32 = b * (w * len(planes) + len(totals))
    buf = torch.zeros(4 * n32 + b * w * len(flags), dtype=torch.uint8,
                      device=device)
    i32 = buf[:4 * n32].view(torch.int32)
    views = dict(zip(planes, i32[:b * w * len(planes)].view(len(planes), b,
                                                            w)))
    views.update(zip(totals, i32[b * w * len(planes):].view(len(totals), b)))
    views.update(zip(flags, buf[4 * n32:].view(torch.bool).view(len(flags), b,
                                                                w)))
    return {f: views[f] for f in fields}


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
