"""Connected-components labelling (CCL): plain PyTorch version + CUDA kernel.

The port's counterpart of ``repro.kernels.ccl``. Every foreground pixel
(nonzero, as ``core.ychg.foreground`` decides it) starts as its own
component seeded with its linear index + 1, and 4-neighbour min
propagation drives each component to a unique
fixpoint: the component's minimum linear index + 1, 0 on background. The
fixpoint does not depend on the schedule, so any algorithm that reaches
it gives the same labels. ``_canonicalize`` then re-ranks roots to
consecutive ids 1..n in row-major first-encounter order, which makes the
labels invariant under the service's pad-to-bucket batching.

  ``ccl_fixpoint_plain``  the raw fixpoint (int32, ``where(fg, lab, 0)``)
                          by sweeps of min propagation, root hooking and
                          pointer jumping until nothing changes
                          (:func:`fixpoint_with_sweeps` says why not the
                          reference's fixed two jumps a sweep);
  ``labels``              the reference: that fixpoint, canonicalized;
  ``ccl_fixpoint``        the wrapper: ``csrc/ccl.cu`` (union-find in a
                          shared-memory tile, then the tile seams in device
                          memory; the source states its design) on a CUDA
                          tensor, the plain version on a CPU tensor;
  ``labels_kernel``       ``_canonicalize(ccl_fixpoint(stack),
                          foreground(stack))``.

``_canonicalize`` is a plain helper outside the TPU kernel in the
reference too, and stays torch ops here. ``LAUNCHES["ccl"]`` counts kernel
launches: one counted launch is one call of the C entry point ``ccl``,
which runs the kernel's three passes (local, seams, final); the C entry
points ``ccl_local``, ``ccl_seams`` and ``ccl_final`` run one pass each
and are there to time the passes apart.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.ychg import foreground, foreground_passes
from repro_torch.kernels import _build
from repro_torch.kernels import plan as _plan
from repro_torch.launch.roofline import ccl_work

Tensor = torch.Tensor

CCL_FIELDS = ("labels", "n_components")

# Sentinel larger than any linear pixel index + 1; background carries it
# during propagation so minima never leak across components.
_INF = 1 << 30

# dtype -> the kernel's template code (bool is one 0/1 byte, read as uint8)
_KERNEL_DTYPES = {torch.uint8: 0, torch.bool: 0, torch.int32: 1,
                  torch.float32: 2}
_MAX_GRID_YZ = 65535

LAUNCHES: Dict[str, int] = {"ccl": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64
# img, dtype, B, H, W, labels, stream
_PASS = (_P, ctypes.c_int, _I, _I, _I, _P, _P)
_SIGNATURES = {
    "ccl": _PASS,
    "ccl_local": _PASS,
    "ccl_seams": (_I, _I, _I, _P, _P),  # B, H, W, labels, stream
    "ccl_final": _PASS,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class CCLSummary:
    """Batched CCL output: canonical labels + per-image component count."""

    labels: Tensor        # (B, H, W) int32, 0 = background, 1..n per image
    n_components: Tensor  # (B,) int32


# ---------------------------------------------------------- plain version


def _seed_labels(fg: Tensor) -> Tensor:
    """(B, H, W) bool -> initial labels: linear index + 1 on fg, _INF on bg."""
    _, h, w = fg.shape
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=fg.device).reshape(h, w)
    return torch.where(fg, idx[None], _INF)


def _neighbor_min(lab: Tensor) -> Tensor:
    """Min over self + 4-neighbours; borders padded with _INF."""
    pad = torch.nn.functional.pad
    up = pad(lab[:, :-1, :], (0, 0, 1, 0), value=_INF)
    down = pad(lab[:, 1:, :], (0, 0, 0, 1), value=_INF)
    left = pad(lab[:, :, :-1], (1, 0), value=_INF)
    right = pad(lab[:, :, 1:], (0, 1), value=_INF)
    return torch.minimum(lab, torch.minimum(torch.minimum(up, down),
                                            torch.minimum(left, right)))


def _targets(flat: Tensor, fgf: Tensor, pos: Tensor) -> Tensor:
    """int64 index of each fg pixel's label (its root candidate); bg pixels
    point at themselves. ``flat`` is (B, H*W) labels, ``pos`` 0..H*W-1."""
    return torch.where(fgf, flat.long() - 1, pos)


def fixpoint_with_sweeps(stack: Tensor) -> Tuple[Tensor, int]:
    """The raw fixpoint (int32 ``where(fg, lab, 0)``) and the number of
    sweeps it took, the last one changing nothing.

    A sweep is the reference's 4-neighbour min propagation, then each
    pixel's root candidate is lowered to that neighbourhood minimum
    (scatter-min, the hooking step of Shiloach-Vishkin), then pointer
    jumping runs until every label is a root's. A label only ever falls
    to the index + 1 of another pixel of its component, so the loop ends
    on the reference's fixpoint. The reference's two fixed jumps a sweep
    need a number of sweeps that grows with a component's length (1,307
    on one 2048^2 ``snowfield`` mask); with hooking and full jumping the
    same mask takes 6.
    """
    fg = foreground(stack)
    b, h, w = fg.shape
    if h * w == 0:
        return torch.zeros((b, h, w), dtype=torch.int32,
                           device=stack.device), 0
    if h * w >= _INF:
        raise ValueError(f"an image of {h * w} pixels reaches the label "
                         f"sentinel {_INF}")
    n = h * w
    fgf = fg.reshape(b, n)
    pos = torch.arange(n, device=stack.device)[None].expand(b, n)
    lab = _seed_labels(fg).reshape(b, n)
    sweeps = 0
    while True:
        sweeps += 1
        low = torch.where(fg, _neighbor_min(lab.reshape(b, h, w)), _INF)
        low = low.reshape(b, n)
        new = torch.minimum(lab, low)
        new.scatter_reduce_(1, _targets(lab, fgf, pos), low, reduce="amin")
        del low
        while True:
            hop = torch.gather(new, 1, _targets(new, fgf, pos))
            if torch.equal(hop, new):
                break
            new = hop
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(fg, lab.reshape(b, h, w), 0), sweeps


def ccl_fixpoint_plain(stack: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: the raw fixpoint, (B, H, W)
    int32, min linear index + 1 of each pixel's component, 0 on bg."""
    return fixpoint_with_sweeps(stack)[0]


def _canonicalize(lab: Tensor, fg: Tensor) -> CCLSummary:
    """Fixpoint labels (min linear index + 1 per component) -> consecutive
    ids 1..n in row-major first-encounter order, 0 on background."""
    b, h, w = lab.shape
    flat = torch.where(fg, lab, 0).reshape(b, h * w)
    pos = torch.arange(1, h * w + 1, dtype=torch.int32, device=lab.device)
    is_root = (flat == pos[None]).to(torch.int32)  # bg is 0, never a root
    # one 1-D scan per image: with one (B, H*W) scan along dim 1 this
    # function took 118 ms at 8 x 8192^2 on an H100, 40 times its time on
    # one 8192^2 image (PERF.md)
    rank = torch.empty_like(is_root)
    for i in range(b):
        torch.cumsum(is_root[i], 0, dtype=torch.int32, out=rank[i])
    del is_root
    hop = torch.gather(rank, 1, (flat - 1).clamp_(min=0).long())
    canon = torch.where(flat > 0, hop, 0)
    n = (rank[:, -1].clone() if h * w
         else torch.zeros((b,), dtype=torch.int32, device=lab.device))
    return CCLSummary(labels=canon.reshape(b, h, w), n_components=n)


def canonicalize_plan(b: int, h: int, w: int) -> _plan.Plan:
    """What :func:`_canonicalize` reads, writes and allocates for a (b, h,
    w) stack, op by op in its order (bytes read and written an element);
    the scans' own temporaries inside PyTorch's ``cumsum`` are not
    reckoned."""
    n, passes = b * h * w, _plan.passes
    rank = (_plan.alloc("rank", 4 * n)
            + _plan.Plan(op_bytes=8 * n, op_ops=n))   # cumsum into rank
    clamp = _plan.Plan(op_bytes=8 * n, op_ops=n)      # clamp_ in place
    n_components = (passes(b, [("rank[:, -1].clone()", 4, 4)], output=True)
                    if h * w else _plan.alloc("zeros", 4 * b, output=True))
    return (passes(n, [("where(fg, lab, 0)", 5, 4)])
            + passes(h * w, [("arange", 0, 4)])
            + passes(n, [("== pos", 8, 1), ("to int32", 1, 4)])
            + rank
            + passes(n, [("flat - 1", 4, 4)]) + clamp
            + passes(n, [("long", 4, 8), ("gather", 12, 4),
                         ("flat > 0", 4, 1)])
            + passes(n, [("where(flat > 0, hop, 0)", 5, 4)], output=True)
            + n_components)


def labels(stack: Tensor) -> CCLSummary:
    """Reference: (B, H, W) stack of any dtype -> canonical CCL summary."""
    return _canonicalize(ccl_fixpoint_plain(stack), foreground(stack))


# ---------------------------------------------------------------- wrappers


def ccl_fixpoint(stack: Tensor) -> Tensor:
    """The raw fixpoint: the CUDA kernel on a CUDA (B, H, W) stack, the
    plain version on a CPU one. Any other device raises."""
    if not isinstance(stack, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(stack).__name__}")
    if stack.ndim != 3:
        raise ValueError(f"expected a (B, H, W) stack, got shape "
                         f"{tuple(stack.shape)}")
    if stack.device.type == "cpu":
        return ccl_fixpoint_plain(stack)
    return launch(stack)


def labels_kernel(stack: Tensor) -> CCLSummary:
    """Canonical labels through :func:`ccl_fixpoint`."""
    return _canonicalize(ccl_fixpoint(stack), foreground(stack))


def check_shape(b: int, h: int, w: int) -> None:
    """Raises for a (b, h, w) stack the kernel cannot take: its tiles run
    along the grid's x dimension and its images along y (at most 65535),
    and one image's labels must stay below the sentinel."""
    if b > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} exceeds {_MAX_GRID_YZ} images a launch")
    if h * w >= _INF:
        raise ValueError(f"an image of {h * w} pixels reaches the label "
                         f"sentinel {_INF}")


def plan(b: int, h: int, w: int, dtype: torch.dtype) -> _plan.Plan:
    """What :func:`labels_kernel` does on the card for a contiguous (b, h,
    w) stack of ``dtype``, from the shape alone: ``launch`` (a foreground
    pass for a dtype the kernel does not read, the raw labels, one counted
    launch), the foreground of the stack, then :func:`canonicalize_plan`.
    Raises where ``launch`` would."""
    check_shape(b, h, w)
    n, itemsize = b * h * w, dtype.itemsize
    p = _plan.Plan(sources=("ccl",))
    if dtype not in _KERNEL_DTYPES:
        p += _plan.passes(n, foreground_passes(dtype))
        itemsize = 1
    return (p + _plan.alloc("raw fixpoint labels", 4 * n)
            + _plan.launch("ccl", int(n > 0), ccl_work(n, itemsize))
            + _plan.passes(n, foreground_passes(dtype))
            + canonicalize_plan(b, h, w))


def launch(stack: Tensor) -> Tensor:
    """The ``ccl`` CUDA kernel on a CUDA (B, H, W) stack: the raw fixpoint,
    in one call of the C entry point (three passes, one counted launch)."""
    if not stack.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{stack.device}")
    x = stack.contiguous()
    code = _KERNEL_DTYPES.get(x.dtype)
    if code is None:  # one device pass to a 0/1 byte mask
        x, code = foreground(x), 0
    b, h, w = x.shape
    check_shape(b, h, w)
    out = torch.empty((b, h, w), dtype=torch.int32, device=x.device)
    if out.numel() == 0:  # nothing to launch; a 0 grid is invalid
        return out
    lib = _build.load("ccl", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ccl(x.data_ptr(), code, b, h, w, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ccl launch failed: CUDA error {err}")
    LAUNCHES["ccl"] += 1
    return out
