"""yCHG on a bit-packed mask: eight rows a byte, a popcount a byte.

The port's counterpart of ``repro.kernels.ychg_packed``, with its public
names, signatures and result dict. Bit i of ``packed[r, c]`` is the
foreground bit of row ``8r + i`` of column ``c`` (LSB = top row); a run
starts at a set bit whose row above is clear, so in a byte ``b`` entered
with ``carry`` (the MSB of the byte above, 0 at the top)

    rising = b & ~((b << 1) | carry)        runs[c] += popcount(rising)

Two hand-written CUDA kernels (``csrc/ychg_packed.cu``, which explains
their design and what bounds them on Hopper), each beside its plain
PyTorch version. Both are the column scan of ``csrc/ychg_scan.cuh`` over
packed rows: four packed bytes in one 32-bit word, their rising bits
counted in the word's byte lanes without a popcount.

  ``ychg_packed_colscan``  replaces ``repro/kernels/ychg_packed.py::
                           _packed_colscan_kernel``: (ceil(H/8), W) uint8
                           -> (W,) int32 run counts.
  ``ychg_packed_fused``    replaces ``_packed_fused_kernel``: the same
                           count plus step 2, ``2 * runs`` and the totals,
                           in one launch, into views of one zeroed buffer.
                           Each tile also scans the column left of it, so
                           the reference wrapper's tile-start stitch is
                           not needed.

:func:`pack_rows` is plain torch ops, as the reference's is ``jnp``: no
kernel. Foreground is :func:`repro_torch.core.ychg.foreground` (float32
subnormals are background, float16 and bfloat16 keep theirs), which is what
the reference's ``img != 0`` computes under XLA. ``block_w`` is accepted so
that calls carry over from the reference; it changes no result.

A CUDA tensor launches the kernel, or the wrapper raises; only a tensor on
the CPU takes the plain version. ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.ychg import (
    foreground,
    hyperedge_transitions,
    zeroed_outputs,
)
from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"ychg_packed_colscan": 0, "ychg_packed_fused": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # packed, Hp, W, runs, stream
    "ychg_packed_colscan": (_P, _I, _I, _P, _P),
    # packed, Hp, W, runs, cut, trans, births, deaths, nh, nt, stream
    "ychg_packed_fused": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
}
# the fused kernel's outputs, in its C entry point's order
_FUSED_OUT = ("runs", "cut_vertices", "transitions", "births", "deaths",
              "n_hyperedges", "n_transitions")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_rows(img: Tensor) -> Tensor:
    """(H, W) mask -> (ceil(H/8), W) uint8, bit i = row 8r+i (LSB-first)."""
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got shape "
                         f"{tuple(img.shape)}")
    h, w = img.shape
    x = foreground(img).to(torch.uint8)
    pad = -h % 8
    if pad:
        x = torch.cat([x, x.new_zeros(pad, w)], 0)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)[None, :, None]
    return torch.sum(x.reshape(-1, 8, w) << shifts, dim=1, dtype=torch.uint8)


# ----------------------------------------------------------- plain versions


def _popcount8(x: Tensor) -> Tensor:
    """Set bits of each value in [0, 256), int32 (PyTorch has no popcount)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def packed_colscan_plain(packed: Tensor) -> Tensor:
    """Plain PyTorch version of ``ychg_packed_colscan``."""
    b = packed.to(torch.int32)
    carry = torch.cat([torch.zeros_like(b[:1]), b[:-1] >> 7], 0)
    rising = b & ~((b << 1) | carry)
    return torch.sum(_popcount8(rising), dim=0, dtype=torch.int32)


def packed_fused_plain(packed: Tensor) -> Dict[str, Tensor]:
    """Plain PyTorch version of ``ychg_packed_fused``: the seven fields of
    the reference's ``packed_analyze``."""
    runs = packed_colscan_plain(packed)
    t = hyperedge_transitions(runs)
    return {
        "runs": runs,
        "cut_vertices": 2 * runs,
        "births": t["births"],
        "deaths": t["deaths"],
        "transitions": t["transitions"],
        "n_hyperedges": torch.sum(t["births"], dtype=torch.int32),
        "n_transitions": torch.sum(t["transitions"], dtype=torch.int32),
    }


# ----------------------------------------------------------------- wrappers


def _check_packed(packed: Tensor) -> None:
    if not isinstance(packed, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got "
                        f"{type(packed).__name__}")
    if packed.ndim != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"expected a (ceil(H/8), W) uint8 packed mask, got "
                         f"{packed.dtype} of shape {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("expected a contiguous packed mask")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device "
                         f"{packed.device}")


def _check_block_w(block_w: int) -> None:
    if block_w < 1:
        raise ValueError(f"block_w must be >= 1, got {block_w}")


def ychg_packed_colscan(packed: Tensor) -> Tensor:
    """Step 1 on a packed mask (CUDA), or plain on the CPU."""
    _check_packed(packed)
    if packed.device.type == "cpu":
        return packed_colscan_plain(packed)
    return launch_colscan(packed)


def ychg_packed_fused(packed: Tensor) -> Dict[str, Tensor]:
    """Both steps and the totals on a packed mask (CUDA), or plain on the
    CPU."""
    _check_packed(packed)
    if packed.device.type == "cpu":
        return packed_fused_plain(packed)
    return launch_fused(packed)


def packed_colscan(packed: Tensor, *, block_w: int = 128) -> Tensor:
    """Step 1 on a row-packed mask. packed: (Hp, W) uint8 -> (W,) int32."""
    _check_block_w(block_w)
    return ychg_packed_colscan(packed)


def packed_analyze(img: Tensor, *, block_w: int = 128) -> Dict[str, Tensor]:
    """Full two-step pipeline, one pass over a bit-packed image: packs
    ``img`` with :func:`pack_rows`, then runs ``ychg_packed_fused``."""
    _check_block_w(block_w)
    return ychg_packed_fused(pack_rows(img))


def _cuda_packed(packed: Tensor) -> None:
    if not packed.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{packed.device}")
    _check_packed(packed)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch_colscan(packed: Tensor) -> Tensor:
    """The ``ychg_packed_colscan`` CUDA kernel on a CUDA packed mask."""
    _cuda_packed(packed)
    hp, w = packed.shape
    runs = torch.empty(w, dtype=torch.int32, device=packed.device)
    if w == 0:  # nothing to launch; a 0 grid is invalid
        return runs
    lib = _build.load("ychg_packed", _SIGNATURES)
    _raise_on(_build.on_stream(packed, lib.ychg_packed_colscan,
                               packed.data_ptr(), hp, w, runs.data_ptr()),
              "ychg_packed_colscan")
    LAUNCHES["ychg_packed_colscan"] += 1
    return runs


def launch_fused(packed: Tensor) -> Dict[str, Tensor]:
    """The ``ychg_packed_fused`` CUDA kernel on a CUDA packed mask; the
    seven fields are views of one zeroed buffer, (W,) planes and 0-d
    totals."""
    _cuda_packed(packed)
    hp, w = packed.shape
    out = {k: v[0] for k, v in zeroed_outputs(_FUSED_OUT, 1, w,
                                               packed.device).items()}
    if w == 0:
        return out
    lib = _build.load("ychg_packed", _SIGNATURES)
    _raise_on(_build.on_stream(packed, lib.ychg_packed_fused,
                               packed.data_ptr(), hp, w,
                               *[out[k].data_ptr() for k in _FUSED_OUT]),
              "ychg_packed_fused")
    LAUNCHES["ychg_packed_fused"] += 1
    return out
