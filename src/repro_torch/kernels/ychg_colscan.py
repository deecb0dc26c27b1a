"""The paper's two-kernel yCHG for one (H, W) mask: step 1, then step 2.

Three hand-written CUDA kernels (``csrc/ychg_colscan.cu``, which explains
their design and what bounds them on Hopper), each beside its plain PyTorch
version:

  ``ychg_colscan_full``    replaces ``repro/kernels/ychg_colscan.py::
                           _colscan_kernel``: per-column maximal-run counts,
                           (H, W) -> (W,) int32, over whole columns.
  ``ychg_colscan_splith``  replaces ``_colscan_streamed_kernel``: the same,
                           H cut into ``block_h``-row segments whose counts
                           are summed.
  ``ychg_diff``            replaces ``_diff_kernel``: step 2, (W,) int32
                           runs -> ``transitions`` (bool), ``births`` and
                           ``deaths`` (int32), column 0's left neighbour 0.

A CUDA tensor launches the kernel, or the wrapper raises; only a tensor on
the CPU takes the plain version. The step-1 kernels read uint8, bool, int32
and float32 masks in place (float32 by its exponent bits, as
``core.ychg.foreground`` decides it); any other dtype first goes through
one ``foreground`` pass on the device.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.ychg import (
    column_runs,
    foreground,
    hyperedge_transitions,
)
from repro_torch.kernels import _build

Tensor = torch.Tensor

# dtype -> the kernel's template code (bool is one 0/1 byte, read as uint8)
_KERNEL_DTYPES = {torch.uint8: 0, torch.bool: 0, torch.int32: 1,
                  torch.float32: 2}
_MAX_GRID_Y = 65535

LAUNCHES: Dict[str, int] = {"ychg_colscan_full": 0, "ychg_colscan_splith": 0,
                            "ychg_diff": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # img, dtype, H, W, runs, stream
    "ychg_colscan_full": (_P, ctypes.c_int, _I, _I, _P, _P),
    # img, dtype, H, W, block_h, runs, stream
    "ychg_colscan_splith": (_P, ctypes.c_int, _I, _I, _I, _P, _P),
    # runs, W, transitions, births, deaths, stream
    "ychg_diff": (_P, _I, _P, _P, _P, _P),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------- plain versions


def _rising_count(rows: Tensor, above: Tensor) -> Tensor:
    """(W,) int32 rising edges in an (h, W) bool slab whose row above is
    ``above`` (1, W)."""
    prev = torch.cat([above, rows[:-1]], 0)
    return torch.sum(rows & ~prev, dim=0, dtype=torch.int32)


def colscan_full_plain(img: Tensor) -> Tensor:
    """Plain PyTorch version of ``ychg_colscan_full``: the reference's step
    1 over whole columns."""
    return column_runs(img)


def colscan_splith_plain(img: Tensor, block_h: int) -> Tensor:
    """Plain PyTorch version of ``ychg_colscan_splith``: per-segment counts,
    each segment entered with the row above it, summed."""
    x = foreground(img)
    h, w = x.shape
    runs = torch.zeros(w, dtype=torch.int32, device=x.device)
    zero_row = torch.zeros(1, w, dtype=torch.bool, device=x.device)
    for r0 in range(0, h, block_h):
        above = x[r0 - 1:r0] if r0 else zero_row
        runs += _rising_count(x[r0:r0 + block_h], above)
    return runs


def diff_plain(runs: Tensor) -> Dict[str, Tensor]:
    """Plain PyTorch version of ``ychg_diff``: the reference's step 2."""
    return hyperedge_transitions(runs)


# ----------------------------------------------------------------- wrappers


def _check(x: Tensor, ndim: int, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.ndim != ndim:
        raise ValueError(f"expected {what}, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"expected a contiguous {what}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {x.device}")


def _check_runs(runs: Tensor) -> None:
    _check(runs, 1, "(W,) run counts")
    if runs.dtype != torch.int32:
        raise ValueError(f"expected int32 run counts, got {runs.dtype}")


def ychg_colscan_full(img: Tensor) -> Tensor:
    """Step 1 over whole columns (CUDA), or plain on the CPU."""
    _check(img, 2, "an (H, W) mask")
    if img.device.type == "cpu":
        return colscan_full_plain(img)
    return launch_full(img)


def ychg_colscan_splith(img: Tensor, *, block_h: int = 2048) -> Tensor:
    """Step 1 with H cut into ``block_h``-row segments (CUDA), or plain on
    the CPU."""
    _check(img, 2, "an (H, W) mask")
    if block_h < 1:
        raise ValueError(f"block_h must be >= 1, got {block_h}")
    if img.device.type == "cpu":
        return colscan_splith_plain(img, block_h)
    return launch_splith(img, block_h=block_h)


def ychg_diff(runs: Tensor) -> Dict[str, Tensor]:
    """Step 2 (CUDA), or plain on the CPU."""
    _check_runs(runs)
    if runs.device.type == "cpu":
        return diff_plain(runs)
    return launch_diff(runs)


def _cuda_only(x: Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{x.device}")


def _kernel_input(img: Tensor) -> tuple[Tensor, int]:
    _cuda_only(img)
    _check(img, 2, "an (H, W) mask")
    code = _KERNEL_DTYPES.get(img.dtype)
    if code is None:  # one device pass to a 0/1 byte mask
        return foreground(img), 0
    return img, code


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_full(img: Tensor) -> Tensor:
    """The ``ychg_colscan_full`` CUDA kernel on a CUDA (H, W) mask."""
    x, code = _kernel_input(img)
    h, w = x.shape
    runs = torch.empty(w, dtype=torch.int32, device=x.device)
    if w == 0:  # nothing to launch; a 0 grid is invalid
        return runs
    lib = _build.load("ychg_colscan", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.ychg_colscan_full(x.data_ptr(), code, h, w,
                                    runs.data_ptr(), _stream(x))
    _raise_on(err, "ychg_colscan_full")
    LAUNCHES["ychg_colscan_full"] += 1
    return runs


def launch_splith(img: Tensor, *, block_h: int = 2048) -> Tensor:
    """The ``ychg_colscan_splith`` CUDA kernel on a CUDA (H, W) mask."""
    if block_h < 1:
        raise ValueError(f"block_h must be >= 1, got {block_h}")
    x, code = _kernel_input(img)
    h, w = x.shape
    if -(-h // block_h) > _MAX_GRID_Y:
        raise ValueError(f"{-(-h // block_h)} H segments exceed {_MAX_GRID_Y} "
                         f"a grid dimension")
    runs = torch.zeros(w, dtype=torch.int32, device=x.device)
    if h == 0 or w == 0:
        return runs
    lib = _build.load("ychg_colscan", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.ychg_colscan_splith(x.data_ptr(), code, h, w, block_h,
                                      runs.data_ptr(), _stream(x))
    _raise_on(err, "ychg_colscan_splith")
    LAUNCHES["ychg_colscan_splith"] += 1
    return runs


def launch_diff(runs: Tensor) -> Dict[str, Tensor]:
    """The ``ychg_diff`` CUDA kernel on CUDA (W,) int32 run counts."""
    _cuda_only(runs)
    _check_runs(runs)
    (w,) = runs.shape
    out = {"transitions": torch.empty(w, dtype=torch.bool, device=runs.device),
           "births": torch.empty(w, dtype=torch.int32, device=runs.device),
           "deaths": torch.empty(w, dtype=torch.int32, device=runs.device)}
    if w == 0:
        return out
    lib = _build.load("ychg_colscan", _SIGNATURES)
    with torch.cuda.device(runs.device):
        err = lib.ychg_diff(runs.data_ptr(), w, out["transitions"].data_ptr(),
                            out["births"].data_ptr(), out["deaths"].data_ptr(),
                            _stream(runs))
    _raise_on(err, "ychg_diff")
    LAUNCHES["ychg_diff"] += 1
    return out
