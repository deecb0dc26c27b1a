"""The paper's two-kernel yCHG: step 1, then step 2, for one (H, W) mask or
a (B, H, W) stack.

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

``ychg_colscan_analyze`` runs the whole two-kernel path for a (B, H, W)
stack in one host call (the C entry point of the same name): for each mask
a step-1 launch and a step-2 launch, the latter a second instantiation of
``ychg_diff`` that also writes the cut vertices and the image's totals. It
returns the seven fields of ``core.ychg.analyze`` as views of one buffer,
and counts each launch under its kernel's name. ``analyze_plain`` is its
plain version, ``finish_plain`` that of its step-2 kernel alone.

A CUDA tensor launches the kernel, or the wrapper raises; only a tensor on
the CPU takes the plain version. The step-1 kernels read uint8, bool, int32
and float32 masks in place (float32 by its exponent bits, as
``core.ychg.foreground`` decides it); any other dtype first goes through
one ``foreground`` pass on the device.

``LAUNCHES`` counts kernel launches per kernel, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.ychg import (
    column_runs,
    foreground,
    hyperedge_transitions,
    zeroed_outputs,
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
    # img, dtype, B, H, W, block_h (0: full-column), runs, cut_vertices,
    # transitions, births, deaths, n_hyperedges, n_transitions, stream
    "ychg_colscan_analyze": (_P, ctypes.c_int, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P),
    # the same, step 2 in plain stream order (a diagnostic)
    "ychg_colscan_analyze_stream_order": (_P, ctypes.c_int, _I, _I, _I, _I,
                                          _P, _P, _P, _P, _P, _P, _P, _P),
}
# the fields of core.ychg.analyze, in the C entry point's order
ANALYZE_FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
                  "n_hyperedges", "n_transitions")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------- plain versions


def _rising_count(rows: Tensor, above: Tensor) -> Tensor:
    """(..., W) int32 rising edges in a (..., h, W) bool slab whose row
    above is ``above`` (..., 1, W)."""
    prev = torch.cat([above, rows[..., :-1, :]], -2)
    return torch.sum(rows & ~prev, dim=-2, dtype=torch.int32)


def colscan_full_plain(img: Tensor) -> Tensor:
    """Plain PyTorch version of ``ychg_colscan_full``: the reference's step
    1 over whole columns, of an (H, W) mask or a (..., H, W) stack."""
    return column_runs(img)


def colscan_splith_plain(img: Tensor, block_h: int) -> Tensor:
    """Plain PyTorch version of ``ychg_colscan_splith``: per-segment counts,
    each segment entered with the row above it, summed; an (H, W) mask or a
    (..., H, W) stack."""
    x = foreground(img)
    h, w = x.shape[-2:]
    runs = torch.zeros(x.shape[:-2] + (w,), dtype=torch.int32,
                       device=x.device)
    zero_row = torch.zeros(x.shape[:-2] + (1, w), dtype=torch.bool,
                           device=x.device)
    for r0 in range(0, h, block_h):
        above = x[..., r0 - 1:r0, :] if r0 else zero_row
        runs += _rising_count(x[..., r0:r0 + block_h, :], above)
    return runs


def diff_plain(runs: Tensor) -> Dict[str, Tensor]:
    """Plain PyTorch version of ``ychg_diff``: the reference's step 2."""
    return hyperedge_transitions(runs)


def finish_plain(runs: Tensor) -> Dict[str, Tensor]:
    """Plain PyTorch version of the step-2 kernel the batch entry launches
    (``ychg_diff``'s second instantiation): the seven fields of
    ``core.ychg.analyze`` from (..., W) int32 run counts."""
    t = diff_plain(runs)
    return {
        "runs": runs,
        "cut_vertices": 2 * runs,
        "transitions": t["transitions"],
        "births": t["births"],
        "deaths": t["deaths"],
        "n_hyperedges": torch.sum(t["births"], dim=-1, dtype=torch.int32),
        "n_transitions": torch.sum(t["transitions"], dim=-1,
                                   dtype=torch.int32),
    }


def analyze_plain(imgs: Tensor, block_h: Optional[int] = None
                  ) -> Dict[str, Tensor]:
    """Plain PyTorch version of ``ychg_colscan_analyze``: the seven fields
    of ``core.ychg.analyze`` for a (B, H, W) stack, step 1 over whole
    columns (``block_h`` None) or in ``block_h``-row segments."""
    return finish_plain(colscan_full_plain(imgs) if block_h is None
                        else colscan_splith_plain(imgs, block_h))


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


def _check_block_h(block_h: Optional[int]) -> None:
    if block_h is not None and block_h < 1:
        raise ValueError(f"block_h must be >= 1, got {block_h}")


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
    _check_block_h(block_h)
    if img.device.type == "cpu":
        return colscan_splith_plain(img, block_h)
    return launch_splith(img, block_h=block_h)


def ychg_diff(runs: Tensor) -> Dict[str, Tensor]:
    """Step 2 (CUDA), or plain on the CPU."""
    _check_runs(runs)
    if runs.device.type == "cpu":
        return diff_plain(runs)
    return launch_diff(runs)


def ychg_colscan_analyze(imgs: Tensor, *, block_h: Optional[int] = None
                         ) -> Dict[str, Tensor]:
    """Both steps for a (B, H, W) stack, two kernels a mask in one host
    call (CUDA), or plain on the CPU. ``block_h`` None runs step 1 over
    whole columns, an int in segments of that many rows."""
    _check(imgs, 3, "a (B, H, W) stack")
    _check_block_h(block_h)
    if imgs.device.type == "cpu":
        return analyze_plain(imgs, block_h)
    return launch_analyze(imgs, block_h=block_h)


def _cuda_only(x: Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{x.device}")


def _kernel_input(img: Tensor, ndim: int = 2,
                  what: str = "an (H, W) mask") -> tuple[Tensor, int]:
    _cuda_only(img)
    _check(img, ndim, what)
    code = _KERNEL_DTYPES.get(img.dtype)
    if code is None:  # one device pass to a 0/1 byte mask
        return foreground(img), 0
    return img, code


def _check_segments(h: int, block_h: int) -> None:
    if -(-h // block_h) > _MAX_GRID_Y:
        raise ValueError(f"{-(-h // block_h)} H segments exceed {_MAX_GRID_Y} "
                         f"a grid dimension")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch_full(img: Tensor) -> Tensor:
    """The ``ychg_colscan_full`` CUDA kernel on a CUDA (H, W) mask."""
    x, code = _kernel_input(img)
    h, w = x.shape
    runs = torch.empty(w, dtype=torch.int32, device=x.device)
    if w == 0:  # nothing to launch; a 0 grid is invalid
        return runs
    lib = _build.load("ychg_colscan", _SIGNATURES)
    _raise_on(_build.on_stream(x, lib.ychg_colscan_full, x.data_ptr(), code,
                               h, w, runs.data_ptr()), "ychg_colscan_full")
    LAUNCHES["ychg_colscan_full"] += 1
    return runs


def launch_splith(img: Tensor, *, block_h: int = 2048) -> Tensor:
    """The ``ychg_colscan_splith`` CUDA kernel on a CUDA (H, W) mask."""
    _check_block_h(block_h)
    x, code = _kernel_input(img)
    h, w = x.shape
    _check_segments(h, block_h)
    runs = torch.zeros(w, dtype=torch.int32, device=x.device)
    if h == 0 or w == 0:
        return runs
    lib = _build.load("ychg_colscan", _SIGNATURES)
    _raise_on(_build.on_stream(x, lib.ychg_colscan_splith, x.data_ptr(),
                               code, h, w, block_h, runs.data_ptr()),
              "ychg_colscan_splith")
    LAUNCHES["ychg_colscan_splith"] += 1
    return runs


def launch_diff(runs: Tensor) -> Dict[str, Tensor]:
    """The ``ychg_diff`` CUDA kernel on CUDA (W,) int32 run counts; the
    three fields are views of one buffer."""
    _cuda_only(runs)
    _check_runs(runs)
    (w,) = runs.shape
    births, deaths, trans = torch.empty(
        9 * w, dtype=torch.uint8, device=runs.device).split((4 * w, 4 * w, w))
    out = {"transitions": trans.view(torch.bool),
           "births": births.view(torch.int32),
           "deaths": deaths.view(torch.int32)}
    if w == 0:
        return out
    lib = _build.load("ychg_colscan", _SIGNATURES)
    _raise_on(_build.on_stream(runs, lib.ychg_diff, runs.data_ptr(), w,
                               out["transitions"].data_ptr(),
                               out["births"].data_ptr(),
                               out["deaths"].data_ptr()), "ychg_diff")
    LAUNCHES["ychg_diff"] += 1
    return out


def launch_analyze(imgs: Tensor, *, block_h: Optional[int] = None
                   ) -> Dict[str, Tensor]:
    """The two-kernel path on a CUDA (B, H, W) stack in one call of the C
    entry point ``ychg_colscan_analyze``: a ``ychg_colscan_full``
    (``block_h`` None) or ``ychg_colscan_splith`` launch and a
    ``ychg_diff`` launch a mask."""
    _check_block_h(block_h)
    x, code = _kernel_input(imgs, 3, "a (B, H, W) stack")
    b, h, w = x.shape
    if block_h is not None:
        _check_segments(h, block_h)
    out = zeroed_outputs(ANALYZE_FIELDS, b, w, x.device)
    if b == 0 or w == 0:
        return out
    lib = _build.load("ychg_colscan", _SIGNATURES)
    _raise_on(_build.on_stream(x, lib.ychg_colscan_analyze, x.data_ptr(),
                               code, b, h, w, block_h or 0,
                               *[out[k].data_ptr() for k in ANALYZE_FIELDS]),
              "ychg_colscan_analyze")
    if block_h is None:
        LAUNCHES["ychg_colscan_full"] += b
    elif h > 0:  # no segment, no step-1 launch
        LAUNCHES["ychg_colscan_splith"] += b
    LAUNCHES["ychg_diff"] += b
    return out
