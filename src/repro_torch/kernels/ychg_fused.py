"""Fused yCHG kernels: both steps for a (B, H, W) stack in one call.

Two hand-written CUDA kernels (``csrc/ychg_fused.cu``, which explains their
design and what bounds them on Hopper), each beside its plain PyTorch
version:

  ``ychg_fused_full``    replaces ``repro/kernels/ychg_fused.py::_fused_kernel``:
                         whole columns, each cut into row segments that the
                         warps of one block scan with wide loads along the
                         row and sum (``csrc/ychg_scan.cuh``).
  ``ychg_fused_splith``  replaces ``_fused_streamed_kernel``: the same scan
                         with the columns cut into ``block_h``-row ranges
                         (grid z), each range's counts added into the runs,
                         then step 2 in a second small launch right behind
                         it. One counted launch is that pair.

Each wrapper takes a contiguous (B, H, W) tensor and returns a dict of
``runs``, ``transitions``, ``births``, ``deaths`` (B, W) and
``n_hyperedges``, ``n_transitions`` (B,), with the dtypes of
``core.ychg.analyze`` (int32, transitions bool). A CUDA tensor launches the
kernel, or the wrapper raises; only a tensor on the CPU takes the plain
version. The kernels read uint8, bool, int32 and float32 masks in place
(float32 by its exponent bits: +-0 and subnormals are background, as
``core.ychg.foreground`` says); any other dtype first goes through one
``foreground`` pass on the device.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.ychg import foreground, zeroed_outputs
from repro_torch.kernels import _build

Tensor = torch.Tensor

# dtype -> the kernel's template code (bool is one 0/1 byte, read as uint8)
_KERNEL_DTYPES = {torch.uint8: 0, torch.bool: 0, torch.int32: 1,
                  torch.float32: 2}
_MAX_GRID_YZ = 65535

LAUNCHES: Dict[str, int] = {"ychg_fused_full": 0, "ychg_fused_splith": 0}
# the outputs, in the C entry points' order
_FIELDS = ("runs", "transitions", "births", "deaths", "n_hyperedges",
           "n_transitions")

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # img, dtype, B, H, W, runs, trans, births, deaths, nh, nt, stream
    "ychg_fused_full": (_P, ctypes.c_int, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P),
    # img, dtype, B, H, W, block_h, runs, trans, births, deaths, nh, nt, stream
    "ychg_fused_splith": (_P, ctypes.c_int, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------- plain versions


def _step2(runs: Tensor) -> Dict[str, Tensor]:
    """Step 2 and the per-image totals over complete (B, W) int32 counts."""
    left = torch.cat([torch.zeros_like(runs[:, :1]), runs[:, :-1]], 1)
    delta = runs - left
    trans = delta != 0
    births = torch.clamp(delta, min=0)
    return {
        "runs": runs,
        "transitions": trans,
        "births": births,
        "deaths": torch.clamp(-delta, min=0),
        "n_hyperedges": torch.sum(births, dim=-1, dtype=torch.int32),
        "n_transitions": torch.sum(trans, dim=-1, dtype=torch.int32),
    }


def _rising_count(rows: Tensor, above: Tensor) -> Tensor:
    """(B, W) int32 rising edges in a (B, h, W) bool slab whose row above
    is ``above`` (B, 1, W)."""
    prev = torch.cat([above, rows[:, :-1]], 1)
    return torch.sum(rows & ~prev, dim=1, dtype=torch.int32)


def ychg_fused_full_plain(imgs: Tensor) -> Dict[str, Tensor]:
    """Plain PyTorch version of ``ychg_fused_full``: whole columns."""
    x = foreground(imgs)
    return _step2(_rising_count(x, torch.zeros_like(x[:, :1])))


def ychg_fused_splith_plain(imgs: Tensor, block_h: int) -> Dict[str, Tensor]:
    """Plain PyTorch version of ``ychg_fused_splith``: per-segment counts,
    each segment entered with the row above it, summed."""
    x = foreground(imgs)
    b, h, w = x.shape
    runs = torch.zeros(b, w, dtype=torch.int32, device=x.device)
    zero_row = torch.zeros(b, 1, w, dtype=torch.bool, device=x.device)
    for r0 in range(0, h, block_h):
        above = x[:, r0 - 1:r0] if r0 else zero_row
        runs += _rising_count(x[:, r0:r0 + block_h], above)
    return _step2(runs)


# ----------------------------------------------------------------- wrappers


def _check(imgs: Tensor) -> None:
    if not isinstance(imgs, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(imgs).__name__}")
    if imgs.ndim != 3:
        raise ValueError(f"expected a (B, H, W) stack, got shape "
                         f"{tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("expected a contiguous (B, H, W) stack")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device "
                         f"{imgs.device}")


def ychg_fused_full(imgs: Tensor) -> Dict[str, Tensor]:
    """Both steps over whole columns (CUDA), or plain on the CPU."""
    _check(imgs)
    if imgs.device.type == "cpu":
        return ychg_fused_full_plain(imgs)
    return launch_full(imgs)


def ychg_fused_splith(imgs: Tensor, *, block_h: int = 2048
                      ) -> Dict[str, Tensor]:
    """Both steps with H cut into ``block_h``-row segments (CUDA), or plain
    on the CPU."""
    _check(imgs)
    if imgs.device.type == "cpu":
        if block_h < 1:
            raise ValueError(f"block_h must be >= 1, got {block_h}")
        return ychg_fused_splith_plain(imgs, block_h)
    return launch_splith(imgs, block_h=block_h)


def _kernel_input(imgs: Tensor) -> tuple[Tensor, int]:
    if not imgs.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{imgs.device}")
    _check(imgs)
    code = _KERNEL_DTYPES.get(imgs.dtype)
    if code is None:  # one device pass to a 0/1 byte mask
        return foreground(imgs), 0
    return imgs, code


def _out_ptrs(out: Dict[str, Tensor]) -> list[int]:
    return [out[k].data_ptr() for k in _FIELDS]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch_full(imgs: Tensor) -> Dict[str, Tensor]:
    """The ``ychg_fused_full`` CUDA kernel on a CUDA (B, H, W) stack."""
    x, code = _kernel_input(imgs)
    b, h, w = x.shape
    if b > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} exceeds {_MAX_GRID_YZ} images a launch")
    out = zeroed_outputs(_FIELDS, b, w, x.device)
    if b == 0 or w == 0:  # nothing to launch; a 0 grid is invalid
        return out
    lib = _build.load("ychg_fused", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ychg_fused_full(x.data_ptr(), code, b, h, w,
                                  *_out_ptrs(out), stream)
    _raise_on(err, "ychg_fused_full")
    LAUNCHES["ychg_fused_full"] += 1
    return out


def launch_splith(imgs: Tensor, *, block_h: int = 2048) -> Dict[str, Tensor]:
    """The ``ychg_fused_splith`` CUDA kernels on a CUDA (B, H, W) stack."""
    if block_h < 1:
        raise ValueError(f"block_h must be >= 1, got {block_h}")
    x, code = _kernel_input(imgs)
    b, h, w = x.shape
    if b > _MAX_GRID_YZ or -(-h // block_h) > _MAX_GRID_YZ:
        raise ValueError(f"(batch {b}, {-(-h // block_h)} H segments) "
                         f"exceeds {_MAX_GRID_YZ} a grid dimension")
    out = zeroed_outputs(_FIELDS, b, w, x.device)
    if b == 0 or w == 0:
        return out
    lib = _build.load("ychg_fused", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ychg_fused_splith(x.data_ptr(), code, b, h, w, block_h,
                                    *_out_ptrs(out), stream)
    _raise_on(err, "ychg_fused_splith")
    LAUNCHES["ychg_fused_splith"] += 1
    return out
