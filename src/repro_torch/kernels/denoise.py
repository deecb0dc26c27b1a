"""P-HGRMS-style hypergraph RMS denoising: plain PyTorch version + CUDA kernel.

The port's counterpart of ``repro.kernels.denoise``. Each pixel's
zero-padded 3x3 window gives

  mean_j = (sum of the window) * float32(1/9)
  rms_j  = sqrt((sum of squares over the window) * float32(1/9))
  out_j  = rms_j if |x_j - mean_j| > TAU * rms_j else x_j

in float32 whatever the input dtype. Zero padding with a fixed divisor of 9
makes the filter invariant under the service's pad-to-bucket batching.

``denoise_plain`` (= ``denoise``, the reference) repeats the JAX
reference's float32 arithmetic operation for operation, as XLA:CPU
evaluates it: the nine taps are added left to right in row-major order;
the centre tap of the sum of squares is one fused multiply-add,
``fma(x, x, partial)`` (XLA contracts that one add and no other), which
the plain version rounds once, exactly; and ``sqrt`` is correctly
rounded (PyTorch's float32 CPU ``sqrt`` is not, so it is taken in float64
and rounded back, which is exact for sqrt since 53 >= 2 * 24 + 2).

``denoise_kernel(stack)`` launches ``csrc/denoise.cu`` on a CUDA tensor
(which states its design and what bounds it) and runs the plain version on
a CPU tensor. ``LAUNCHES["denoise"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

DENOISE_FIELDS = ("image",)

# Outlier threshold: |x - mean| > TAU * rms flags an impulse. A module
# constant, as in the reference, so results never depend on runtime tuning.
TAU = 0.75

# float32(1/9), the reference's weakly typed ``1.0 / 9.0`` in float32
_NINTH = 1.0 / 9.0

# dtype -> the kernel's template code (bool is one 0/1 byte, read as uint8)
_KERNEL_DTYPES = {torch.uint8: 0, torch.bool: 0, torch.int32: 1,
                  torch.float32: 2}
_MAX_GRID_YZ = 65535
_TILE_H = 8  # rows of one block's output tile (kTileH in csrc/denoise.cu)

LAUNCHES: Dict[str, int] = {"denoise": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # img, dtype, B, H, W, out, stream
    "denoise": (_P, ctypes.c_int, _I, _I, _I, _P, _P),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class DenoiseSummary:
    """Batched denoise output."""

    image: Tensor  # (B, H, W) float32


# ----------------------------------------------------------- plain version


def _window_sum(x: Tensor) -> Tensor:
    """Sum of the zero-padded 3x3 window around each pixel, (B, H, W); the
    taps are added left to right in row-major order."""
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    return (
        p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
        + p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
        + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]
    )


def _fma_sq(x: Tensor, partial: Tensor) -> Tensor:
    """float32 ``fma(x, x, partial)``, rounded once.

    x * x is exact in float64 (48 significant bits); the add is taken in
    float64 with its rounding error recovered by TwoSum and then rounded
    to odd, so the final cast to float32 rounds once, correctly (53 >=
    24 + 2). Infinite and NaN sums pass through unchanged.
    """
    p = x.double()
    p = p * p
    a = partial.double()
    s = a + p
    bp = s - a
    err = (a - (s - bp)) + (p - bp)
    del p, a, bp
    even = (s.view(torch.int64) & 1) == 0
    inexact = (err != 0) & torch.isfinite(s) & even
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    toward = torch.where(err > 0, inf, -inf)
    return torch.where(inexact, torch.nextafter(s, toward), s).float()


def _sqrt_rn(v: Tensor) -> Tensor:
    """Correctly rounded float32 sqrt (float64 sqrt rounded back)."""
    return torch.sqrt(v.double()).float()


def _filter(x: Tensor) -> Tensor:
    """The shared arithmetic path: (B, H, W) float32 -> float32."""
    ninth = torch.tensor(_NINTH, dtype=torch.float32, device=x.device)
    mean = _window_sum(x) * ninth
    q = torch.nn.functional.pad(x, (1, 1, 1, 1))
    q = q * q
    h, w = x.shape[-2:]
    taps = [q[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    s2 = _fma_sq(x, taps[0] + taps[1] + taps[2] + taps[3])
    s2 = s2 + taps[5] + taps[6] + taps[7] + taps[8]
    rms = _sqrt_rn(s2 * ninth)
    return torch.where(torch.abs(x - mean) > TAU * rms, rms, x)


def denoise_plain(stack: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: (B, H, W) any dtype -> float32."""
    x = stack.to(torch.float32)
    if x.numel() == 0:
        return x.clone()
    return _filter(x)


def denoise(stack: Tensor) -> DenoiseSummary:
    """Reference: (B, H, W) stack of any dtype -> float32 summary."""
    return DenoiseSummary(image=denoise_plain(stack))


# ----------------------------------------------------------------- wrapper


def denoise_kernel(stack: Tensor) -> DenoiseSummary:
    """The CUDA kernel on a CUDA (B, H, W) stack; the plain version on a CPU
    one. Any other device raises."""
    if not isinstance(stack, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(stack).__name__}")
    if stack.ndim != 3:
        raise ValueError(f"expected a (B, H, W) stack, got shape "
                         f"{tuple(stack.shape)}")
    if stack.device.type == "cpu":
        return denoise(stack)
    return DenoiseSummary(image=launch(stack))


def launch(stack: Tensor) -> Tensor:
    """The ``denoise`` CUDA kernel on a CUDA (B, H, W) stack."""
    if not stack.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{stack.device}")
    x = stack.contiguous()
    code = _KERNEL_DTYPES.get(x.dtype)
    if code is None:  # one device cast pass
        x, code = x.to(torch.float32), 2
    b, h, w = x.shape
    if b > _MAX_GRID_YZ or -(-h // _TILE_H) > _MAX_GRID_YZ:
        raise ValueError(f"(batch {b}, {-(-h // _TILE_H)} row tiles) exceeds "
                         f"{_MAX_GRID_YZ} a grid dimension")
    out = torch.empty((b, h, w), dtype=torch.float32, device=x.device)
    if out.numel() == 0:  # nothing to launch; a 0 grid is invalid
        return out
    lib = _build.load("denoise", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.denoise(x.data_ptr(), code, b, h, w, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"denoise launch failed: CUDA error {err}")
    LAUNCHES["denoise"] += 1
    return out
