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
two multiply-adds are fused, as XLA:CPU contracts them (``vfmadd`` and
``vfnmadd`` in its code): the centre tap of the sum of squares,
``fma(x, x, partial)``, and the deviation ``x - mean`` as
``fma(-sum, 1/9, x)``; the plain version rounds each once, exactly; and
``sqrt`` is correctly rounded (PyTorch's float32 CPU ``sqrt`` is not, so it
is taken in float64 and rounded back, which is exact for sqrt since
53 >= 2 * 24 + 2). XLA:CPU also flushes float32 subnormals: each
arithmetic step reads a subnormal input as zero and writes a subnormal
result as zero of its sign (:func:`_ftz` after every rounded step), while
the final select passes the pixel itself through unflushed.

``denoise_kernel(stack)`` launches ``csrc/denoise.cu`` on a CUDA tensor
(a warp walks a column strip down the image with the 3x3 window in
registers; the source states its design and what bounds it) and runs the
plain version on a CPU tensor. ``LAUNCHES["denoise"]`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from repro_torch.core.ychg import (
    F32_EXPONENT_BITS,
    narrow_wide_ints,
    narrowed,
)
from repro_torch.kernels import _build
from repro_torch.kernels import plan as _plan
from repro_torch.launch.roofline import denoise_work

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
_MAX_INT32 = torch.iinfo(torch.int32).max
_F32_SIGN_BIT = torch.iinfo(torch.int32).min  # 0x80000000 as an int32
# one block of the kernel: a strip of STRIP_W columns (kStripW in
# csrc/denoise.cu) walked down STRIP_H rows (kStripH)
STRIP_H, STRIP_W = 32, 512

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


def _ftz(t: Tensor) -> Tensor:
    """float32 ``t`` with every subnormal flushed to a zero of its sign, as
    XLA:CPU reads and writes float32 under its flush-to-zero mode. Tested
    on the bits, so PyTorch's own denormal mode cannot change it."""
    bits = t.view(torch.int32)
    zero = (bits & _F32_SIGN_BIT).view(torch.float32)
    return torch.where((bits & F32_EXPONENT_BITS) == 0, zero, t)


def _fma(x: Tensor, y: Tensor, partial: Tensor) -> Tensor:
    """float32 ``fma(x, y, partial)``, rounded once.

    x * y is exact in float64 (48 significant bits); the add is taken in
    float64 with its rounding error recovered by TwoSum and then rounded
    to odd, so the final cast to float32 rounds once, correctly (53 >=
    24 + 2). Infinite and NaN sums pass through unchanged.
    """
    p = x.double() * y.double()
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


def _fma_sq(x: Tensor, partial: Tensor) -> Tensor:
    """float32 ``fma(x, x, partial)``, rounded once."""
    return _fma(x, x, partial)


def _sqrt_rn(v: Tensor) -> Tensor:
    """Correctly rounded float32 sqrt (float64 sqrt rounded back)."""
    return torch.sqrt(v.double()).float()


def _taps(p: Tensor, h: int, w: int) -> list:
    """The nine (B, h, w) views of a padded stack, in row-major order."""
    return [p[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]


def _filter(x: Tensor) -> Tensor:
    """The shared arithmetic path: (B, H, W) float32 -> float32."""
    h, w = x.shape[-2:]
    xf = _ftz(x)
    ninth = torch.tensor(_NINTH, dtype=torch.float32, device=x.device)
    taps = _taps(torch.nn.functional.pad(xf, (1, 1, 1, 1)), h, w)
    s = taps[0]
    for t in taps[1:]:
        s = _ftz(s + t)
    q = torch.nn.functional.pad(xf, (1, 1, 1, 1))
    taps = _taps(_ftz(q * q), h, w)
    s2 = taps[0]
    for t in taps[1:4]:
        s2 = _ftz(s2 + t)
    s2 = _ftz(_fma_sq(xf, s2))
    for t in taps[5:]:
        s2 = _ftz(s2 + t)
    del q, taps
    rms = _sqrt_rn(_ftz(s2 * ninth))
    dev = torch.abs(_ftz(_fma(-s, ninth.expand_as(s), xf)))
    return torch.where(dev > TAU * rms, rms, x)


def to_float32(x: Tensor) -> Tensor:
    """The filter's float32 input, as the JAX package makes it: 64-bit
    integers keep their low 32 bits first (``jnp.asarray`` with x64 off)."""
    return narrow_wide_ints(x).to(torch.float32)


def to_float32_passes(dtype: torch.dtype) -> tuple[tuple[str, int, int], ...]:
    """The passes :func:`to_float32` runs on a tensor of ``dtype``, as
    (what, bytes read a pixel, bytes written a pixel)."""
    if dtype == torch.float32:
        return ()
    if narrowed(dtype) != dtype:
        return (("low 32 bits", dtype.itemsize, 4), ("float32", 4, 4))
    return (("float32", dtype.itemsize, 4),)


def denoise_plain(stack: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel: (B, H, W) any dtype -> float32."""
    x = to_float32(stack)
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


def check_shape(b: int, h: int, w: int) -> None:
    """Raises for a (b, h, w) stack the kernel's grid cannot hold: images
    along z and row strips along y (at most 65535 each), column strips
    along x, and rows and columns as int32."""
    strips = -(-h // STRIP_H)
    if b > _MAX_GRID_YZ or strips > _MAX_GRID_YZ:
        raise ValueError(f"(batch {b}, {strips} row strips) exceeds "
                         f"{_MAX_GRID_YZ} a grid dimension")
    if w > _MAX_INT32 - STRIP_W:
        raise ValueError(f"width {w} exceeds the kernel's int32 columns")


def plan(b: int, h: int, w: int, dtype: torch.dtype) -> _plan.Plan:
    """What :func:`launch` does for a contiguous (b, h, w) stack of
    ``dtype``, from the shape alone: a cast pass for a dtype the kernel
    does not read, the float32 image, one counted launch. Raises where
    ``launch`` would."""
    check_shape(b, h, w)
    n, itemsize = b * h * w, dtype.itemsize
    p = _plan.Plan(sources=("denoise",), operation="float32")
    if dtype not in _KERNEL_DTYPES:
        p += _plan.passes(n, to_float32_passes(dtype), operation="float32")
        itemsize = 4
    return (p + _plan.alloc("image", 4 * n, output=True, operation="float32")
            + _plan.launch("denoise", int(n > 0), denoise_work(n, itemsize),
                           "float32"))


def launch(stack: Tensor) -> Tensor:
    """The ``denoise`` CUDA kernel on a CUDA (B, H, W) stack."""
    if not stack.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{stack.device}")
    x = stack.contiguous()
    code = _KERNEL_DTYPES.get(x.dtype)
    if code is None:  # one device cast pass
        x, code = to_float32(x), 2
    b, h, w = x.shape
    check_shape(b, h, w)
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
