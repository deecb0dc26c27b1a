"""Plain-torch oracles for the yCHG kernels.

The port's counterpart of ``repro.kernels.ref``: the kernel math restated
with plain torch ops, for tests that sweep shapes and dtypes and assert
exact equality. They share no code with ``repro_torch.core.ychg``, so that
a fault in one implementation cannot hide in both; even the foreground
test is written another way (by magnitude, where ``core.ychg`` reads the
exponent bits).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_FLT_MIN = torch.finfo(torch.float32).tiny  # the smallest normal float32


def _nonzero(img: Tensor) -> Tensor:
    """Foreground as the reference's XLA decides it: float32 (and float64,
    rounded to float32 first) below the smallest normal magnitude is
    background; NaN is foreground. 64-bit integers count by their low 32
    bits, as ``jnp.asarray`` keeps them with x64 off."""
    if img.dtype in (torch.int64, torch.uint64):
        img = img.view(torch.int64) & 0xFFFFFFFF
    if img.dtype == torch.float64:
        img = img.float()
    if img.dtype == torch.float32:
        return (img.abs() >= _FLT_MIN) | torch.isnan(img)
    return img != 0


def colscan_runs_ref(img: Tensor) -> Tensor:
    """(H, W) mask -> (W,) int32 maximal-run counts per column."""
    x = _nonzero(img).to(torch.int32)
    # rising edges scanning down each column; row 0 compares against 0
    interior = torch.clamp(x[1:, :] - x[:-1, :], 0, 1)
    return x[0, :] + torch.sum(interior, dim=0, dtype=torch.int32)


def transitions_ref(runs: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(W,) int32 -> (transitions bool, births int32, deaths int32), with
    runs[-1] := 0."""
    prev = torch.cat([torch.zeros((1,), dtype=runs.dtype,
                                  device=runs.device), runs[:-1]])
    delta = (runs - prev).to(torch.int32)
    return (delta != 0, torch.clamp(delta, min=0),
            torch.clamp(-delta, min=0))


def analyze_ref(img: Tensor) -> dict[str, Tensor]:
    runs = colscan_runs_ref(img)
    t, b, d = transitions_ref(runs)
    return {
        "runs": runs,
        "transitions": t,
        "births": b,
        "deaths": d,
        "n_hyperedges": torch.sum(b, dtype=torch.int32),
    }
