"""Weight-only int8 quantization for the serve path: the port's counterpart
of ``repro.models.quant``.

Per-group-slice symmetric per-tensor quantization of the stacked layer
tree: each stacked leaf (G, ...) gets a per-group scale (G,), so decode
dequantizes one group's slice with one scalar multiply. The embedding,
final norm and lm_head stay in ``param_dtype``.

The reference's arithmetic, bit for bit: the quantized values divide by a
scale clamped at 1e-12, the returned scale is the unclamped one (an
all-zero leaf has scale 0 and dequantizes to 0), and ``torch.round``
rounds half to even as ``jnp.round`` does. A leaf that cannot be
quantized (fewer than 2 dims, or not floating) passes through and its
scale is ``None``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.layers import tree_map

Tensor = torch.Tensor


def _is_quantizable(leaf) -> bool:
    # stacked layer leaves are (G, ...) float tensors with >= 2 dims
    return (isinstance(leaf, Tensor) and leaf.ndim >= 2
            and leaf.dtype.is_floating_point)


def _absmax_over_group(leaf: Tensor) -> Tensor:
    return torch.amax(torch.abs(leaf.float()),
                      dim=tuple(range(1, leaf.ndim))) / 127.0


def quantize_layers(layers: Any) -> Tuple[Any, Any]:
    """(int8 tree, per-group scale tree). Non-quantizable leaves pass
    through (their scale is ``None``)."""

    def q(leaf):
        if not _is_quantizable(leaf):
            return leaf
        scale = torch.clamp(_absmax_over_group(leaf), min=1e-12)
        shape = (-1,) + (1,) * (leaf.ndim - 1)
        return torch.round(leaf.float() / scale.reshape(shape)).to(
            torch.int8)

    def s(leaf):
        return _absmax_over_group(leaf) if _is_quantizable(leaf) else None

    return tree_map(q, layers), tree_map(s, layers)


def abstract_quantized_layers(layers: Any) -> Tuple[Any, Any]:
    """The same trees on ``meta`` from an abstract layer tree."""

    def q(leaf):
        if _is_quantizable(leaf):
            return torch.empty(leaf.shape, dtype=torch.int8, device="meta")
        return leaf

    def s(leaf):
        if _is_quantizable(leaf):
            return torch.empty((leaf.shape[0],), dtype=torch.float32,
                               device="meta")
        return None

    return tree_map(q, layers), tree_map(s, layers)


def scale_logical_axes(layer_axes: Any) -> Any:
    """Axes tree for the scales: ('layers',) for quantized leaves."""
    return tree_map(
        lambda axes: ("layers",) if len(axes) >= 2 else None, layer_axes)


def dequantize_group(gp_q: Any, gp_scale: Any, dtype: torch.dtype) -> Any:
    """Dequantize one group's slice: q (...) int8, scale scalar -> dtype.
    A leaf whose scale is ``None`` passes through."""
    if isinstance(gp_q, dict):
        return {k: dequantize_group(v, gp_scale[k], dtype)
                for k, v in gp_q.items()}
    if gp_scale is None:
        return gp_q
    return (gp_q.float() * gp_scale).to(dtype)
