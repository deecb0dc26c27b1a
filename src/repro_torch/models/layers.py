"""Shared building blocks: param builder, norms, rope, embeddings, sharder.

The port's counterpart of ``repro.models.layers``.

Param convention: init functions return nested dicts whose leaves are
``P(value, axes)``; ``split_tree`` separates them into a value tree and a
logical-axes tree of identical structure. ``Builder`` works in concrete
mode (drawn from an explicit ``torch.Generator`` on the target device) or
abstract mode (tensors on the ``meta`` device: shapes and dtypes with no
storage, so a 400B-parameter tree costs nothing to build).

Trees are nested dicts; ``None`` is an empty subtree (the cache's
``channel`` entry of an attention layer) and anything else is a leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name as a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no quiet CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the LM path runs on the card by default and this process sees "
            "no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def same_device(t: Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def einsum(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """``torch.einsum`` with JAX's dtype promotion: both operands are cast
    to their common dtype first (bfloat16 with float32 gives float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def einsum_f32(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """JAX's ``einsum(..., preferred_element_type=float32)``: accumulated
    in and returned as float32, whatever the operands' dtype."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# trees


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Applies ``fn`` to every leaf of a nested-dict tree (and to the
    leaves at the same key paths of ``rest``, trees of its structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """Applies ``fn(key path, leaf)`` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(path, tree)


def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) for every leaf, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    elif tree is not None:
        yield path, tree


@dataclasses.dataclass
class P:
    value: Any
    axes: Tuple[Optional[str], ...]


def split_tree(tree):
    """P-leaf tree -> (value tree, logical-axes tree)."""
    return tree_map(lambda p: p.value, tree), tree_map(lambda p: p.axes, tree)


class Builder:
    """Creates parameters (concrete or abstract) with logical axes
    attached. Concrete parameters are drawn from ``generator`` on its
    device; abstract ones live on ``meta``."""

    def __init__(self, generator: Optional[torch.Generator], dtype: str,
                 abstract: bool = False):
        self.generator = generator
        self.dtype = torch_dtype(dtype)
        self.abstract = abstract
        self.device = (torch.device("meta") if abstract
                       else generator.device)

    def make(self, shape, axes, init: str = "fan_in",
             scale: float | None = None) -> P:
        assert len(shape) == len(axes), (shape, axes)
        shape = tuple(shape)
        kw = dict(dtype=self.dtype, device=self.device)
        if self.abstract:
            return P(torch.empty(shape, **kw), tuple(axes))
        if init == "zeros":
            v = torch.zeros(shape, **kw)
        elif init == "ones":
            v = torch.ones(shape, **kw)
        elif init == "normal":
            v = (scale if scale is not None else 0.02) * torch.randn(
                shape, generator=self.generator, **kw)
        elif init == "fan_in":
            # fan-in = product of all dims but the last
            fan_in = max(1, math.prod(shape[:-1]))
            v = torch.randn(shape, generator=self.generator,
                            **kw) / math.sqrt(fan_in)
        else:
            raise ValueError(init)
        return P(v, tuple(axes))


# ---------------------------------------------------------------------------
# sharding hook


class Sharder:
    """The model code's sharding hook: ``shd(x, ("act_batch", ...))``
    marks where an activation's layout matters. A no-op; a mesh is not
    ported yet (ROADMAP 6e)."""

    def __init__(self, mesh=None, rules=None):
        if mesh is not None:
            raise NotImplementedError(
                "Sharder with a mesh: logical sharding is not ported yet "
                "(ROADMAP 6e)")

    def __call__(self, x: Tensor, axes: Tuple[Optional[str], ...]) -> Tensor:
        return x


# ---------------------------------------------------------------------------
# norms: normalise in float32, cast back to the input dtype, then scale


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def layernorm(x: Tensor, scale: Tensor, bias: Optional[Tensor],
              eps: float) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * scale + (
        bias if bias is not None else 0)


def groupnorm_heads(x: Tensor, scale: Tensor, bias: Tensor,
                    eps: float) -> Tensor:
    """Per-head groupnorm over the last dim; x: (..., H, K)."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * scale + bias


def init_norm(b: Builder, d: int, norm_type: str) -> dict:
    out = {"scale": b.make((d,), (None,), init="ones")}
    if norm_type == "layernorm":
        out["bias"] = b.make((d,), (None,), init="zeros")
    return out


def apply_norm(p: dict, x: Tensor, norm_type: str, eps: float) -> Tensor:
    if norm_type == "layernorm":
        return layernorm(x, p["scale"], p.get("bias"), eps)
    return rmsnorm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# position embeddings


def rope_angles(positions: Tensor, dim: int,
                theta: float) -> tuple[Tensor, Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., dim//2)."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (..., S, H, K); cos/sin: (..., S, K//2) -> rotate-half rope,
    computed in float32 and cast back."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def sinusoidal_pos(positions: Tensor, d_model: int) -> Tensor:
    """(...,) int -> (..., d_model) fixed sinusoidal table (musicgen-style)."""
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# activations


def act_fn(name: str, x: Tensor) -> Tensor:
    if name == "gelu":   # jax.nn.gelu's default: the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "silu":
        return torch.nn.functional.silu(x)
    raise ValueError(name)
