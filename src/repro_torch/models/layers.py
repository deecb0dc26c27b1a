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

Under a mesh, ``Sharder`` lays activations out as DTensors and the model
code runs on them (inside ``meshed``). Where DTensor has no sharding
strategy for an op, or cannot take its operands' layout, the call site
goes through ``on_replicated``, which gathers its operands to
``Replicate()`` first; the dry run reckons each site's all-gather
(``launch.dryrun.reckon_collectives``). The sites:

  * ``models/moe.py::moe_apply_dispatch``, the expert slots
    (``dispatch_slots``: ``aten.searchsorted`` has no strategy), the
    expert buffer (``index_add`` of the routed rows) and the rows' way
    back (indexing by the slots), whose forward and backward torch 2.11
    miscounts against a batch-split operand;
  * ``models/rwkv.py::_ddlerp``, the reshape of the five mixing loras'
    output (B, S, 5 x lora) to (B, S, 5, lora), whose last dim DTensor
    may split over "model" unevenly for the unflatten.

A computation that is independent along the dims it splits (the
attention core for each batch row and head, the rwkv recurrence and the
mamba scan for each batch row and head or channel) runs on each rank's
shards through ``on_shards``: no communication, and none of DTensor's
propagation inside (torch 2.11's refuses to flatten two split dims).
The embedding lookup in a vocab-split table is ``vocab_lookup``: each
rank looks up the tokens of its vocab range, and one all-reduce of the
(B_loc, S, d) rows over the vocab split sums them. The cross-entropy over
vocab-split logits is ``vocab_nll``: three (B_loc, S) all-reduces, the
logits never gathered.
``write_index`` writes one decode position into a cache in place; on a
DTensor cache, into the local shard that holds the position.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
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
    return _contract(eq, a.to(dt), b.to(dt))


def einsum_f32(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """JAX's ``einsum(..., preferred_element_type=float32)``: accumulated
    in and returned as float32, whatever the operands' dtype."""
    return _contract(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# activation rematerialization
#
# The contraction in flight: whether the product ``einsum``/``einsum_f32``
# is issuing has no batch dimension (no index in both operands and the
# output), which is what ``dots_saveable`` saves.
_DOTS = threading.local()
_DOT_OPS = ("mm", "bmm")


@functools.lru_cache(maxsize=None)
def _no_batch_dims(eq: str) -> bool:
    ins, out = eq.replace(" ", "").split("->")
    lhs, rhs = ins.split(",")
    return not set(lhs) & set(rhs) & set(out)


def _contract(eq: str, a: Tensor, b: Tensor) -> Tensor:
    _DOTS.saveable = _no_batch_dims(eq)
    try:
        return torch.einsum(eq, a, b)
    finally:
        _DOTS.saveable = False


def dots_saveable(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``, the reference's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
    matrix product of an ``einsum``/``einsum_f32`` with no batch dimension
    (a projection ``bsd,de->bse``) is saved, everything else (attention's
    ``bqhd,bkhd->bhqk``, the experts' ``ecd,edf->ecf``, the recurrences'
    products, every elementwise op) is recomputed. The aten op alone
    cannot tell them apart: ``torch.einsum`` issues ``bmm`` for both."""
    from torch.utils.checkpoint import CheckpointPolicy

    if (getattr(_DOTS, "saveable", False)
            and op.overloadpacket.__name__ in _DOT_OPS):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def records(*tensors) -> bool:
    """Whether autograd records a graph through any of ``tensors``: grad
    mode on and one of them requiring grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, Tensor) and t.requires_grad for t in tensors)


def checkpointed(fn: Callable, *args, context_fn: Optional[Callable] = None):
    """``fn(*args)`` under ``torch.utils.checkpoint``: the tensors its
    forward saves are dropped and recomputed in the backward; only the
    tensor arguments are kept. Non-reentrant, because ``train.step`` takes
    its gradients with ``torch.autograd.grad``. The model draws no random
    numbers, so no RNG state is stashed. ``context_fn`` is the selective
    policy's (``remat="dots"``)."""
    import torch.utils.checkpoint as ckpt

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


def chunk_scan(fn: Callable, state: Tensor, seqs: Tuple[Tensor, ...],
               chunk: int, *consts: Tensor):
    """A recurrence over dim 1 of each (B, S, ...) tensor in ``seqs``, in
    pieces of ``chunk`` steps (the last may be short): ``fn(state,
    *pieces, *consts) -> (state, out)``, each piece's (B, L, ...) ``out``
    joined along dim 1. Where autograd records, each piece runs under
    ``checkpointed``: the backward keeps one state a piece, not one a
    step, and recomputes the piece's steps, as the reference's
    ``jax.checkpoint`` of a chunk does. Returns (the joined outputs, None
    for S = 0; the last state)."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, not {chunk}")
    keep = records(state, *seqs, *consts)
    outs = []
    for start in range(0, seqs[0].shape[1], chunk):
        pieces = [t[:, start:start + chunk] for t in seqs]
        if keep:
            state, out = checkpointed(fn, state, *pieces, *consts)
        else:
            state, out = fn(state, *pieces, *consts)
        outs.append(out)
    return (torch.cat(outs, dim=1) if outs else None), state


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
    marks where an activation's layout matters, the counterpart of the
    reference's ``with_sharding_constraint``.

    A no-op unless constructed with (mesh, rules). With a
    ``torch.distributed.device_mesh.DeviceMesh`` and a rule table, ``x`` is
    redistributed to the placements of ``spec_for(axes, rules, mesh,
    x.shape)``; a plain tensor is taken as replicated over the mesh, as
    ``implicit_replication`` takes the plain tensors a meshed step makes
    (positions, masks, fresh caches), which the step entry points enter
    (``meshed``).
    """

    def __init__(self, mesh=None, rules=None):
        self.mesh = mesh
        self.rules = rules

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.rules is not None

    def __call__(self, x: Tensor, axes: Tuple[Optional[str], ...]) -> Tensor:
        if not self.active:
            return x
        from repro_torch.sharding.logical import placements, spec_for

        spec = spec_for(axes, self.rules, self.mesh, x.shape)
        return as_dtensor(x, self.mesh).redistribute(
            self.mesh, placements(spec, self.mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def as_dtensor(x: Tensor, mesh):
    """``x`` if it is a DTensor, else ``x`` replicated over ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def meshed(shd: "Sharder"):
    """The context a meshed step runs in: ``implicit_replication`` when
    ``shd`` has a mesh (plain tensors the step makes mix with DTensors as
    replicated ones), else nothing."""
    import contextlib

    if not shd.active:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def on_replicated(shd: "Sharder", fn: Callable, *args):
    """``fn(*args)`` at a site whose op has no DTensor sharding strategy,
    or cannot take its operands' sharding: with a mesh, every DTensor
    operand is gathered to ``Replicate()`` and ``fn`` runs on the local
    tensors; its output comes back as a replicated DTensor (autograd flows
    through both conversions). This is what the partitioner does
    with an op it cannot split. Without a mesh it is ``fn(*args)``."""
    if not shd.active:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * shd.mesh.ndim
    local = [a.redistribute(shd.mesh, rep).to_local()
             if isinstance(a, DTensor) else a for a in args]
    return DTensor.from_local(fn(*local), shd.mesh, rep, run_check=False)


def on_shards(shd: "Sharder", fn: Callable, in_axes, out_like, *args):
    """``fn`` on this rank's shards, for a computation that is independent
    along the dims it splits (attention for each batch row and head, a
    recurrence for each batch row and channel): each operand is laid out
    by its logical axes in ``in_axes`` (``spec_for`` on its own shape) and
    ``fn`` gets its local shard; output ``j`` takes the layout of operand
    ``out_like[j]`` (an int: one output). No communication beyond laying
    the operands out, and no DTensor propagation inside ``fn``. A
    replicated operand's gradient is partial over the mesh axes the
    outputs split (each rank adds its rows' part). Without a mesh it is
    ``fn(*args)``."""
    if not shd.active:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.sharding.logical import placements, spec_for

    mesh = shd.mesh
    lay = [placements(spec_for(axes, shd.rules, mesh, a.shape), mesh)
           for axes, a in zip(in_axes, args)]
    single = isinstance(out_like, int)
    out_lay = [lay[i] for i in ((out_like,) if single else out_like)]
    split = {m for pl in out_lay for m, p in enumerate(pl) if p.is_shard()}
    local = []
    for a, pl in zip(args, lay):
        grad = [Partial() if m in split and not p.is_shard() else p
                for m, p in enumerate(pl)]
        local.append(as_dtensor(a, mesh).redistribute(mesh, pl).to_local(
            grad_placements=grad))
    out = fn(*local)
    outs = tuple(DTensor.from_local(t, mesh, pl, run_check=False)
                 for t, pl in zip((out,) if single else out, out_lay))
    return outs[0] if single else outs


def vocab_lookup(shd: "Sharder", table: Tensor, tokens: Tensor) -> Tensor:
    """``table[tokens]``: rows of a (V, d) table for (B, S) tokens. Under a
    mesh, a vocab-parallel lookup: the table is laid out split along its
    vocab as the rules split "vocab" (whole along d), the tokens as
    ("act_batch", "act_seq"); each rank looks up the tokens that fall in
    its vocab range and zeroes the rest, and one all-reduce of the
    (B_loc, S, d) rows over the vocab split sums them. A mesh axis that
    splits the tokens keeps the table whole along it. The table's
    gradient is partial over the tokens' split; the rows' gradient comes
    back through the all-reduce unchanged (it is replicated)."""
    if not shd.active:
        return table[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.sharding.logical import placements, spec_for

    mesh = shd.mesh
    tok_lay = placements(spec_for(("act_batch", "act_seq"), shd.rules, mesh,
                                  tokens.shape), mesh)
    vocab_lay = placements(spec_for(("vocab", None), shd.rules, mesh,
                                    table.shape), mesh)
    table_lay = [Shard(0) if v.is_shard() and not t.is_shard()
                 else Replicate() for v, t in zip(vocab_lay, tok_lay)]
    grad = [Partial() if t.is_shard() else p
            for p, t in zip(table_lay, tok_lay)]
    placed = as_dtensor(table, mesh).redistribute(mesh, table_lay)
    start = shard_start(placed, 0)
    local = placed.to_local(grad_placements=grad)
    tok = as_dtensor(tokens, mesh).redistribute(
        mesh, tok_lay).to_local().long() - start
    inside = (tok >= 0) & (tok < local.shape[0])
    rows = local[tok.clamp(0, local.shape[0] - 1)].masked_fill(
        ~inside[..., None], 0)
    partial = [Partial() if p.is_shard() else t
               for p, t in zip(table_lay, tok_lay)]
    summed = [Replicate() if p.is_partial() else p for p in partial]
    return DTensor.from_local(rows, mesh, partial,
                              run_check=False).redistribute(mesh, summed)


def vocab_nll(shd: "Sharder", logits: Tensor, labels: Tensor) -> Tensor:
    """-log softmax(logits)[labels] in float32: (B, S, V) logits, (B, S)
    labels in [0, V). Under a mesh, a vocab-parallel cross-entropy: the
    logits are laid out as ("act_batch", "act_seq", "act_vocab"), each
    rank works on its vocab shard, and three (B_loc, S) float32
    all-reduces over the vocab split give the max (no gradient), the
    softmax's sum and the labels' logits. The logits are never
    gathered."""
    if not shd.active:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.sharding.logical import placements, spec_for

    mesh = shd.mesh
    lay = placements(spec_for(("act_batch", "act_seq", "act_vocab"),
                              shd.rules, mesh, logits.shape), mesh)
    rows = [p if p.is_shard() and p.dim < 2 else Replicate() for p in lay]
    placed = as_dtensor(logits, mesh).redistribute(mesh, lay)
    start = shard_start(placed, 2)
    x = placed.to_local(grad_placements=lay).float()
    lab = as_dtensor(labels, mesh).redistribute(
        mesh, rows).to_local().long() - start
    inside = (lab >= 0) & (lab < x.shape[-1])

    def over_vocab(t: Tensor, op: str = "sum") -> Tensor:
        part = [Partial(op) if p.is_shard() and p.dim == 2 else r
                for p, r in zip(lay, rows)]
        return DTensor.from_local(t, mesh, part, run_check=False
                                  ).redistribute(mesh, rows).to_local(
                                      grad_placements=rows)

    m = over_vocab(x.detach().amax(-1), "max")
    total = over_vocab(torch.exp(x - m[..., None]).sum(-1))
    picked = over_vocab(torch.gather(
        x, -1, lab.clamp(0, x.shape[-1] - 1)[..., None])[..., 0].masked_fill(
            ~inside, 0))
    return DTensor.from_local(torch.log(total) + m - picked, mesh, rows,
                              run_check=False)


def shard_start(x, dim: int) -> int:
    """The global index of the first element of this rank's shard of
    DTensor ``x`` along ``dim`` (even shards, mesh axes major to minor,
    as ``sharding.logical.placements`` lays them out)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    piece, count = 0, 1
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            piece = piece * mesh.size(m) + mesh.get_local_rank(m)
            count *= mesh.size(m)
    if x.shape[dim] % count:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not split "
                         f"evenly over {count} shards")
    return piece * (x.shape[dim] // count)


def write_index(cache: Tensor, dim: int, index: int, value: Tensor) -> None:
    """``cache.select(dim, index).copy_(value)``, in place. On a DTensor
    cache the write lands on the local shard that holds position
    ``index`` (a cache sharded along its sequence, as the decode rules
    shard it, keeps each position on one rank of the axis); ``value`` is
    first laid out as the cache is, without ``dim``."""
    if not is_dtensor(cache):
        cache.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    lay = []
    for p in cache.placements:
        if isinstance(p, Shard) and p.dim == dim:
            lay.append(Replicate())
        elif isinstance(p, Shard) and p.dim > dim:
            lay.append(Shard(p.dim - 1))
        else:
            lay.append(p)
    local_value = as_dtensor(value, mesh).redistribute(mesh, lay).to_local()
    local = cache.to_local()
    start = shard_start(cache, dim)
    if start <= index < start + local.shape[dim]:
        local.select(dim, index - start).copy_(local_value)


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
