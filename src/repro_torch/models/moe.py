"""Mixture-of-Experts channel mixer: the port's counterpart of
``repro.models.moe``.

Sort-based capacity dispatch ("dispatch"): top-k routing, each entry's
rank within its expert by a stable sort, a scatter into (E, C, d) expert
buffers, batched expert matmuls, and a gather/combine back. Tokens past
capacity are dropped (GShard semantics); the Switch load-balancing aux
loss is returned for training. Every integer decision is the reference's:
a stable argsort (JAX's is stable), ranks from ``searchsorted(side=
"left")``, the capacity ``max(ceil(cf * T * k / E), 8)``, the sentinel
drop row at ``E * cap``, and the scatter an add (``index_add``).

Routing flavours:
  softmax top-k, renormalised (phi3.5-moe, jamba)      — experts_per_token=2
  sigmoid top-1 + shared expert (llama4-maverick)      — experts_per_token=1

``moe_impl="alltoall"`` is the reference's expert-parallel path: under a
mesh whose ``model`` axis is larger than 1, when the local token count
divides by it (``alltoall_applies``, the reference's condition), each
rank routes its own slice of its batch shard, sends only the routed
tokens to the experts' ranks and back with two ``all_to_all_single``
calls over the ``model`` group, FSDP-gathers its experts' weights over
``data``, and all-gathers the slices. The reference's ``shard_map`` body
becomes explicit local work on ``DTensor.to_local()`` shards: the two
exchanges are the autograd-aware ``all_to_all_single`` of
``torch.distributed.nn.functional``, the gathers DTensor redistributes
(whose gradients ``to_local(grad_placements=...)`` marks partial where
each rank holds a part), so a gradient flows through it. Everywhere else
every ``moe_impl`` takes the dispatch path, as the reference does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import (
    Builder,
    Sharder,
    einsum,
    einsum_f32,
    on_replicated,
)
from repro_torch.models.mlp import init_mlp, mlp_apply
from repro_torch.sharding.logical import PartitionSpec, mesh_shape, placements

Tensor = torch.Tensor


def init_moe(b: Builder, cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        # router replicated: tiny, and the all-to-all path routes locally
        "router": b.make((d, e), (None, None), init="normal", scale=0.02),
        "w_gate": b.make((e, d, f), ("experts", "embed", "mlp")),
        "w_up": b.make((e, d, f), ("experts", "embed", "mlp")),
        "w_down": b.make((e, f, d), ("experts", "mlp", "embed")),
    }
    if getattr(cfg, "moe_shared_experts", 0) or cfg.name.startswith("llama4"):
        p["shared"] = init_mlp(b, cfg)
    return p


def _route(p: dict, xt: Tensor, cfg) -> Tuple[Tensor, Tensor, Tensor]:
    """xt: (T, d) -> (gates (T,k), idx (T,k), aux_loss scalar)."""
    logits = einsum_f32("td,de->te", xt, p["router"])
    k = cfg.experts_per_token
    if k == 1 and "shared" in p:   # llama4: sigmoid gate on the top-1 expert
        top_val, top_idx = torch.topk(logits, 1, dim=-1)
        gates = torch.sigmoid(top_val)
        probs = torch.softmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, top_idx = torch.topk(probs, k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load balancing aux loss
    e = cfg.num_experts
    me = torch.mean(probs, dim=0)   # (E,)
    ce = torch.mean(torch.nn.functional.one_hot(top_idx[:, 0], e).float(),
                    dim=0)
    aux = e * torch.sum(me * ce)
    return gates, top_idx, aux


def alltoall_applies(cfg, mesh, shape) -> bool:
    """Whether ``moe_apply`` takes the all-to-all path for an input of
    ``shape`` (B, S, d): ``moe_impl="alltoall"``, a mesh whose ``model``
    axis is larger than 1, and a local token count (the batch shard's
    tokens) that divides by it; the reference's condition."""
    if cfg.moe_impl != "alltoall" or mesh is None:
        return False
    sizes = mesh_shape(mesh)
    tp = sizes.get("model", 1)
    b_, s = shape[0], shape[1]
    dp = 1
    for ax in ("pod", "data"):
        dp *= sizes.get(ax, 1)
    t_loc = (b_ // dp) * s if b_ % dp == 0 else 0
    return tp > 1 and t_loc % tp == 0


def moe_apply(p: dict, x: Tensor, cfg, shd: Sharder) -> Tuple[Tensor, Tensor]:
    """x: (B,S,d) -> (y, aux_loss). Dispatches on cfg.moe_impl."""
    if alltoall_applies(cfg, shd.mesh, x.shape):
        return moe_apply_alltoall(p, x, cfg, shd)
    return moe_apply_dispatch(p, x, cfg, shd)


def capacity(cfg, tokens: int) -> int:
    """Slots an expert: cf x the mean load, floored at 8 so tiny decode
    batches keep headroom."""
    k, e = cfg.experts_per_token, cfg.num_experts
    return max(-(-int(cfg.moe_capacity_factor * tokens * k) // e), 8)


def dispatch_slots(idx: Tensor, e: int, cap: int) -> Tensor:
    """(T, k) expert ids -> (T*k,) buffer rows, ``e * cap`` for a dropped
    entry: each entry's rank within its expert, in token order."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first_of_group = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(flat_e.numel(), device=idx.device) \
        - first_of_group
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return torch.where(rank < cap, flat_e * cap + rank,
                       torch.full_like(rank, e * cap))


def moe_apply_dispatch(p: dict, x: Tensor, cfg,
                       shd: Sharder) -> Tuple[Tensor, Tensor]:
    """Sort+scatter capacity dispatch."""
    b_, s, d = x.shape
    t = b_ * s
    k = cfg.experts_per_token
    e = cfg.num_experts
    xt = x.reshape(t, d)
    gates, idx, aux = _route(p, xt, cfg)
    cap = capacity(cfg, t)
    slot = on_replicated(shd, lambda i: dispatch_slots(i, e, cap), idx)

    x_rep = torch.repeat_interleave(xt, k, dim=0)   # (T*k, d)
    # every token into the global buffer: its rows from every rank
    buf = on_replicated(shd, lambda xr, sl: xr.new_zeros(
        (e * cap + 1, d)).index_add(0, sl, xr), x_rep, slot)
    buf = buf[: e * cap].reshape(e, cap, d)
    buf = shd(buf, ("experts", None, "act_embed"))

    h = torch.nn.functional.silu(einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * einsum("ecd,edf->ecf", buf, p["w_up"])
    h = shd(h, ("experts", None, "act_mlp"))
    out_buf = einsum("ecf,efd->ecd", h, p["w_down"])

    # each entry's row back, dropped entries picking the zero row: the
    # gather by a replicated slot index over every rank's rows
    y_rep = on_replicated(shd, lambda o, sl: torch.cat(
        [o, o.new_zeros((1, d))], dim=0)[sl], out_buf.reshape(e * cap, d),
        slot)
    y = (y_rep.reshape(t, k, d) * gates[..., None].to(x.dtype)).sum(dim=1)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg, shd).reshape(t, d)
    return y.reshape(b_, s, d), aux


# ---------------------------------------------------------------------------
# expert-parallel path: explicit all-to-all over the "model" axis. The
# dispatch above leaves the token -> expert exchange to DTensor, which
# gathers the whole (E, C, d) buffer; here every rank routes its own token
# slice, exchanges only routed token rows over "model" (there and back),
# and gathers its local experts' FSDP-sharded weights explicitly.


def _local(x: Tensor, spec: PartitionSpec, mesh, grad_placements) -> Tensor:
    """This rank's shard of DTensor ``x`` laid out by ``spec``, as a plain
    tensor. ``grad_placements`` says how the local gradients combine into
    ``x``'s: ``Partial()`` on a mesh axis whose ranks each hold a part of
    the gradient of the same values."""
    return x.redistribute(mesh, placements(spec, mesh)).to_local(
        grad_placements=grad_placements)


def moe_apply_alltoall(p: dict, x: Tensor, cfg,
                       shd: Sharder) -> Tuple[Tensor, Tensor]:
    """x: (B,S,d) DTensor -> (y, aux). Requires shd.mesh with a "model"
    axis."""
    import torch.distributed.nn.functional as dnn
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.layers import as_dtensor

    mesh = shd.mesh
    sizes = mesh_shape(mesh)
    names = mesh.mesh_dim_names
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    tp = sizes["model"]
    e, k = cfg.num_experts, cfg.experts_per_token
    e_loc = e // tp
    assert e % tp == 0, (e, tp)
    b_, s, d = x.shape
    x_spec = PartitionSpec(batch_axes or None)
    model_group = mesh.get_group("model")
    partial = [Partial()] * mesh.ndim

    # x_blk: (B_loc, S, d), the same on every "model" rank, each of which
    # routes its own token slice (so its gradient is a part over "model")
    x_blk = _local(as_dtensor(x, mesh), x_spec, mesh,
                   [Partial() if a == "model" else Shard(0) if a in
                    batch_axes else Replicate() for a in names])
    router = _local(as_dtensor(p["router"], mesh), PartitionSpec(), mesh,
                    partial)
    # each rank's experts' weights, FSDP-gathered over the batch axes (the
    # transpose reduce-scatters their gradients)
    experts = [Shard(0) if a == "model" else Partial() for a in names]
    wg = _local(p["w_gate"], PartitionSpec("model"), mesh, experts)
    wu = _local(p["w_up"], PartitionSpec("model"), mesh, experts)
    wd = _local(p["w_down"], PartitionSpec("model"), mesh, experts)

    t_loc = x_blk.shape[0] * x_blk.shape[1]
    tpd = t_loc // tp
    my = mesh.get_local_rank("model")
    xs = x_blk.reshape(t_loc, d)[my * tpd:(my + 1) * tpd]

    logits = einsum_f32("td,de->te", xs, router)
    if k == 1 and cfg.name.startswith("llama4"):
        top_val, top_idx = torch.topk(logits, 1, dim=-1)
        gates = torch.sigmoid(top_val)
        probs = torch.softmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, top_idx = torch.topk(probs, k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    cap = max(-(-int(cfg.moe_capacity_factor * tpd * k) // e), 4)
    slot = dispatch_slots(top_idx, e, cap)
    x_rep = torch.repeat_interleave(xs, k, dim=0)
    buf = xs.new_zeros((e * cap + 1, d)).index_add(0, slot, x_rep)[: e * cap]
    # (E*cap, d) -> (tp, E_loc*cap, d): destination-major
    recv = dnn.all_to_all_single(torch.empty_like(buf), buf,
                                 group=model_group)
    # rows from every source rank, this rank's experts only
    hbuf = recv.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, tp * cap, d)
    h = torch.nn.functional.silu(einsum("ecd,edf->ecf", hbuf, wg))
    h = h * einsum("ecd,edf->ecf", hbuf, wu)
    obuf = einsum("ecf,efd->ecd", h, wd)
    back = obuf.reshape(e_loc, tp, cap, d).transpose(0, 1).reshape(
        e * cap, d)
    ret = dnn.all_to_all_single(torch.empty_like(back), back,
                                group=model_group)
    flat = torch.cat([ret, ret.new_zeros((1, d))], dim=0)
    y_rep = flat[slot]
    ys = (y_rep.reshape(tpd, k, d) * gates[..., None].to(x_blk.dtype)
          ).sum(dim=1)
    # the whole local token set again, across the model axis: the slices
    # lie (batch axes, then model) major to minor along the token axis
    y = DTensor.from_local(
        ys, mesh, placements(PartitionSpec((*batch_axes, "model")), mesh),
        run_check=False).redistribute(
            mesh, placements(x_spec, mesh)).to_local()
    y = DTensor.from_local(y.reshape(x_blk.shape), mesh,
                           placements(x_spec, mesh), run_check=False)
    # aux loss (switch-style), averaged over every rank's token slice
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(top_idx[:, 0], e).float(),
                    dim=0)
    aux = e * torch.sum(me * ce) / mesh.size()
    aux = DTensor.from_local(aux, mesh, partial, run_check=False
                             ).redistribute(mesh, [Replicate()] * mesh.ndim)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg, shd)
    return y, aux
