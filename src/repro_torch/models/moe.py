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

``moe_impl="alltoall"`` is the reference's expert-parallel path under a
mesh with a ``model`` axis; without a mesh it takes the dispatch path, as
the reference does, and a mesh is not ported yet (ROADMAP 6e).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import Builder, Sharder, einsum
from repro_torch.models.mlp import init_mlp, mlp_apply

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
    logits = torch.einsum("td,de->te", xt.float(), p["router"].float())
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


def moe_apply(p: dict, x: Tensor, cfg, shd: Sharder) -> Tuple[Tensor, Tensor]:
    """x: (B,S,d) -> (y, aux_loss). Without a mesh every ``moe_impl`` is
    the dispatch path (a ``Sharder`` with a mesh raises, ROADMAP 6e)."""
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
    slot = dispatch_slots(idx, e, cap)

    x_rep = torch.repeat_interleave(xt, k, dim=0)   # (T*k, d)
    buf = x.new_zeros((e * cap + 1, d)).index_add(0, slot, x_rep)
    buf = buf[: e * cap].reshape(e, cap, d)
    buf = shd(buf, ("experts", None, "act_embed"))

    h = torch.nn.functional.silu(einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * einsum("ecd,edf->ecf", buf, p["w_up"])
    h = shd(h, ("experts", None, "act_mlp"))
    out_buf = einsum("ecf,efd->ecd", h, p["w_down"])

    flat_out = out_buf.reshape(e * cap, d)
    flat_out = torch.cat([flat_out, flat_out.new_zeros((1, d))], dim=0)
    y_rep = flat_out[slot]   # dropped entries pick the zero row
    y = (y_rep.reshape(t, k, d) * gates[..., None].to(x.dtype)).sum(dim=1)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg, shd).reshape(t, d)
    return y.reshape(b_, s, d), aux
