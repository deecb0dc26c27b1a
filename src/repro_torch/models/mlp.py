"""Channel mixers: the dense MLP (swiglu / gelu). The port's counterpart
of ``repro.models.mlp``; the RWKV channel-mix is in ``models.rwkv``."""

from __future__ import annotations

import torch

from repro_torch.models.layers import Builder, Sharder, act_fn, einsum

Tensor = torch.Tensor


def init_mlp(b: Builder, cfg, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": b.make((d, f), ("embed", "mlp")),
            "w_up": b.make((d, f), ("embed", "mlp")),
            "w_down": b.make((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": b.make((d, f), ("embed", "mlp")),
        "b_up": b.make((f,), ("mlp",), init="zeros"),
        "w_down": b.make((f, d), ("mlp", "embed")),
        "b_down": b.make((d,), ("embed",), init="zeros"),
    }


def mlp_apply(p: dict, x: Tensor, cfg, shd: Sharder) -> Tensor:
    if cfg.mlp_act == "swiglu":
        h = torch.nn.functional.silu(einsum("bsd,df->bsf", x, p["w_gate"]))
        h = h * einsum("bsd,df->bsf", x, p["w_up"])
        h = shd(h, ("act_batch", "act_seq", "act_mlp"))
        return einsum("bsf,fd->bsd", h, p["w_down"])
    h = act_fn("gelu", einsum("bsd,df->bsf", x, p["w_up"]) + p["b_up"])
    h = shd(h, ("act_batch", "act_seq", "act_mlp"))
    return einsum("bsf,fd->bsd", h, p["w_down"]) + p["b_down"]
