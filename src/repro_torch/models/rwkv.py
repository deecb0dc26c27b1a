"""RWKV-6 "Finch" blocks: the port's counterpart of ``repro.models.rwkv``.
Time-mix (data-dependent decay linear attention) and channel-mix.
Attention-free: the recurrent state (B, H, K, V) replaces a KV cache.

Recurrence per head (K = V = head dim):
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), data-dependent)
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Token-shift uses the data-dependent linear interpolation (ddlerp) of
RWKV-6 with low-rank adapters. The reference scans the sequence in chunks
of ``ssm_chunk`` steps padded with identity steps (w = 1, k = 0); the port
runs the same steps one at a time, in float32, and needs no padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import (
    Builder,
    Sharder,
    einsum,
    groupnorm_heads,
    on_replicated,
    on_shards,
)

Tensor = torch.Tensor

# the recurrence's layout under a mesh: each batch row and head runs on
# its own (r/k/v/w (B,S,H,K), the bonus (H,K), the state (B,H,K,V))
STEP_AXES = ("act_batch", None, "act_heads", None)
HEAD_AXES = ("act_heads", None)
STATE_AXES = ("act_batch", "act_heads", None, None)

_MIX_NAMES = ("w", "k", "v", "r", "g")


def num_heads_of(cfg) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def init_rwkv_time(b: Builder, cfg) -> dict:
    d = cfg.d_model
    lr = cfg.rwkv_mix_lora
    dr = cfg.rwkv_decay_lora
    h = num_heads_of(cfg)
    k = cfg.rwkv_head_dim
    return {
        "mu_x": b.make((d,), (None,), init="zeros"),
        "mix_w1": b.make((d, len(_MIX_NAMES) * lr), ("embed", None)),
        "mix_w2": b.make((len(_MIX_NAMES), lr, d), (None, None, "embed"),
                         init="normal", scale=0.01),
        "mu": b.make((len(_MIX_NAMES), d), (None, None), init="zeros"),
        "w_r": b.make((d, d), ("embed", "heads_flat")),
        "w_k": b.make((d, d), ("embed", "heads_flat")),
        "w_v": b.make((d, d), ("embed", "heads_flat")),
        "w_g": b.make((d, d), ("embed", "heads_flat")),
        "w_o": b.make((d, d), ("heads_flat", "embed")),
        "decay_base": b.make((d,), (None,), init="zeros"),
        "decay_w1": b.make((d, dr), ("embed", None)),
        "decay_w2": b.make((dr, d), (None, "embed"), init="normal",
                           scale=0.01),
        "bonus_u": b.make((h, k), ("heads", None), init="zeros"),
        "ln_scale": b.make((h, k), ("heads", None), init="ones"),
        "ln_bias": b.make((h, k), ("heads", None), init="zeros"),
    }


def init_rwkv_channel(b: Builder, cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": b.make((d,), (None,), init="zeros"),
        "mu_r": b.make((d,), (None,), init="zeros"),
        "w_k": b.make((d, f), ("embed", "mlp")),
        "w_v": b.make((f, d), ("mlp", "embed")),
        "w_r": b.make((d, d), ("embed", "embed_out")),
    }


def _ddlerp(p: dict, x: Tensor, sx: Tensor, shd: Sharder) -> list:
    """Data-dependent token-shift interpolation -> one mixed x per
    quantity."""
    xx = x + sx * p["mu_x"]
    z = torch.tanh(einsum("bsd,dr->bsr", xx, p["mix_w1"]))
    # (B,S,5,lr): the five loras' outputs need not split over the mesh
    z = on_replicated(shd, lambda t: t.reshape(
        *t.shape[:-1], len(_MIX_NAMES), -1), z)
    adj = einsum("bsnr,nrd->bnsd", z, p["mix_w2"])           # (B,5,S,d)
    return [x + sx * (p["mu"][i] + adj[:, i])
            for i in range(len(_MIX_NAMES))]


def _time_mix_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                   s0: Tensor) -> Tuple[Tensor, Tensor]:
    """r/k/v/w: (B,S,H,K) float32; u: (H,K); s0: (B,H,K,V). Returns
    (out (B,S,H,K), s_last)."""
    st = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 st + u[..., None] * kv))
        st = w[:, t, :, :, None] * st + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return out, st


def _decay(p: dict, xw: Tensor) -> Tensor:
    dec = p["decay_base"] + einsum(
        "bsr,re->bse", einsum("bsd,dr->bsr", xw, p["decay_w1"]),
        p["decay_w2"])
    return torch.exp(-torch.exp(dec.float()))


def _project(p: dict, x: Tensor, sx: Tensor, h: int, kd: int,
             shd: Sharder):
    b_, s, _ = x.shape
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx, shd)
    r = einsum("bsd,de->bse", xr, p["w_r"]).reshape(b_, s, h, kd)
    k = einsum("bsd,de->bse", xk, p["w_k"]).reshape(b_, s, h, kd)
    v = einsum("bsd,de->bse", xv, p["w_v"]).reshape(b_, s, h, kd)
    g = torch.nn.functional.silu(einsum("bsd,de->bse", xg, p["w_g"]))
    w = _decay(p, xw).reshape(b_, s, h, kd)
    return r, k, v, g, w


def rwkv_time_forward(p: dict, x: Tensor, cfg, shd: Sharder,
                      state: Optional[dict] = None) -> Tuple[Tensor, dict]:
    """Train/prefill time-mix. x: (B,S,D)."""
    b_, s, d = x.shape
    h, kd = num_heads_of(cfg), cfg.rwkv_head_dim
    prev = (state["shift"][:, None, :] if state
            else x.new_zeros((b_, 1, d)))
    sx = torch.cat([prev, x[:, :-1, :]], dim=1) - x
    r, k, v, g, w = _project(p, x, sx, h, kd, shd)
    r = shd(r, ("act_batch", "act_seq", "act_heads", None))
    k = shd(k, ("act_batch", "act_seq", "act_heads", None))
    s0 = (state["wkv"] if state
          else torch.zeros((b_, h, kd, kd), dtype=torch.float32,
                           device=x.device))
    out, s_last = on_shards(
        shd, _time_mix_scan, (STEP_AXES,) * 4 + (HEAD_AXES, STATE_AXES),
        (0, 5), r.float(), k.float(), v.float(), w, p["bonus_u"].float(), s0)
    out = groupnorm_heads(out, p["ln_scale"], p["ln_bias"], cfg.norm_eps)
    out = out.reshape(b_, s, d).to(x.dtype) * g
    y = einsum("bse,ed->bsd", out, p["w_o"])
    new_state = {"wkv": s_last, "shift": x[:, -1, :]}
    return shd(y, ("act_batch", "act_seq", "act_embed")), new_state


def rwkv_time_decode(p: dict, x: Tensor, cfg, shd: Sharder, state: dict
                     ) -> Tuple[Tensor, dict]:
    """One-token step; state: wkv (B,H,K,V) float32, shift (B,D)."""
    b_, _, d = x.shape
    h, kd = num_heads_of(cfg), cfg.rwkv_head_dim
    sx = state["shift"][:, None, :] - x
    r, k, v, g, w = _project(p, x, sx, h, kd, shd)
    out, st = on_shards(
        shd, _time_mix_scan, (STEP_AXES,) * 4 + (HEAD_AXES, STATE_AXES),
        (0, 5), r.float(), k.float(), v.float(), w, p["bonus_u"].float(),
        state["wkv"])
    out, g = out[:, 0], g[:, 0]
    out = groupnorm_heads(out, p["ln_scale"], p["ln_bias"], cfg.norm_eps)
    out = (out.reshape(b_, d).to(x.dtype) * g)[:, None, :]
    y = einsum("bse,ed->bsd", out, p["w_o"])
    return y, {"wkv": st, "shift": x[:, -1, :]}


def _channel(p: dict, x: Tensor, sx: Tensor, shd: Sharder) -> Tensor:
    xk = x + sx * p["mu_k"]
    xr = x + sx * p["mu_r"]
    k = torch.square(torch.relu(einsum("bsd,df->bsf", xk, p["w_k"])))
    k = shd(k, ("act_batch", "act_seq", "act_mlp"))
    kv = einsum("bsf,fd->bsd", k, p["w_v"])
    return torch.sigmoid(einsum("bsd,de->bse", xr, p["w_r"])) * kv


def rwkv_channel_forward(p: dict, x: Tensor, cfg, shd: Sharder,
                         state: Optional[dict] = None) -> Tuple[Tensor, dict]:
    b_, s, d = x.shape
    prev = (state["shift"][:, None, :] if state
            else x.new_zeros((b_, 1, d)))
    sx = torch.cat([prev, x[:, :-1, :]], dim=1) - x
    return _channel(p, x, sx, shd), {"shift": x[:, -1, :]}


def rwkv_channel_decode(p: dict, x: Tensor, cfg, shd: Sharder, state: dict
                        ) -> Tuple[Tensor, dict]:
    sx = state["shift"][:, None, :] - x
    return _channel(p, x, sx, shd), {"shift": x[:, -1, :]}
