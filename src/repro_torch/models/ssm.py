"""Mamba-1 selective SSM token mixer (jamba's mamba layers): the port's
counterpart of ``repro.models.ssm``.

The diagonal A makes the recurrence h_t = a_t * h_{t-1} + b_t with
elementwise a_t. The reference runs it as an associative scan inside
chunks of ``ssm_chunk`` steps and a ``lax.scan`` over the chunks; the port
runs the recurrence one step at a time, in float32, which is the same
arithmetic with the products and sums in another order (the tests state
the tolerance this needs). Padding with identity steps is not needed.

Decode carries (conv window, ssm state), both O(1) in sequence length.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import Builder, Sharder, einsum

Tensor = torch.Tensor


def d_inner_of(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_mamba(b: Builder, cfg) -> dict:
    d = cfg.d_model
    di = d_inner_of(cfg)
    n = cfg.ssm_state_dim
    r = cfg.ssm_dt_rank
    dc = cfg.ssm_conv_dim
    return {
        "w_in": b.make((d, 2 * di), ("embed", "mlp")),
        "conv_w": b.make((dc, di), (None, "mlp")),
        "conv_b": b.make((di,), ("mlp",), init="zeros"),
        "w_x_dt": b.make((di, r), ("mlp", None)),
        "w_dt": b.make((r, di), (None, "mlp")),
        "dt_bias": b.make((di,), ("mlp",), init="zeros"),
        "w_B": b.make((di, n), ("mlp", None)),
        "w_C": b.make((di, n), ("mlp", None)),
        "A_log": b.make((di, n), ("mlp", None), init="zeros"),
        "D": b.make((di,), ("mlp",), init="ones"),
        "w_out": b.make((di, d), ("mlp", "embed")),
    }


def _causal_conv(x: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """Depthwise causal conv along seq. x: (B,S,di), w: (dc,di)."""
    dc = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, dc - 1, 0))
    # windowed sum: y[t] = sum_j w[j] * x[t - (dc-1) + j]
    y = torch.zeros_like(x)
    for j in range(dc):
        y = y + xp[:, j: j + x.shape[1], :] * w[j]
    return y + bias


def selective_scan(dt: Tensor, B: Tensor, C: Tensor, xg: Tensor, A: Tensor,
                   h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """dt/xg: (B,S,di) float32; B/C: (B,S,N); A: (di,N). Returns
    (y (B,S,di), h_last (B,di,N)), both float32."""
    b_, s, di = xg.shape
    n = B.shape[-1]
    h = (torch.zeros((b_, di, n), dtype=torch.float32, device=xg.device)
         if h0 is None else h0)
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t, :, None] * A)                     # (B,di,N)
        bx = (dt[:, t] * xg[:, t])[..., None] * B[:, t, None, :]
        h = a * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else xg.new_zeros((b_, 0, di), dtype=torch.float32))
    return y, h


def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _dt_b_c(p: dict, xg: Tensor):
    dt = _softplus(einsum("bsr,re->bse", einsum("bsi,ir->bsr", xg,
                                                p["w_x_dt"]), p["w_dt"])
                   + p["dt_bias"]).float()
    Bm = einsum("bsi,in->bsn", xg, p["w_B"]).float()
    Cm = einsum("bsi,in->bsn", xg, p["w_C"]).float()
    A = -torch.exp(p["A_log"].float())
    return dt, Bm, Cm, A


def mamba_forward(p: dict, x: Tensor, cfg, shd: Sharder
                  ) -> Tuple[Tensor, dict]:
    """Train/prefill. x: (B,S,D). Returns (out, state) for decode."""
    b_, s, _ = x.shape
    xz = einsum("bsd,de->bse", x, p["w_in"])
    xz = shd(xz, ("act_batch", "act_seq", "act_mlp"))
    xp, z = torch.chunk(xz, 2, dim=-1)
    xc = _causal_conv(xp, p["conv_w"], p["conv_b"])
    xg = torch.nn.functional.silu(xc)
    dt, Bm, Cm, A = _dt_b_c(p, xg)
    y, h_last = selective_scan(dt, Bm, Cm, xg.float(), A)
    y = y.to(x.dtype) + p["D"] * xg
    y = y * torch.nn.functional.silu(z)
    out = einsum("bsi,id->bsd", y, p["w_out"])
    keep = cfg.ssm_conv_dim - 1
    conv = (xp[:, s - keep:, :] if s >= keep
            else torch.nn.functional.pad(xp, (0, 0, keep - s, 0)))
    state = {"h": h_last, "conv": conv}
    return shd(out, ("act_batch", "act_seq", "act_embed")), state


def mamba_decode(p: dict, x: Tensor, cfg, shd: Sharder, state: dict
                 ) -> Tuple[Tensor, dict]:
    """One-token step. x: (B,1,D); state: h (B,di,N) float32, conv
    (B,dc-1,di). Returns (out, new state)."""
    xz = einsum("bsd,de->bse", x, p["w_in"])
    xp, z = torch.chunk(xz, 2, dim=-1)                      # (B,1,di)
    win = torch.cat([state["conv"].to(xp.dtype), xp], dim=1)  # (B,dc,di)
    xc = einsum("bci,ci->bi", win, p["conv_w"]) + p["conv_b"]
    xg = torch.nn.functional.silu(xc)[:, None, :]             # (B,1,di)
    dt, Bm, Cm, A = _dt_b_c(p, xg)
    a = torch.exp(dt[:, 0, :, None] * A)                      # (B,di,N)
    bx = (dt[:, 0] * xg[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = a * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :].to(x.dtype)
    y = y + p["D"] * xg
    y = y * torch.nn.functional.silu(z)
    out = einsum("bsi,id->bsd", y, p["w_out"])
    return out, {"h": h, "conv": win[:, 1:, :]}
