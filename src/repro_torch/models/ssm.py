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

from repro_torch.models.layers import Builder, Sharder, einsum, on_shards

Tensor = torch.Tensor

# under a mesh the mixer between its projections runs on each rank's batch
# rows: (B, S, X) and the (B, di, N) state split by batch only
ROW_AXES = ("act_batch", None, None)


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


# the mixer's weights between its two projections, handed to the per-row
# computation (replicated under a mesh)
_INNER = ("conv_w", "conv_b", "w_x_dt", "w_dt", "dt_bias", "w_B", "w_C",
          "A_log", "D")


def _inner_axes(p: dict) -> tuple:
    return tuple((None,) * p[k].dim() for k in _INNER)


def _mixer_rows(p: dict, xz: Tensor, h0: Tensor, conv0: Optional[Tensor],
                keep: int, dtype: torch.dtype):
    """The mixer between its projections on whole rows: xz (B,S,2di) ->
    (y (B,S,di), the last state h (B,di,N), the conv state (B,keep,di));
    ``conv0`` the decode's conv state (None in train/prefill); the scan's
    float32 output is cast to ``dtype``, the mixer input's."""
    xp, z = torch.chunk(xz, 2, dim=-1)
    if conv0 is None:
        s = xp.shape[1]
        conv = (xp[:, s - keep:, :] if s >= keep
                else torch.nn.functional.pad(xp, (0, 0, keep - s, 0)))
        xc = _causal_conv(xp, p["conv_w"], p["conv_b"])
    else:
        win = torch.cat([conv0.to(xp.dtype), xp], dim=1)     # (B,dc,di)
        conv = win[:, 1:, :]
        xc = (einsum("bci,ci->bi", win, p["conv_w"]) + p["conv_b"])[:, None]
    xg = torch.nn.functional.silu(xc)
    dt, Bm, Cm, A = _dt_b_c(p, xg)
    y, h = selective_scan(dt, Bm, Cm, xg.float(), A, h0)
    y = y.to(dtype) + p["D"] * xg
    return y * torch.nn.functional.silu(z), h, conv


def _rows(shd: Sharder, p: dict, xz: Tensor, h0: Tensor,
          conv0: Optional[Tensor], keep: int, dtype: torch.dtype):
    """``_mixer_rows`` on each rank's batch rows under a mesh (the weights
    between the projections gathered whole), else as it is."""
    weights = [p[k] for k in _INNER]
    state = () if conv0 is None else (conv0,)

    def rows(xz_, h_, *rest):
        inner = dict(zip(_INNER, rest[:len(_INNER)]))
        return _mixer_rows(inner, xz_, h_, rest[len(_INNER)] if state
                           else None, keep, dtype)

    axes = (ROW_AXES, ROW_AXES, *_inner_axes(p), *((ROW_AXES,) * len(state)))
    return on_shards(shd, rows, axes, (0, 1, 0), xz, h0, *weights, *state)


def mamba_forward(p: dict, x: Tensor, cfg, shd: Sharder
                  ) -> Tuple[Tensor, dict]:
    """Train/prefill. x: (B,S,D). Returns (out, state) for decode."""
    xz = einsum("bsd,de->bse", x, p["w_in"])
    xz = shd(xz, ("act_batch", "act_seq", "act_mlp"))
    h0 = torch.zeros((x.shape[0], p["A_log"].shape[0], p["A_log"].shape[1]),
                     dtype=torch.float32, device=x.device)
    y, h_last, conv = _rows(shd, p, xz, h0, None, cfg.ssm_conv_dim - 1,
                            x.dtype)
    out = einsum("bsi,id->bsd", y, p["w_out"])
    state = {"h": h_last, "conv": conv}
    return shd(out, ("act_batch", "act_seq", "act_embed")), state


def mamba_decode(p: dict, x: Tensor, cfg, shd: Sharder, state: dict
                 ) -> Tuple[Tensor, dict]:
    """One-token step. x: (B,1,D); state: h (B,di,N) float32, conv
    (B,dc-1,di). Returns (out, new state)."""
    xz = einsum("bsd,de->bse", x, p["w_in"])
    y, h, conv = _rows(shd, p, xz, state["h"], state["conv"],
                       cfg.ssm_conv_dim - 1, x.dtype)
    out = einsum("bsi,id->bsd", y, p["w_out"])
    return out, {"h": h, "conv": conv}
