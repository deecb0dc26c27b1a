"""Attention token mixers: GQA/MHA (qk_norm/bias options) and MLA.

The port's counterpart of ``repro.models.attention``, the same arithmetic
in plain torch. Train/prefill use a chunked causal attention (a
numerically stable online softmax over kv chunks, every block rectangle
computed and masked) when the sequence is longer than ``attn_chunk`` and
a multiple of it, and the full score matrix otherwise.

Decode attends one new token against the cache: GQA caches (k, v) per
layer; MLA caches the *compressed* kv latent + shared rope key and uses
the absorbed-matmul formulation (DeepSeek-V2 appendix), so the cache is
never re-expanded. The decode functions write the new entry into the
cache they are given, in place, and return it: torch has no functional
update, and a copy of the cache a step would double the bytes a step
moves.

Scores and the weighted sum over values accumulate in float32 whatever
the activation dtype (``einsum_f32``), where the reference asks for
``preferred_element_type=float32``; every other product keeps its
operands' dtype.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import (
    Builder,
    Sharder,
    apply_rope,
    einsum,
    einsum_f32,
    rmsnorm,
    rope_angles,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# params


def init_attn(b: Builder, cfg) -> dict:
    d, h, g, k = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": b.make((d, h, k), ("embed", "heads", "head")),
        "wk": b.make((d, g, k), ("embed", "kv_heads", "head")),
        "wv": b.make((d, g, k), ("embed", "kv_heads", "head")),
        "wo": b.make((h, k, d), ("heads", "head", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = b.make((h, k), ("heads", "head"), init="zeros")
        p["bk"] = b.make((g, k), ("kv_heads", "head"), init="zeros")
        p["bv"] = b.make((g, k), ("kv_heads", "head"), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = b.make((k,), (None,), init="ones")
        p["k_norm"] = b.make((k,), (None,), init="ones")
    return p


def init_mla(b: Builder, cfg) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_down": b.make((d, rq), ("embed", "q_lora")),
        "q_norm": b.make((rq,), (None,), init="ones"),
        "wq_up": b.make((rq, h, dn + dr), ("q_lora", "heads", "head")),
        "wkv_down": b.make((d, rkv), ("embed", "kv_lora")),
        "kv_norm": b.make((rkv,), (None,), init="ones"),
        "wk_rope": b.make((d, dr), ("embed", "head")),
        "wk_up": b.make((rkv, h, dn), ("kv_lora", "heads", "head")),
        "wv_up": b.make((rkv, h, dv), ("kv_lora", "heads", "head")),
        "wo": b.make((h, dv, d), ("heads", "head", "embed")),
    }


# ---------------------------------------------------------------------------
# causal attention cores (train / prefill)


def _use_chunked(cfg, s_len: int) -> bool:
    return s_len > cfg.attn_chunk and s_len % cfg.attn_chunk == 0


def _chunked_attention(q: Tensor, k: Tensor, v: Tensor, chunk: int,
                       shd: Sharder) -> Tensor:
    """q: (B,S,H,K), k/v: (B,S,H,K) (kv already head-expanded). Causal.

    Online softmax over kv chunks, one q chunk at a time; every
    (q-chunk, kv-chunk) pair is computed and masked, as the reference does.
    """
    b_, s, h, d = q.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    t = s // c
    scale = d ** -0.5
    ar = torch.arange(c, device=q.device)
    outs = []
    for qi in range(t):
        q_blk = q[:, qi * c:(qi + 1) * c]
        m = torch.full((b_, h, c), float("-inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b_, h, c), dtype=torch.float32, device=q.device)
        o = torch.zeros((b_, h, c, d), dtype=torch.float32, device=q.device)
        for kj in range(t):
            k_blk = k[:, kj * c:(kj + 1) * c]
            v_blk = v[:, kj * c:(kj + 1) * c]
            s_ = einsum_f32("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            # causal mask at chunk granularity + within the diagonal chunk
            qpos = qi * c + ar[:, None]
            kpos = kj * c + ar[None, :]
            s_ = torch.where(qpos >= kpos, s_, float("-inf"))
            m_new = torch.maximum(m, s_.amax(-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + einsum_f32("bhqk,bkhd->bhqd", p, v_blk)
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 2, 1, 3).to(q.dtype))   # (B,c,H,K)
    return torch.cat(outs, dim=1)


def _causal_softmax_attention(q: Tensor, k: Tensor, v: Tensor,
                              scale: float) -> Tensor:
    """Full-matrix causal attention, float32 scores and output."""
    s = q.shape[1]
    s_ = einsum_f32("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    w = torch.softmax(torch.where(mask, s_, float("-inf")), dim=-1)
    return einsum_f32("bhqk,bkhd->bqhd", w, v)


def _full_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Reference full-matrix causal attention (small S)."""
    return _causal_softmax_attention(q, k, v,
                                     q.shape[-1] ** -0.5).to(q.dtype)


def _expand_kv(x: Tensor, num_heads: int) -> Tensor:
    """(B,S,G,K) -> (B,S,H,K) by repeating each kv head H//G times."""
    rep = num_heads // x.shape[2]
    if rep == 1:
        return x
    return torch.repeat_interleave(x, rep, dim=2)


def _check_index(cur_index: int, smax: int) -> None:
    """The reference's cache write clamps its index; a torch slice would
    write past the cache or nowhere, so an index out of range raises."""
    if not 0 <= cur_index < smax:
        raise IndexError(f"decode position {cur_index} outside the cache's "
                         f"{smax} positions")


# ---------------------------------------------------------------------------
# GQA apply


def _qkv(p: dict, x: Tensor, cfg, positions: Tensor):
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dgk->bsgk", x, p["wk"])
    v = einsum("bsd,dgk->bsgk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attn_forward(p: dict, x: Tensor, cfg, shd: Sharder, positions: Tensor,
                 use_chunked: bool = True) -> tuple[Tensor, dict]:
    """Train/prefill path. Returns (output, cache_entries)."""
    q, k, v = _qkv(p, x, cfg, positions)
    q = shd(q, ("act_batch", "act_seq", "act_heads", None))
    k = shd(k, ("act_batch", "act_seq", "act_kv_heads", None))
    v = shd(v, ("act_batch", "act_seq", "act_kv_heads", None))
    cache = {"k": k, "v": v}
    kx, vx = _expand_kv(k, cfg.num_heads), _expand_kv(v, cfg.num_heads)
    if use_chunked and _use_chunked(cfg, x.shape[1]):
        o = _chunked_attention(q, kx, vx, cfg.attn_chunk, shd)
    else:
        o = _full_attention(q, kx, vx)
    out = einsum("bshk,hkd->bsd", o, p["wo"])
    return shd(out, ("act_batch", "act_seq", "act_embed")), cache


def attn_decode(p: dict, x: Tensor, cfg, shd: Sharder, cache: dict,
                cur_index: int) -> tuple[Tensor, dict]:
    """x: (B,1,D) new token; cache: k/v (B,Smax,G,K), written in place at
    ``cur_index``. Returns (out, cache)."""
    b_ = x.shape[0]
    g, h, kd = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    smax = ck.shape[1]
    _check_index(cur_index, smax)
    pos = torch.full((b_, 1), cur_index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos)
    ck[:, cur_index] = k[:, 0].to(ck.dtype)
    cv[:, cur_index] = v[:, 0].to(cv.dtype)
    ck = shd(ck, ("act_batch", "act_kv_seq", "act_kv_heads", None))
    cv = shd(cv, ("act_batch", "act_kv_seq", "act_kv_heads", None))
    qg = q.reshape(b_, g, h // g, kd)
    s_ = einsum_f32("bgrk,bsgk->bgrs", qg, ck) * (kd ** -0.5)
    valid = torch.arange(smax, device=x.device) <= cur_index
    w = torch.softmax(torch.where(valid, s_, float("-inf")), dim=-1)
    o = einsum_f32("bgrs,bsgk->bgrk", w, cv)
    o = o.reshape(b_, 1, h, kd).to(x.dtype)
    out = einsum("bshk,hkd->bsd", o, p["wo"])
    return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA apply


def _mla_qkv(p: dict, x: Tensor, cfg, positions: Tensor):
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rmsnorm(einsum("bsd,dr->bsr", x, p["wq_down"]), p["q_norm"],
                 cfg.norm_eps)
    q = einsum("bsr,rhk->bshk", cq, p["wq_up"])  # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = rmsnorm(einsum("bsd,dr->bsr", x, p["wkv_down"]), p["kv_norm"],
                  cfg.norm_eps)
    k_rope = einsum("bsd,dr->bsr", x, p["wk_rope"])  # shared across heads
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_forward(p: dict, x: Tensor, cfg, shd: Sharder, positions: Tensor,
                use_chunked: bool = True) -> tuple[Tensor, dict]:
    """Train/prefill MLA with explicit (uncompressed) attention math."""
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, positions)
    k_nope = einsum("bsr,rhk->bshk", ckv, p["wk_up"])
    v = einsum("bsr,rhk->bshk", ckv, p["wv_up"])
    h = cfg.num_heads
    k_rope_h = k_rope[..., None, :].expand(*k_rope.shape[:2], h,
                                           cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    q = shd(q, ("act_batch", "act_seq", "act_heads", None))
    k = shd(k, ("act_batch", "act_seq", "act_heads", None))
    # v head dim may differ from qk dim; pad v to qk width for the shared core
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
    dv = cfg.v_head_dim
    if use_chunked and _use_chunked(cfg, x.shape[1]):
        vpad = (torch.nn.functional.pad(v, (0, dqk - dv)) if dqk > dv
                else v)
        o = _chunked_attention(q, k, vpad, cfg.attn_chunk, shd)[..., :dv]
    else:
        o = _causal_softmax_attention(q, k, v, dqk ** -0.5).to(x.dtype)
    out = einsum("bshv,hvd->bsd", o, p["wo"])
    cache = {"ckv": ckv, "k_rope": k_rope}
    return shd(out, ("act_batch", "act_seq", "act_embed")), cache


def mla_decode(p: dict, x: Tensor, cfg, shd: Sharder, cache: dict,
               cur_index: int) -> tuple[Tensor, dict]:
    """Absorbed-matmul MLA decode against the compressed cache, written in
    place at ``cur_index``.

    score(q, t) = q_nope^T (W_uk c_t) + q_rope^T k_rope_t
                = (W_uk^T q_nope)^T c_t + q_rope^T k_rope_t
    out_head    = W_uv^T (sum_t w_t c_t)
    so the cache stays compressed: (B, S, r_kv) + (B, S, dr).
    """
    b_ = x.shape[0]
    c, kr = cache["ckv"], cache["k_rope"]
    smax = c.shape[1]
    _check_index(cur_index, smax)
    pos = torch.full((b_, 1), cur_index, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv(p, x, cfg, pos)
    c[:, cur_index] = ckv_new[:, 0].to(c.dtype)
    kr[:, cur_index] = k_rope_new[:, 0].to(kr.dtype)
    c = shd(c, ("act_batch", "act_kv_seq", None))
    kr = shd(kr, ("act_batch", "act_kv_seq", None))
    # absorb W_uk into q:  (B,1,H,dn) x (r,h,dn) -> (B,H,r)
    q_c = einsum("bshk,rhk->bhr", q_nope, p["wk_up"])
    s_c = einsum_f32("bhr,bsr->bhs", q_c, c)
    s_r = einsum_f32("bshk,btk->bht", q_rope, kr)
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
    s_ = (s_c + s_r) * (dqk ** -0.5)
    valid = torch.arange(smax, device=x.device) <= cur_index
    w = torch.softmax(torch.where(valid, s_, float("-inf")), dim=-1)
    o_c = einsum_f32("bhs,bsr->bhr", w, c)
    o = einsum("bhr,rhv->bhv", o_c.to(x.dtype), p["wv_up"])
    out = einsum("bhv,hvd->bd", o, p["wo"])[:, None, :]
    return out, {"ckv": c, "k_rope": kr}
