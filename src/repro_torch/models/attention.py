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

from typing import Callable

import torch

from repro_torch.models.layers import (
    Builder,
    Sharder,
    apply_rope,
    as_dtensor,
    einsum,
    einsum_f32,
    is_dtensor,
    on_shards,
    rmsnorm,
    rope_angles,
    shard_start,
    write_index,
)

Tensor = torch.Tensor

# the attention core's layout under a mesh: each batch row and head is
# attended on its own, over the whole sequence
CORE_AXES = ("act_batch", None, "act_heads", None)


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


def _chunked_attention(q: Tensor, k: Tensor, v: Tensor,
                       chunk: int) -> Tensor:
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
        o = on_shards(shd, lambda q_, k_, v_: _chunked_attention(
            q_, k_, v_, cfg.attn_chunk), (CORE_AXES,) * 3, 0, q, kx, vx)
    else:
        o = on_shards(shd, _full_attention, (CORE_AXES,) * 3, 0, q, kx, vx)
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
    write_index(ck, 1, cur_index, k[:, 0].to(ck.dtype))
    write_index(cv, 1, cur_index, v[:, 0].to(cv.dtype))
    ck = shd(ck, ("act_batch", "act_kv_seq", "act_kv_heads", None))
    cv = shd(cv, ("act_batch", "act_kv_seq", "act_kv_heads", None))
    if is_dtensor(ck):
        o = _sharded_cache_attention(q, ck, cv, cur_index, g,
                                     kd ** -0.5).to(x.dtype)
    else:
        valid = torch.arange(smax, device=x.device) <= cur_index
        o = _cache_attention(q.reshape(b_, g, h // g, kd), ck, cv, valid,
                             kd ** -0.5).reshape(b_, 1, h, kd).to(x.dtype)
    out = einsum("bshk,hkd->bsd", o, p["wo"])
    return out, {"k": ck, "v": cv}


def _cache_attention(qg: Tensor, ck: Tensor, cv: Tensor, valid: Tensor,
                     scale: float) -> Tensor:
    """qg: (B,G,R,K) against k/v (B,S,G,K) at the ``valid`` positions ->
    (B,G,R,K) float32."""
    s_ = einsum_f32("bgrk,bsgk->bgrs", qg, ck) * scale
    w = torch.softmax(torch.where(valid, s_, float("-inf")), dim=-1)
    return einsum_f32("bgrs,bsgk->bgrk", w, cv)


def _split_softmax(s_: Tensor, valid: Tensor, values: Callable,
                   seq_groups: list) -> Tensor:
    """``values(softmax(s_))`` over the last dim at the ``valid``
    positions, where that dim is this rank's shard of a sequence split
    over ``seq_groups`` (flash-decode): the scores' max, the softmax's sum
    and the weighted values are all-reduced over each group. ``values``
    is linear in its weights. Decode runs without gradients."""
    import torch.distributed as dist

    s_ = torch.where(valid, s_, float("-inf"))
    if not seq_groups:
        return values(torch.softmax(s_, dim=-1))
    m = s_.amax(-1, keepdim=True)
    for grp in seq_groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
    w = torch.exp(s_ - m)
    total = w.sum(-1, keepdim=True)
    o = values(w)
    for grp in seq_groups:
        dist.all_reduce(total, group=grp)
        dist.all_reduce(o, group=grp)
    return o / total


def _cache_split(cache, cur_index: int):
    """A DTensor cache (B, S, ...) as the decode rules lay it out: the
    batch rows' placements, the groups that split its sequence, and which
    of this rank's positions are at or before ``cur_index``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, lay = cache.device_mesh, cache.placements
    rows = [Shard(0) if pl.is_shard(0) else Replicate() for pl in lay]
    groups = [mesh.get_group(m) for m, pl in enumerate(lay)
              if pl.is_shard(1)]
    start = shard_start(cache, 1)
    n = cache.to_local().shape[1]
    valid = torch.arange(start, start + n,
                         device=cache.to_local().device) <= cur_index
    return rows, groups, valid


def _sharded_cache_attention(q: Tensor, ck, cv, cur_index: int, g: int,
                             scale: float):
    """Decode attention of q (B,1,H,K) against a DTensor cache on this
    rank's shard of it (batch over the batch axes, sequence over
    "model"): the new token's heads gathered whole, the rank's positions
    attended (``_split_softmax``). Returns (B,1,H,K) float32 laid out by
    the cache's batch split."""
    from torch.distributed.tensor import DTensor

    mesh = ck.device_mesh
    rows, groups, valid = _cache_split(ck, cur_index)
    q_loc = as_dtensor(q, mesh).redistribute(mesh, rows).to_local()
    b_, _, h, kd = q_loc.shape
    qg = q_loc.reshape(b_, g, h // g, kd)
    ck_loc = ck.to_local()
    cv_loc = cv.redistribute(mesh, ck.placements).to_local()
    o = _split_softmax(einsum_f32("bgrk,bsgk->bgrs", qg, ck_loc) * scale,
                       valid, lambda w: einsum_f32("bgrs,bsgk->bgrk", w,
                                                   cv_loc), groups)
    return DTensor.from_local(o.reshape(b_, 1, h, kd), mesh, rows,
                              run_check=False)


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
    # v head dim may differ from qk dim; pad v to qk width for the shared
    # core (on each rank's shard: torch 2.11's DTensor cannot pad)
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
    dv = cfg.v_head_dim
    if use_chunked and _use_chunked(cfg, x.shape[1]):
        def core(q_, k_, v_):
            if dqk > dv:
                v_ = torch.nn.functional.pad(v_, (0, dqk - dv))
            return _chunked_attention(q_, k_, v_, cfg.attn_chunk)[..., :dv]

        o = on_shards(shd, core, (CORE_AXES,) * 3, 0, q, k, v)
    else:
        o = on_shards(shd, lambda q_, k_, v_: _causal_softmax_attention(
            q_, k_, v_, dqk ** -0.5).to(x.dtype), (CORE_AXES,) * 3, 0,
            q, k, v)
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
    write_index(c, 1, cur_index, ckv_new[:, 0].to(c.dtype))
    write_index(kr, 1, cur_index, k_rope_new[:, 0].to(kr.dtype))
    c = shd(c, ("act_batch", "act_kv_seq", None))
    kr = shd(kr, ("act_batch", "act_kv_seq", None))
    # absorb W_uk into q:  (B,1,H,dn) x (r,h,dn) -> (B,H,r)
    q_c = einsum("bshk,rhk->bhr", q_nope, p["wk_up"])
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if is_dtensor(c):
        o_c = _sharded_mla_attention(q_c, q_rope, c, kr, cur_index, scale)
    else:
        valid = torch.arange(smax, device=x.device) <= cur_index
        o_c = _mla_cache_attention(q_c, q_rope, c, kr, valid, scale, [])
    o = einsum("bhr,rhv->bhv", o_c.to(x.dtype), p["wv_up"])
    out = einsum("bhv,hvd->bd", o, p["wo"])[:, None, :]
    return out, {"ckv": c, "k_rope": kr}


def _mla_cache_attention(q_c: Tensor, q_rope: Tensor, c: Tensor,
                         kr: Tensor, valid: Tensor, scale: float,
                         seq_groups: list) -> Tensor:
    """The absorbed scores of q_c (B,H,r) and q_rope (B,1,H,dr) against
    the compressed cache c (B,S,r), kr (B,S,dr) at the ``valid``
    positions, their softmax applied to c -> (B,H,r) float32."""
    s_ = (einsum_f32("bhr,bsr->bhs", q_c, c)
          + einsum_f32("bshk,btk->bht", q_rope, kr)) * scale
    return _split_softmax(s_, valid,
                          lambda w: einsum_f32("bhs,bsr->bhr", w, c),
                          seq_groups)


def _sharded_mla_attention(q_c, q_rope, c, kr, cur_index: int,
                           scale: float):
    """``_mla_cache_attention`` on this rank's shard of a DTensor cache,
    the new token's heads gathered whole, as ``_sharded_cache_attention``
    does. Returns (B,H,r) float32 laid out by the cache's batch split."""
    from torch.distributed.tensor import DTensor

    mesh = c.device_mesh
    rows, groups, valid = _cache_split(c, cur_index)
    q_c_loc, q_rope_loc = (as_dtensor(t, mesh).redistribute(
        mesh, rows).to_local() for t in (q_c, q_rope))
    kr_loc = kr.redistribute(mesh, c.placements).to_local()
    o = _mla_cache_attention(q_c_loc, q_rope_loc, c.to_local(), kr_loc,
                             valid, scale, groups)
    return DTensor.from_local(o, mesh, rows, run_check=False)
