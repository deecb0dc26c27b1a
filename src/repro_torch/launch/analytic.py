"""Analytic FLOP / HBM-byte model of the *implementation* (not the ideal).

The port's counterpart of ``repro.launch.analytic``, formula for formula,
so that both packages give the same floats for every cell. ``WB`` is the
bfloat16 width of parameters and activations, ``WF`` float32's.

Why analytic: the reference's XLA cost analysis counts while-loop bodies
once, and the port compiles nothing (the LM dry run reckons from shapes),
so flops and HBM traffic come from the formulas here, which model what the
code does, including its inefficiencies:

  * chunked attention computes the FULL block rectangle with a causal mask
    (2x the causal half) — counted as implemented;
  * remat="full" recomputes the forward in backward: train multiplier
    4x fwd flops (fwd + recompute + 2x bwd) vs 3x without;
  * MoE capacity buffers compute cap*E token slots (cf x overprovision);
  * f32 where the implementation uses f32 (ssm/rwkv states, logits softmax).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig

WB = 2      # bfloat16 param/activation width
WF = 4      # f32 width


def _attn_flops_fwd(cfg, s: int, cache_len: int | None = None) -> float:
    """Per batch element. cache_len set => decode (s=1 new token)."""
    d, h, g, kd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * s * (d * h * kd + 2 * d * g * kd + h * kd * d)
    kv_len = cache_len if cache_len is not None else s
    # implementation computes the full rectangle (causal mask, not skipped)
    scores = 4 * s * kv_len * h * kd
    return proj + scores


def _mla_flops_fwd(cfg, s: int, cache_len: int | None = None) -> float:
    d, h = cfg.d_model, cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dqk = dn + dr
    down = 2 * s * (d * rq + d * rkv + d * dr)
    q_up = 2 * s * rq * h * dqk
    if cache_len is None:  # train/prefill: explicit k/v expansion
        kv_up = 2 * s * (rkv * h * dn + rkv * h * dv)
        scores = 2 * s * s * h * (dqk + dv)
        out = 2 * s * h * dv * d
        return down + q_up + kv_up + scores + out
    # absorbed decode: q absorb + scores on compressed cache + out absorb
    absorb = 2 * s * h * dn * rkv
    scores = 2 * s * cache_len * h * (rkv + dr) + 2 * s * cache_len * h * rkv
    out = 2 * s * h * rkv * dv + 2 * s * h * dv * d
    return down + q_up + absorb + scores + out


def _mamba_flops_fwd(cfg, s: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    r = cfg.ssm_dt_rank
    proj = 2 * s * (d * 2 * di + di * r + r * di + 2 * di * n + di * d)
    conv = 2 * s * cfg.ssm_conv_dim * di
    scan = s * di * n * 10          # a=exp, a*h+b, C·h etc. (elementwise+reduce)
    return proj + conv + scan


def _rwkv_flops_fwd(cfg, s: int) -> float:
    d = cfg.d_model
    lr, dr = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
    kd = cfg.rwkv_head_dim
    h = d // kd
    loras = 2 * s * (d * 5 * lr + 5 * lr * d + d * dr + dr * d)
    mats = 2 * s * 5 * d * d       # r,k,v,g,o
    recur = s * h * kd * kd * 6    # kv outer, r·S, decay*S+kv
    return loras + mats + recur


def _channel_flops_fwd(cfg, spec: LayerSpec, s: int, batch: int) -> float:
    """Per batch element (MoE capacity depends on global tokens t = b*s)."""
    d, f = cfg.d_model, cfg.d_ff
    if spec.channel == "mlp":
        mats = 3 if cfg.mlp_act == "swiglu" else 2
        return 2 * s * mats * d * f
    if spec.channel == "moe":
        e, k = cfg.num_experts, cfg.experts_per_token
        t = batch * s
        cap = max(-(-int(cfg.moe_capacity_factor * t * k) // e), 8)
        slots_global = e * cap  # buffer compute, incl. cf overprovision
        routed = 2 * slots_global * 3 * d * f / batch
        router = 2 * s * d * e
        shared = 2 * s * 3 * d * f if cfg.name.startswith("llama4") else 0
        return routed + router + shared
    if spec.channel == "rwkv_ffn":
        return 2 * s * (d * f + f * d + d * d)
    raise ValueError(spec.channel)


def _mixer_flops_fwd(cfg, spec: LayerSpec, s: int, cache_len=None) -> float:
    if spec.mixer == "attn":
        return _attn_flops_fwd(cfg, s, cache_len)
    if spec.mixer == "mla":
        return _mla_flops_fwd(cfg, s, cache_len)
    if spec.mixer == "mamba":
        return _mamba_flops_fwd(cfg, s)
    if spec.mixer == "rwkv":
        return _rwkv_flops_fwd(cfg, s)
    raise ValueError(spec.mixer)


def _train_multiplier(cfg) -> float:
    return {"full": 4.0, "dots": 3.1, "none": 3.0}[cfg.remat]


def flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global FLOPs for one step of this cell, as implemented."""
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    s_new = 1 if decode else s
    cache_len = s if decode else None
    per_layer = 0.0
    for spec in cfg.layer_pattern:
        per_layer += _mixer_flops_fwd(cfg, spec, s_new, cache_len)
        per_layer += _channel_flops_fwd(cfg, spec, s_new, b)
    body = per_layer * cfg.num_groups
    head = 2 * s_new * cfg.d_model * cfg.vocab_size  # lm_head matmul
    fwd = b * (body + head)
    if shape.kind == "train":
        return fwd * _train_multiplier(cfg)
    return fwd


def hbm_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global HBM traffic (bytes) for one step, coarse tensor-stream model:
    every matmul streams inputs + weights + output; chunked attention streams
    k/v per q-block (flash model: S^2/c growth); states in f32."""
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    s_new = 1 if decode else s
    t = b * s_new  # global tokens processed
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    from repro_torch.models import count_params

    p_total = count_params(cfg)

    # --- weights: streamed once per pass; train: fwd + remat + bwd + opt
    if shape.kind == "train":
        w_bytes = p_total * WB * (4 if cfg.remat == "full" else 3)
        w_bytes += p_total * (2 * WF + 2 * WF + WB)  # adam m/v rw + p write
    else:
        w_width = 1 if (cfg.weight_quant == "int8" and decode) else WB
        w_bytes = p_total * w_width

    # --- activations: per token per layer, ~10 d-sized + mlp f-sized streams
    act_per_tok_layer = (10 * d + 4 * f) * WB
    for spec in cfg.layer_pattern:
        if spec.mixer in ("mamba",):
            act_per_tok_layer += 6 * cfg.ssm_expand * d * WB / len(cfg.layer_pattern)
    act = t * cfg.num_layers * act_per_tok_layer

    # --- attention kv streaming (flash model); MLA streams the COMPRESSED
    # latent cache (kv_lora + rope) — that is the mechanism's entire point.
    for mx, count in (("attn", sum(1 for x in cfg.layer_pattern if x.mixer == "attn")),
                      ("mla", sum(1 for x in cfg.layer_pattern if x.mixer == "mla"))):
        n_layers = count * cfg.num_groups
        if not n_layers:
            continue
        if mx == "mla":
            per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        else:
            per_tok = cfg.num_kv_heads * cfg.head_dim * 2  # k + v
        if decode:
            kv_stream = b * s * per_tok * WB                 # read whole cache
        else:
            c = min(cfg.attn_chunk, s)
            n_q = max(s // c, 1)
            if mx == "mla":  # prefill expands k/v per q-block from the latent
                per_tok = cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                                           + cfg.v_head_dim)
            kv_stream = b * n_q * s * per_tok * WB
        act += n_layers * kv_stream * (3 if shape.kind == "train" else 1)

    # --- logits + softmax (f32)
    logits = t * v * (WB + 2 * WF if shape.kind == "train" else WB)

    if shape.kind == "train":
        act *= 3.0  # fwd + bwd streams + remat re-streams (coarse)
    return w_bytes + act + logits


def report(cfg, shape) -> Dict[str, float]:
    return {"flops": flops(cfg, shape), "hbm_bytes": hbm_bytes(cfg, shape)}
