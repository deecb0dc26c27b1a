"""Config-driven LM assembly: the port's counterpart of
``repro.models.model``.

The parameter tree is the reference's, key path for key path and shape for
shape: every leaf of ``params["layers"]["p<k>"]`` carries a leading
``num_groups`` axis (logical axis "layers"; one group = one period of
``cfg.layer_pattern``). The group loop indexes that axis one group at a
time. ``scan_layers`` is a config field only: the reference picks
``lax.scan`` or an unrolled loop over the same math, a choice of how XLA
traces the loop that eager torch does not have.

``cfg.remat`` is the reference's: where autograd records (training), each
group's body runs under ``torch.utils.checkpoint``. "full" keeps only the
group's input carry and recomputes the body in the backward; "dots" saves
the outputs of the products with no batch dimension (the projections) and
recomputes the rest (``layers.dots_saveable``, the reference's
``dots_with_no_batch_dims_saveable``); "none" keeps everything. Outputs
and gradients are the same bits whichever it is. Prefill, decode and
serving record nothing and run the body as it is.

Three entry points per model:
  forward(...)                train / prefill (optionally returns the cache)
  decode_step(...)            one new token against the cache (serve_step)
  loss_fn(...)                next-token CE + MoE aux loss (its backward
                              is autograd's, ``train.step``)

Parameter and cache trees exist in concrete form (drawn from a
``torch.Generator``, on its device) and abstract form (``meta`` tensors: a
400B-parameter tree costs nothing to build).

Every mixer ("attn", "mla", "mamba", "rwkv") and channel ("mlp", "moe",
"rwkv_ffn") is ported, and ``weight_quant="int8"``: the layer stack is
stored int8 with a per-group scale (``params["layers_scale"]``) and
``decode_step`` dequantizes one group at a time. ``forward`` reads the
int8 values as they are, without their scale, as the reference's does
(ROADMAP Queue C 14).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import quant
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Builder,
    P,
    Sharder,
    apply_norm,
    checkpointed,
    dots_saveable,
    einsum,
    init_norm,
    records,
    resolve_device,
    sinusoidal_pos,
    split_tree,
    torch_dtype,
    tree_leaves_with_path,
    tree_map,
    vocab_lookup,
    vocab_nll,
)
from repro_torch.models.mlp import init_mlp, mlp_apply

Tensor = torch.Tensor


class _Stacked:
    """Builder proxy that prepends the (num_groups,) 'layers' axis."""

    def __init__(self, b: Builder, g: int):
        self.b = b
        self.g = g

    def make(self, shape, axes, **kw) -> P:
        return self.b.make((self.g, *shape), ("layers", *axes), **kw)


def _init_mixer(b, cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.mixer == "attn":
        return attn.init_attn(b, cfg)
    if spec.mixer == "mla":
        return attn.init_mla(b, cfg)
    if spec.mixer == "mamba":
        return ssm_mod.init_mamba(b, cfg)
    if spec.mixer == "rwkv":
        return rwkv_mod.init_rwkv_time(b, cfg)
    raise ValueError(spec.mixer)


def _init_channel(b, cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.channel == "mlp":
        return init_mlp(b, cfg)
    if spec.channel == "moe":
        return moe_mod.init_moe(b, cfg)
    if spec.channel == "rwkv_ffn":
        return rwkv_mod.init_rwkv_channel(b, cfg)
    raise ValueError(spec.channel)


def _build(cfg: ModelConfig, generator: Optional[torch.Generator],
           abstract: bool):
    b = Builder(generator, cfg.param_dtype, abstract=abstract)
    sb = _Stacked(b, cfg.num_groups)
    layers: Dict[str, Any] = {}
    for k, spec in enumerate(cfg.layer_pattern):
        entry = {
            "norm1": init_norm(sb, cfg.d_model, cfg.norm_type),
            "mixer": _init_mixer(sb, cfg, spec),
            "channel": _init_channel(sb, cfg, spec),
        }
        if not cfg.parallel_block:
            entry["norm2"] = init_norm(sb, cfg.d_model, cfg.norm_type)
        layers[f"p{k}"] = entry
    tree = {
        "embed": b.make((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                        init="normal", scale=0.02),
        "final_norm": init_norm(b, cfg.d_model, cfg.norm_type),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = b.make((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"))
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Any:
    """Parameters drawn from ``generator``, on its device."""
    params, _ = split_tree(_build(cfg, generator, abstract=False))
    if cfg.weight_quant == "int8":
        params["layers"], params["layers_scale"] = quant.quantize_layers(
            params["layers"])
    return params


def abstract_params(cfg: ModelConfig) -> Any:
    """The parameter tree on ``meta``: shapes and dtypes, no storage."""
    params, _ = split_tree(_build(cfg, None, abstract=True))
    if cfg.weight_quant == "int8":
        params["layers"], params["layers_scale"] = \
            quant.abstract_quantized_layers(params["layers"])
    return params


def param_logical_axes(cfg: ModelConfig) -> Any:
    _, axes = split_tree(_build(cfg, None, abstract=True))
    if cfg.weight_quant == "int8":
        axes["layers_scale"] = quant.scale_logical_axes(axes["layers"])
    return axes


def count_params(cfg: ModelConfig) -> int:
    return sum(leaf.numel()
               for _, leaf in tree_leaves_with_path(abstract_params(cfg)))


def active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: routed experts_per_token of
    num_experts)."""
    total = 0
    for path, leaf in tree_leaves_with_path(abstract_params(cfg)):
        n = leaf.numel()
        if ("channel" in path and cfg.num_experts
                and any(w in path for w in ("w_gate", "w_up", "w_down"))
                and "shared" not in path):
            n = n * cfg.experts_per_token // cfg.num_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# block application


def _apply_mixer(spec, p, x, cfg, shd, positions):
    if spec.mixer == "attn":
        return attn.attn_forward(p, x, cfg, shd, positions)
    if spec.mixer == "mla":
        return attn.mla_forward(p, x, cfg, shd, positions)
    if spec.mixer == "mamba":
        return ssm_mod.mamba_forward(p, x, cfg, shd)
    if spec.mixer == "rwkv":
        return rwkv_mod.rwkv_time_forward(p, x, cfg, shd)
    raise ValueError(spec.mixer)


def _apply_channel(spec, p, x, cfg, shd):
    """Returns (y, aux_loss, state)."""
    if spec.channel == "mlp":
        return mlp_apply(p, x, cfg, shd), 0.0, None
    if spec.channel == "moe":
        y, aux = moe_mod.moe_apply(p, x, cfg, shd)
        return y, aux, None
    if spec.channel == "rwkv_ffn":
        y, st = rwkv_mod.rwkv_channel_forward(p, x, cfg, shd)
        return y, 0.0, st
    raise ValueError(spec.channel)


def _group_body(cfg: ModelConfig, shd: Sharder, positions, collect_cache,
                carry, group_params):
    x, aux = carry
    caches = {}
    for k, spec in enumerate(cfg.layer_pattern):
        gp = group_params[f"p{k}"]
        h = apply_norm(gp["norm1"], x, cfg.norm_type, cfg.norm_eps)
        mix_out, mix_cache = _apply_mixer(spec, gp["mixer"], h, cfg, shd,
                                          positions)
        if cfg.parallel_block:
            ch_out, a, ch_state = _apply_channel(spec, gp["channel"], h, cfg,
                                                 shd)
            x = x + mix_out + ch_out
        else:
            x = x + mix_out
            h2 = apply_norm(gp["norm2"], x, cfg.norm_type, cfg.norm_eps)
            ch_out, a, ch_state = _apply_channel(spec, gp["channel"], h2,
                                                 cfg, shd)
            x = x + ch_out
        x = shd(x, ("act_batch", "act_seq", "act_embed"))
        aux = aux + a
        if collect_cache:
            caches[f"p{k}"] = {"mixer": mix_cache, "channel": ch_state}
    return (x, aux), caches if collect_cache else None


REMAT = ("none", "dots", "full")


def _remat_context(cfg: ModelConfig):
    """The ``context_fn`` of ``cfg.remat``'s checkpoint: the selective
    policy for "dots", None for "full" (and "none", which runs no
    checkpoint)."""
    if cfg.remat not in REMAT:
        raise ValueError(f"unknown remat {cfg.remat!r}; known: {REMAT}")
    if cfg.remat != "dots":
        return None
    import torch.utils.checkpoint as ckpt

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             dots_saveable)


def _group(tree: Any, i: int) -> Any:
    """Group ``i`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda a: a[i], tree)


def _stack(trees: list) -> Any:
    """Per-group trees -> one tree with a leading group axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if first is None:
        return None
    return torch.stack(trees)


def _embed(params: Any, cfg: ModelConfig, tokens: Tensor,
           shd: Sharder) -> Tensor:
    return vocab_lookup(shd, params["embed"], tokens).to(
        torch_dtype(cfg.activation_dtype))


def _logits(params: Any, cfg: ModelConfig, x: Tensor,
            shd: Sharder) -> Tensor:
    # under a mesh the head is first laid out whole along d (its FSDP
    # gather), split along the vocab as the rules split it
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    if cfg.tie_embeddings:
        w = shd(params["embed"], ("vocab", None))
        return einsum("bsd,vd->bsv", x, w.to(x.dtype))
    w = shd(params["lm_head"], (None, "vocab"))
    return einsum("bsd,dv->bsv", x, w.to(x.dtype))


def forward(
    params: Any,
    cfg: ModelConfig,
    tokens: Tensor,
    shd: Optional[Sharder] = None,
    frontend_embeds: Optional[Tensor] = None,
    return_cache: bool = False,
) -> Tuple[Tensor, Tensor, Any]:
    """tokens: (B,S) int32 -> (logits (B,S,V), aux_loss, cache|None)."""
    shd = shd or Sharder()
    b_, s = tokens.shape
    x = _embed(params, cfg, tokens, shd)
    if frontend_embeds is not None and cfg.frontend != "none":
        f = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(x.dtype), x[:, f:, :]], dim=1)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].expand(b_, s)
    if cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    x = shd(x, ("act_batch", "act_seq", "act_embed"))

    context_fn = _remat_context(cfg)

    def body(x_, aux_, gp):
        # the carry as two tensor arguments: what a checkpoint keeps
        return _group_body(cfg, shd, positions, return_cache, (x_, aux_), gp)

    carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
    cache_list = []
    for i in range(cfg.num_groups):
        gp = _group(params["layers"], i)
        if cfg.remat != "none" and records(
                *carry, *(t for _, t in tree_leaves_with_path(gp))):
            carry, c = checkpointed(body, *carry, gp, context_fn=context_fn)
        else:
            carry, c = body(*carry, gp)
        cache_list.append(c)
    x, aux = carry
    caches = _stack(cache_list) if return_cache else None
    logits = shd(_logits(params, cfg, x, shd), ("act_batch", "act_seq",
                                          "act_vocab"))
    return logits, aux, caches


# ---------------------------------------------------------------------------
# decode


def _write_state(cache: dict, state: dict) -> None:
    """A recurrent layer's new state into its cache entry, in place."""
    for name, value in state.items():
        cache[name].copy_(value)


def _decode_mixer(spec, p, h, cfg, shd, cache, cur_index):
    """The mixer's output for the new token; its cache entry is written in
    place."""
    if spec.mixer == "attn":
        return attn.attn_decode(p, h, cfg, shd, cache, cur_index)[0]
    if spec.mixer == "mla":
        return attn.mla_decode(p, h, cfg, shd, cache, cur_index)[0]
    if spec.mixer == "mamba":
        out, state = ssm_mod.mamba_decode(p, h, cfg, shd, cache)
    elif spec.mixer == "rwkv":
        out, state = rwkv_mod.rwkv_time_decode(p, h, cfg, shd, cache)
    else:
        raise ValueError(spec.mixer)
    _write_state(cache, state)
    return out


def _decode_channel(spec, p, x, cfg, shd, state):
    """The channel's output for the new token; an rwkv_ffn's shift is
    written into ``state`` in place."""
    if spec.channel == "mlp":
        return mlp_apply(p, x, cfg, shd)
    if spec.channel == "moe":
        return moe_mod.moe_apply(p, x, cfg, shd)[0]
    if spec.channel == "rwkv_ffn":
        y, new = rwkv_mod.rwkv_channel_decode(p, x, cfg, shd, state)
        _write_state(state, new)
        return y
    raise ValueError(spec.channel)


def _decode_group_body(cfg, shd, cur_index, x, group_params, cache):
    """One group's layers for the new token; each mixer writes its cache
    entry in place. Each block's output is laid out as the residual
    stream before it is added (under a mesh: the tensor-parallel
    all-reduce of a row-parallel projection's partial sums)."""
    out_axes = ("act_batch", None, "act_embed")
    for k, spec in enumerate(cfg.layer_pattern):
        gp = group_params[f"p{k}"]
        c = cache[f"p{k}"]
        h = apply_norm(gp["norm1"], x, cfg.norm_type, cfg.norm_eps)
        mix_out = shd(_decode_mixer(spec, gp["mixer"], h, cfg, shd,
                                    c["mixer"], cur_index), out_axes)
        if cfg.parallel_block:
            ch_out = shd(_decode_channel(spec, gp["channel"], h, cfg, shd,
                                         c["channel"]), out_axes)
            x = x + mix_out + ch_out
        else:
            x = x + mix_out
            h2 = apply_norm(gp["norm2"], x, cfg.norm_type, cfg.norm_eps)
            ch_out = shd(_decode_channel(spec, gp["channel"], h2, cfg, shd,
                                         c["channel"]), out_axes)
            x = x + ch_out
    return x


def decode_step(
    params: Any,
    cfg: ModelConfig,
    cache: Any,
    tokens: Tensor,
    cur_index: int,
    shd: Optional[Sharder] = None,
) -> Tuple[Tensor, Any]:
    """tokens: (B,1) -> (logits (B,V), cache). ``cur_index`` is the
    position the new token takes; its cache entries are written into
    ``cache`` in place, and the same tree is returned. With int8 weights
    each group is dequantized to the activation dtype just before it
    runs."""
    shd = shd or Sharder()
    cur_index = int(cur_index)
    x = _embed(params, cfg, tokens, shd)
    if cfg.pos_embed == "sinusoidal":
        pos = torch.full((x.shape[0], 1), cur_index, dtype=torch.int32,
                         device=x.device)
        x = x + sinusoidal_pos(pos, cfg.d_model).to(x.dtype)
    x = shd(x, ("act_batch", None, "act_embed"))
    act = torch_dtype(cfg.activation_dtype)
    for i in range(cfg.num_groups):
        gp = _group(params["layers"], i)
        if cfg.weight_quant == "int8":
            gp = quant.dequantize_group(
                gp, _group(params["layers_scale"], i), act)
        x = _decode_group_body(cfg, shd, cur_index, x, gp, _group(cache, i))
    return _logits(params, cfg, x, shd)[:, 0, :], cache


# ---------------------------------------------------------------------------
# cache


def _cache_entry(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                 device: torch.device):
    dt = torch_dtype(cfg.activation_dtype)

    def mk(shape, dtype, axes):
        return P(torch.zeros(shape, dtype=dtype, device=device), axes)

    g = cfg.num_groups
    if spec.mixer == "attn":
        kv = (g, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        ax = ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None)
        mixer = {"k": mk(kv, dt, ax), "v": mk(kv, dt, ax)}
    elif spec.mixer == "mla":
        mixer = {
            "ckv": mk((g, batch, seq, cfg.kv_lora_rank), dt,
                      ("layers", "act_batch", "act_kv_seq", None)),
            "k_rope": mk((g, batch, seq, cfg.qk_rope_dim), dt,
                         ("layers", "act_batch", "act_kv_seq", None)),
        }
    elif spec.mixer == "mamba":
        di = ssm_mod.d_inner_of(cfg)
        mixer = {
            "h": mk((g, batch, di, cfg.ssm_state_dim), torch.float32,
                    ("layers", "act_batch", "act_mlp", None)),
            "conv": mk((g, batch, cfg.ssm_conv_dim - 1, di), dt,
                       ("layers", "act_batch", None, "act_mlp")),
        }
    elif spec.mixer == "rwkv":
        h = rwkv_mod.num_heads_of(cfg)
        k = cfg.rwkv_head_dim
        mixer = {
            "wkv": mk((g, batch, h, k, k), torch.float32,
                      ("layers", "act_batch", "act_heads", None, None)),
            "shift": mk((g, batch, cfg.d_model), dt,
                        ("layers", "act_batch", "act_embed")),
        }
    else:
        raise ValueError(spec.mixer)
    channel = None
    if spec.channel == "rwkv_ffn":
        channel = {"shift": mk((g, batch, cfg.d_model), dt,
                               ("layers", "act_batch", "act_embed"))}
    return {"mixer": mixer, "channel": channel}


def _cache_tree(cfg: ModelConfig, batch: int, seq: int,
                device: torch.device):
    return {
        f"p{k}": _cache_entry(cfg, spec, batch, seq, device)
        for k, spec in enumerate(cfg.layer_pattern)
    }


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Any:
    """A zeroed cache on ``device`` (default: the card)."""
    cache, _ = split_tree(_cache_tree(cfg, batch, seq,
                                      resolve_device(device)))
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> Any:
    cache, _ = split_tree(_cache_tree(cfg, batch, seq,
                                      torch.device("meta")))
    return cache


def cache_logical_axes(cfg: ModelConfig, batch: int = 1, seq: int = 8) -> Any:
    _, axes = split_tree(_cache_tree(cfg, batch, seq, torch.device("meta")))
    return axes


# ---------------------------------------------------------------------------
# loss


def loss_fn(
    params: Any,
    cfg: ModelConfig,
    tokens: Tensor,
    labels: Tensor,
    shd: Optional[Sharder] = None,
    frontend_embeds: Optional[Tensor] = None,
    loss_mask: Optional[Tensor] = None,
    aux_coeff: float = 0.01,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token CE (f32) + MoE aux. labels: (B,S) int32, -1 = ignore."""
    logits, aux, _ = forward(params, cfg, tokens, shd, frontend_embeds)
    valid = labels >= 0
    if loss_mask is not None:
        valid = valid & (loss_mask != 0)
    nll = vocab_nll(shd or Sharder(), logits, torch.where(valid, labels, 0))
    denom = torch.clamp(valid.sum(dtype=torch.int32), min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    loss = ce + aux_coeff * aux
    return loss, {"ce": ce, "aux": aux, "ntokens": denom}
