"""Dry run: every (arch x shape x mesh) LM cell reckoned from shapes, and
the yCHG cells lowered and compiled.

The port's counterpart of ``repro.launch.dryrun``. The reference lowers
and compiles each LM cell with XLA SPMD for 256 or 512 placeholder
devices and reads memory, cost and collectives from the compiled module.
Torch has no SPMD compiler, so each LM cell here is **reckoned from the
shapes and the sharding rules, never compiled or allocated** (the
parameter tree lives on ``meta``), as ``Engine.lower`` reckons a yCHG
cell; every record says so (``"reckoned": true``), and it runs alike on
the CPU and on the card. The mesh is ``make_production_mesh(multi_pod,
abstract=True)``, or an ``AbstractMesh`` of ``--mesh-shape``.

A record keeps the reference's keys where a value can be reckoned:
``params`` and ``active_params``; ``memory.argument_size_in_bytes``, the
per-device bytes of the parameters, plus the optimiser state (train) or
the cache (decode), plus the inputs, each leaf's bytes divided by its
spec's shard count; ``memory.output_size_in_bytes`` (train: the new
parameters and optimiser state; prefill: the last logits and the cache;
decode: the logits and the cache); ``memory.temp_size_in_bytes`` is None:
nothing reckons the temporaries. ``analytic`` (``launch.analytic``),
``model_flops``, ``useful_compute_ratio``, ``roofline`` at the H100's
bfloat16 rate and memory and link rates, ``dominant``, and
``collectives``: per-partition bytes by kind (``reckon_collectives``).
``lower_s``/``compile_s`` become ``reckon_s``.

Collectives (``reckon_collectives``): what the port's meshed step issues,
per partition, each op's bytes by the ring multipliers of
``roofline.ring_bytes``; ``g`` is the group size, B_loc x S the local
tokens (S = 1 in decode), "a group" one period of the layer pattern. The
0-dim all-reduces of metrics, the aux loss and the gradient norm are left
out. Forward (and decode):

  * FSDP: each parameter leaf whose spec uses a batch axis ("pod",
    "data") is all-gathered over those axes before its use, one op a
    layer group (a tied table twice: the lookup and the logits);
  * the vocab-parallel lookup (``layers.vocab_lookup``): its (B_loc, S,
    d) rows, in the table's dtype, all-reduced over the table's vocab
    split;
  * tensor parallel: a layer's mixer (attn/mla ``wo``, mamba ``w_out``,
    rwkv ``w_o``) and channel (``w_down``, the shared expert's too; rwkv
    ``w_v``) whose output projection has "model" on a contracting dim
    all-reduces its (B_loc, S, d) output over "model";
  * MoE on the all-to-all path (``models.moe.alltoall_applies``): two
    all-to-alls of its (E x cap, d) buffer over "model" (cap = max(ceil(cf
    x T_loc/model x k / E), 4)) and its token slices all-gathered back,
    (B_loc, S, d); on the dispatch path: the router's two (E,) float32
    means all-reduced over the batch split, and the replicate fallbacks
    of ``models.layers.on_replicated`` (the expert ids, (T, k) int64, and
    the routed rows, (T x k, d), gathered from their batch shards, the
    expert outputs, (E x cap, d), from their expert split);
  * each rwkv layer's mixing lora output, (B, S, 5 x lora), gathered from
    its batch shards, and a mamba layer's (B_loc, S, 2 x d_inner) input
    projection gathered over its "model" split;
  * train: the vocab-parallel cross-entropy (``layers.vocab_nll``): the
    max, the sum and the labels' logits, (B_loc, S) float32 each,
    all-reduced over the logits' vocab split;
  * decode: each attn/mla layer whose cache splits its sequence
    all-reduces the softmax max and sum, (B_loc, H) float32 each, and the
    weighted values, (B_loc, H, dv) float32 (dv = head_dim; MLA:
    kv_lora_rank), over that split (``attention._split_softmax``); an attn
    layer first gathers the new token's (B_loc, H, head_dim) query over
    its head split and its key and value, (B_loc, G, head_dim) each, over
    theirs; an MLA layer its absorbed query, (B_loc, H, kv_lora_rank), and
    its rope part, (B_loc, H, qk_rope_dim).

The train step's backward: the FSDP all-gathers again (DTensor keeps the
sharded weight for its backward), except for the leaves laid out whole
before their use (the table, the head, the all-to-all's experts and
router); each FSDP leaf's gradient reduce-scattered (result = the local
shard); each gradient replicated over the batch axes all-reduced over
them; the tensor-parallel all-reduces once more; the MoE's two
all-to-alls again.

The forward and decode are what the meshed program issues: the tests
hold the ops and bytes by kind to the collectives logged on a (2, 2) gloo
mesh (``tests/test_torch_sharding_dist.py``, torch 2.13), for the dense,
MLA and MoE decode and the dense and MoE all-to-all train forward (the
dispatch path's train forward, where DTensor lays the expert buffers out
as it chooses, is not held). The backward is the partitioner's ideal:
DTensor's moves more (in the gloo run's steps, it gathers weights over
"model" and reduce-scatters activation gradients in the projections'
backward; ROADMAP Queue C), so a train cell's collective bytes are a
lower bound, which the tests hold too. The dec2d variants'
weight-stationary layout is reckoned as FSDP. Importing this module sets
nothing in the environment.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--device cpu]
      [--arch qwen3-4b] [--shape train_4k] [--mesh single|multi|both]
      [--variant base] [--mesh-shape 32x8] [--out results/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ychg [--device cpu]
      [--ychg-max-res 21000] [--out results/dryrun]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, list_archs, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import analytic, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (
    abstract_cache,
    abstract_params,
    cache_logical_axes,
    param_logical_axes,
)
from repro_torch.models.layers import torch_dtype, tree_leaves_with_path
from repro_torch.models.model import active_params, count_params
from repro_torch.models.moe import alltoall_applies, capacity
from repro_torch.sharding.logical import (
    AbstractMesh,
    make_rules,
    mesh_shape,
    shard_count,
    spec_axes,
    spec_for,
)

BATCH_AXES = ("pod", "data")
# a mixer's or channel's output projection, whose contracting dims decide
# its tensor-parallel all-reduce
OUT_PROJ = {"attn": "wo", "mla": "wo", "mamba": "w_out", "rwkv": "w_o",
            "mlp": "w_down", "moe": "w_down", "rwkv_ffn": "w_v"}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        d = {"tokens": meta((b, s), torch.int32),
             "labels": meta((b, s), torch.int32)}
    elif shape.kind == "prefill":
        d = {"tokens": meta((b, s), torch.int32)}
    else:  # decode: one new token; the cache is a separate argument
        return {"tokens": meta((b, 1), torch.int32)}
    if cfg.frontend != "none" and cfg.frontend_tokens:
        d["frontend_embeds"] = meta((b, cfg.frontend_tokens, cfg.d_model),
                                    torch_dtype(cfg.activation_dtype))
    return d


def _batch_shardings(cfg, shape, rules, mesh, specs):
    out = {}
    for k, v in specs.items():
        if k in ("tokens", "labels"):
            axes = ("act_batch", "act_seq")
        else:  # frontend_embeds
            axes = ("act_batch", "act_seq", "act_embed")
        out[k] = spec_for(axes, rules, mesh, v.shape)
    return out


def _cell_rules(cfg: ModelConfig, shape: ShapeConfig):
    overrides = dict(cfg.decode_rule_overrides) if shape.kind == "decode" \
        else {}
    overrides.update(shape.rule_overrides)
    return make_rules(shape.kind, overrides)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _specs(axes_tree, shape_tree, rules, mesh):
    """(key path, leaf, spec) for every leaf of a tree."""
    axes = dict(tree_leaves_with_path(axes_tree))
    for path, leaf in tree_leaves_with_path(shape_tree):
        yield path, leaf, spec_for(axes[path], rules, mesh, leaf.shape)


def _local_bytes(leaf, spec, mesh) -> int:
    return _nbytes(leaf) // shard_count(spec, mesh)


def param_bytes_per_device(cfg: ModelConfig, rules, mesh) -> int:
    """The parameters' bytes on one device of ``mesh`` under ``rules``."""
    return sum(_local_bytes(leaf, spec, mesh) for _, leaf, spec in _specs(
        param_logical_axes(cfg), abstract_params(cfg), rules, mesh))


def reckon_memory(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  rules) -> Dict[str, Any]:
    """Per-device argument and output bytes of the cell's step."""
    params = param_bytes_per_device(cfg, rules, mesh)
    specs = input_specs(cfg, shape)
    inputs = sum(_local_bytes(specs[k], spec, mesh) for k, spec in
                 _batch_shardings(cfg, shape, rules, mesh, specs).items())
    b, v = shape.global_batch, cfg.vocab_size
    if shape.kind == "train":
        # AdamW: two float32 moments laid out as the parameters, the step
        moments = sum(
            2 * leaf.numel() * 4 // shard_count(spec, mesh)
            for _, leaf, spec in _specs(param_logical_axes(cfg),
                                        abstract_params(cfg), rules, mesh))
        state = moments + 4
        args, out = params + state + inputs, params + state
    else:
        cache = sum(_local_bytes(leaf, spec, mesh) for _, leaf, spec in
                    _specs(cache_logical_axes(cfg, b, shape.seq_len),
                           abstract_cache(cfg, b, shape.seq_len), rules,
                           mesh))
        logit = torch.empty((b, v), dtype=torch_dtype(cfg.activation_dtype),
                            device="meta")
        logits = _local_bytes(logit, spec_for(("act_batch", "act_vocab"),
                                              rules, mesh, (b, v)), mesh)
        if shape.kind == "prefill":
            args, out = params + inputs, logits + cache
        else:   # the cache and the position are arguments too
            args, out = params + cache + inputs + 4, logits + cache
    return {"argument_size_in_bytes": args, "output_size_in_bytes": out,
            "temp_size_in_bytes": None,
            "temp_note": "not reckoned: torch has no compiled module to "
                         "read temporaries from"}


def reckon_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       rules) -> Dict[str, Any]:
    """Per-partition collective bytes of the cell's step by kind (the
    module docstring's patterns), op counts (``_count_<kind>``), bytes by
    pattern (``by_pattern``), and the forward's part of both
    (``forward``: ``bytes`` and ``counts`` by kind)."""
    sizes = mesh_shape(mesh)
    train, decode = shape.kind == "train", shape.kind == "decode"
    kinds = {t: 0.0 for t in roofline.COLL_TYPES}
    counts = {t: 0 for t in roofline.COLL_TYPES}
    forward = {"bytes": dict(kinds), "counts": dict(counts)}
    by_pattern: Dict[str, float] = {}

    def add(pattern, op, result_bytes, g, times=1, backward=False):
        if g <= 1 or not times or not result_bytes:
            return
        moved = roofline.ring_bytes(op, result_bytes, g) * times
        kinds[op] += moved
        counts[op] += times
        by_pattern[pattern] = by_pattern.get(pattern, 0.0) + moved
        if not backward:
            forward["bytes"][op] += moved
            forward["counts"][op] += times

    def axes_of(spec, dims=None):
        entries = list(spec) if dims is None else list(spec)[dims]
        return {a for e in entries for a in spec_axes(e)}

    def split(spec, dim, exclude=()):
        """The size of the group of mesh axes that split dim ``dim``."""
        return math.prod(sizes[a] for a in axes_of(spec, slice(dim, dim + 1))
                         if a not in exclude)

    groups = cfg.num_groups
    b, d = shape.global_batch, cfg.d_model
    s = 1 if decode else shape.seq_len
    alltoall = alltoall_applies(cfg, mesh, (b, s, d))
    params = dict(tree_leaves_with_path(abstract_params(cfg)))
    param_specs = {path: spec for path, _, spec in _specs(
        param_logical_axes(cfg), abstract_params(cfg), rules, mesh)}
    # leaves laid out whole before their use, whose gathered copy the
    # backward keeps: the table and the head, and the experts and the
    # router of the all-to-all; DTensor gathers every other one again in
    # the backward
    kept = {("embed",), ("lm_head",)}
    if alltoall:
        kept |= {("layers", f"p{k}", "channel", name)
                 for k, spec in enumerate(cfg.layer_pattern)
                 if spec.channel == "moe"
                 for name in ("router", "w_gate", "w_up", "w_down")}
    for path, leaf in params.items():
        spec = param_specs[path]
        used = axes_of(spec)
        local = _local_bytes(leaf, spec, mesh)
        g_fsdp = math.prod(sizes[a] for a in BATCH_AXES if a in used)
        ops = groups if path[0] in ("layers", "layers_scale") else 1
        uses = 2 if path == ("embed",) and cfg.tie_embeddings else 1
        add("fsdp_all_gather", "all-gather", local * g_fsdp // ops, g_fsdp,
            ops * uses)
        if train and path not in kept:
            add("fsdp_all_gather", "all-gather", local * g_fsdp // ops,
                g_fsdp, ops * uses, backward=True)
        if train:
            add("fsdp_reduce_scatter", "reduce-scatter", local, g_fsdp,
                backward=True)
            g_dp = math.prod(sizes[a] for a in BATCH_AXES
                             if a in sizes and a not in used)
            add("dp_all_reduce", "all-reduce", local, g_dp, backward=True)

    act = torch_dtype(cfg.activation_dtype).itemsize
    act_spec = spec_for(("act_batch", "act_seq", "act_embed"), rules, mesh,
                        (b, s, d))
    act_bytes = b * s * d * act // shard_count(act_spec, mesh)
    g_batch = shard_count(act_spec, mesh)
    g_model = sizes.get("model", 1)
    tok_spec = spec_for(("act_batch", "act_seq"), rules, mesh, (b, s))
    tok_axes = axes_of(tok_spec)
    rows = b * s // shard_count(tok_spec, mesh)

    # the vocab-parallel lookup: its rows, in the table's dtype, summed
    # over the table's vocab split (its FSDP gather counted above)
    g_vocab_table = split(param_specs[("embed",)], 0, exclude=tok_axes)
    add("vocab_lookup_all_reduce", "all-reduce",
        rows * d * params[("embed",)].element_size(), g_vocab_table)

    def row_parallel(path) -> bool:
        """Whether "model" splits a contracting (not the last) dim."""
        ndim = params[path].dim()
        return "model" in axes_of(param_specs[path], slice(0, ndim - 1))

    def tp_all_reduce(path):
        if row_parallel(path):
            add("tp_all_reduce", "all-reduce", act_bytes, g_model, groups)
            if train:
                add("tp_all_reduce", "all-reduce", act_bytes, g_model,
                    groups, backward=True)

    for k, spec in enumerate(cfg.layer_pattern):
        layer = ("layers", f"p{k}")
        tp_all_reduce((*layer, "mixer", OUT_PROJ[spec.mixer]))
        if spec.channel == "moe" and alltoall:
            e, k_ = cfg.num_experts, cfg.experts_per_token
            tpd = (b // math.prod(sizes.get(a, 1) for a in BATCH_AXES)) \
                * s // g_model
            cap = max(-(-int(cfg.moe_capacity_factor * tpd * k_) // e), 4)
            add("moe_all_to_all", "all-to-all", e * cap * d * act, g_model,
                2 * groups)
            if train:
                add("moe_all_to_all", "all-to-all", e * cap * d * act,
                    g_model, 2 * groups, backward=True)
            add("moe_all_to_all", "all-gather", act_bytes, g_model, groups)
        elif spec.channel == "moe":
            k_ = cfg.experts_per_token
            # the router's two (E,) means over the batch rows
            add("moe_router_all_reduce", "all-reduce",
                cfg.num_experts * 4, g_batch, 2 * groups)
            add("replicate_fallback", "all-gather", b * s * k_ * 8,
                g_batch, groups)
            add("replicate_fallback", "all-gather", b * s * k_ * d * act,
                g_batch, groups)
            e_path = (*layer, "channel", "w_down")
            g_experts = math.prod(sizes[a] for a in axes_of(
                param_specs[e_path], slice(1, 2)))
            add("replicate_fallback", "all-gather",
                cfg.num_experts * capacity(cfg, b * s) * d * act, g_experts,
                groups)
        else:
            tp_all_reduce((*layer, "channel", OUT_PROJ[spec.channel]))
        if (*layer, "channel", "shared", "w_down") in param_specs:
            tp_all_reduce((*layer, "channel", "shared", "w_down"))
        if spec.mixer == "rwkv":
            add("replicate_fallback", "all-gather",
                b * s * 5 * cfg.rwkv_mix_lora * act, g_batch, groups)
        if spec.mixer == "mamba":
            di = cfg.ssm_expand * d
            g_mlp = math.prod(sizes[a] for a in axes_of(spec_for(
                ("act_batch", "act_seq", "act_mlp"), rules, mesh,
                (b, s, 2 * di)), slice(2, 3)))
            add("mamba_split_all_gather", "all-gather",
                b * s * 2 * di * act // g_batch, g_mlp, groups)

    if train:   # the vocab-parallel cross-entropy: max, sum, the label's
        v_spec = spec_for(("act_batch", "act_seq", "act_vocab"), rules, mesh,
                          (b, s, cfg.vocab_size))
        add("vocab_softmax_all_reduce", "all-reduce", rows * 4,
            split(v_spec, 2), 3)

    if decode:
        c_axes = dict(tree_leaves_with_path(
            cache_logical_axes(cfg, b, shape.seq_len)))
        c_leaves = dict(tree_leaves_with_path(
            abstract_cache(cfg, b, shape.seq_len)))
        h = cfg.num_heads
        for k, spec in enumerate(cfg.layer_pattern):
            if spec.mixer not in ("attn", "mla"):
                continue
            mixer = ("layers", f"p{k}", "mixer")
            name = "k" if spec.mixer == "attn" else "ckv"
            path = ("p" + str(k), "mixer", name)
            c_spec = spec_for(c_axes[path], rules, mesh,
                              c_leaves[path].shape)
            b_loc = b // split(c_spec, 1)
            dv = cfg.head_dim if spec.mixer == "attn" else cfg.kv_lora_rank
            for result in (b_loc * h * 4, b_loc * h * 4, b_loc * h * dv * 4):
                add("kv_seq_all_reduce", "all-reduce", result,
                    split(c_spec, 2), groups)
            # the new token's queries gathered over their head split
            if spec.mixer == "attn":
                add("kv_seq_all_reduce", "all-gather",
                    b_loc * h * cfg.head_dim * act,
                    split(param_specs[(*mixer, "wq")], 2), groups)
                # its keys and values, into the cache's layout
                add("kv_seq_all_reduce", "all-gather",
                    b_loc * cfg.num_kv_heads * cfg.head_dim * act,
                    split(param_specs[(*mixer, "wk")], 2,
                          exclude=axes_of(c_spec, slice(3, 4))), 2 * groups)
            else:   # the absorbed query and its rope part
                add("kv_seq_all_reduce", "all-gather",
                    b_loc * h * cfg.kv_lora_rank * act,
                    split(param_specs[(*mixer, "wk_up")], 2), groups)
                add("kv_seq_all_reduce", "all-gather",
                    b_loc * h * cfg.qk_rope_dim * act,
                    split(param_specs[(*mixer, "wq_up")], 2), groups)

    out: Dict[str, Any] = dict(kinds)
    out["total"] = sum(kinds.values())
    for t in roofline.COLL_TYPES:
        out["_count_" + t] = counts[t]
    out["by_pattern"] = by_pattern
    out["forward"] = forward
    return out


def run_cell(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
             verbose: bool = True,
             mesh_shape_: Optional[tuple] = None) -> Dict[str, Any]:
    """One LM cell reckoned from shapes and the rules (nothing compiled
    or allocated)."""
    if mesh_shape_ is not None:  # exploration; production mesh is (16,16)
        mesh = AbstractMesh(tuple(mesh_shape_), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, abstract=True)
    rules = _cell_rules(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": list(mesh.axis_sizes),
        "chips": mesh.size,
        "reckoned": True,
        "params": count_params(cfg),
        "active_params": active_params(cfg),
    }
    t0 = time.monotonic()
    try:
        rec["memory"] = reckon_memory(cfg, shape, mesh, rules)
        rec["collectives"] = reckon_collectives(cfg, shape, mesh, rules)
        an = analytic.report(cfg, shape)
        rec["analytic"] = an
        rec["roofline"] = roofline.terms(
            flops_global=an["flops"],
            bytes_global=an["hbm_bytes"],
            coll_bytes_per_partition=rec["collectives"]["total"],
            n_partitions=mesh.size,
            operation="bfloat16",
        )
        mf = roofline.model_flops(cfg, shape)
        rec["model_flops"] = mf
        rec["useful_compute_ratio"] = mf / an["flops"] if an["flops"] else 0.0
        rec["dominant"] = roofline.dominant(rec["roofline"])
        rec["reckon_s"] = time.monotonic() - t0
        rec["ok"] = True
        if verbose:
            r = rec["roofline"]
            print(
                f"[OK] {cfg.name} x {shape.name} x {rec['mesh']} (reckoned): "
                f"args={rec['memory']['argument_size_in_bytes']:,} B/device "
                f"compute={r['compute_s']:.4g}s mem={r['memory_s']:.4g}s "
                f"coll={r['collective_s']:.4g}s dominant={rec['dominant']} "
                f"useful={rec['useful_compute_ratio']:.3f}",
                flush=True,
            )
    except Exception as e:  # noqa: BLE001 — record and continue, report at end
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {cfg.name} x {shape.name} x {rec['mesh']}: "
                  f"{rec['error']}", flush=True)
    rec["total_s"] = time.monotonic() - t0
    return rec


def run_ychg_cells(out_dir: str, max_res: int = 2000,
                   device: Optional[str] = None) -> int:
    """Engine-driven yCHG dry run: lower and compile the workload's batched
    path per resolution without allocating a single stack.

    Uses the ``engine`` section of ``configs/ychg_modis.py``: on the CPU
    with backend ``torch`` (the JAX package's ``jax``), on the card
    (``device`` None or ``"cuda"``) with the section's own ``auto``, which
    resolves to ``fused``, so the kernels are built. Returns the number of
    failed cells.
    """
    from repro_torch.configs.ychg_modis import config as ychg_config
    from repro_torch.engine import Engine

    wl = ychg_config()
    on_cpu = device is not None and str(device) == "cpu"
    cfg = (wl.engine.to_engine_config(backend="torch") if on_cpu
           else wl.engine.to_engine_config())
    engine = Engine(cfg, device=device)
    os.makedirs(out_dir, exist_ok=True)
    n_fail = 0
    for res in [r for r in wl.resolutions if r <= max_res]:
        tag = f"ychg__{wl.name}__b{wl.batch}_res{res}"
        rec: Dict[str, Any] = {
            "workload": wl.name,
            "backend": engine.resolve_backend(),
            "device": str(engine.device),
            "batch": wl.batch,
            "resolution": res,
        }
        t0 = time.monotonic()
        try:
            lowered = engine.lower((wl.batch, res, res))
            rec["lower_s"] = time.monotonic() - t0
            t1 = time.monotonic()
            compiled = lowered.compile()
            rec["compile_s"] = time.monotonic() - t1
            rec["build_s"] = compiled.build_seconds
            cost = roofline.cost_dict(compiled)
            mem = compiled.memory_analysis()
            rec["route"] = compiled.route
            rec["cost"] = {
                "flops": float(cost.get("flops", 0.0)),
                "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
                "kernel_bytes": cost["kernel bytes"],
                "op_bytes": cost["op bytes"],
            }
            rec["kernels"] = cost["launches"]
            rec["memory"] = {
                k: getattr(mem, k)
                for k in ("argument_size_in_bytes", "output_size_in_bytes",
                          "temp_size_in_bytes")
            }
            terms = roofline.terms(flops_global=rec["cost"]["flops"],
                                   bytes_global=rec["cost"]["bytes_accessed"],
                                   operation=cost["operation"])
            rec["roofline"] = terms
            rec["bound_ms"] = max(terms["compute_s"], terms["memory_s"]) * 1e3
            rec["ok"] = True
            print(f"[OK] {tag}: route={rec['route']} flops="
                  f"{rec['cost']['flops']:.3g} bytes="
                  f"{rec['cost']['bytes_accessed']:.3g} bound="
                  f"{rec['bound_ms']:.4f}ms launches={rec['kernels']}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
            n_fail += 1
            print(f"[FAIL] {tag}: {rec['error']}", flush=True)
        rec["total_s"] = time.monotonic() - t0
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return n_fail


# named config variants of the reference's exploration sweep
VARIANTS = {
    "base": lambda c: c,
    "a2a": lambda c: c.scaled(moe_impl="alltoall"),
    "remat_dots": lambda c: c.scaled(remat="dots"),
    "remat_none": lambda c: c.scaled(remat="none"),
    "chunk4k": lambda c: c.scaled(attn_chunk=4096),
    "chunk2k": lambda c: c.scaled(attn_chunk=2048),
    "a2a_dots": lambda c: c.scaled(moe_impl="alltoall", remat="dots"),
    "wq8": lambda c: c.scaled(weight_quant="int8"),
    # decode weight-stationary 2D expert sharding: experts over "model",
    # expert d_ff over "data"
    "dec2d": lambda c: c.scaled(decode_rule_overrides={
        "embed": None, "mlp": "data", "act_mlp": "data"}),
    "dec2d_wq8": lambda c: c.scaled(
        weight_quant="int8", decode_rule_overrides={
            "embed": None, "mlp": "data", "act_mlp": "data"}),
}


def run_lm_cells(out_dir: str, arch: str = "all", shape_name: str = "all",
                 mesh: str = "both", variant: str = "base",
                 mesh_shape_: Optional[str] = None) -> int:
    """Reckons every (arch x shape x mesh) cell asked for and writes one
    record a cell, ``<arch>__<shape>__<mesh>[__<variant>][__m<shape>]
    .json``; a cached ``ok`` record is kept. Returns the number of failed
    cells."""
    ms = (tuple(int(v) for v in mesh_shape_.split("x"))
          if mesh_shape_ else None)
    archs = list_archs() if arch == "all" else [arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[mesh]
    os.makedirs(out_dir, exist_ok=True)
    n_ok = n_fail = 0
    for name in archs:
        cfg = VARIANTS[variant](get_config(name))
        for shape in shapes_for(cfg):
            if shape_name != "all" and shape.name != shape_name:
                continue
            for mp in meshes:
                suffix = "" if variant == "base" else f"__{variant}"
                if mesh_shape_:
                    suffix += f"__m{mesh_shape_}"
                tag = (f"{name}__{shape.name}__"
                       f"{'multi' if mp else 'single'}{suffix}")
                path = os.path.join(out_dir, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            print(f"[skip] {tag} (cached)", flush=True)
                            n_ok += 1
                            continue
                rec = run_cell(cfg, shape, mp, mesh_shape_=ms)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed (reckoned)",
          flush=True)
    return n_fail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Reckon every LM cell from shapes and the sharding "
                    "rules, or lower and compile the yCHG workload's cells "
                    "(--ychg), without allocating them.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 32x8: a (data, model) mesh in place of the "
                         "production one")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--ychg", action="store_true",
                    help="dry-run the yCHG engine cells (configs/ychg_modis "
                         "engine section) instead of the LM arch sweep")
    ap.add_argument("--ychg-max-res", type=int, default=2000)
    ap.add_argument("--device", default=None,
                    help="'cpu' to lower the yCHG cells on the CPU; default: "
                         "the card (the LM cells touch no device)")
    args = ap.parse_args(argv)
    if args.ychg:
        raise SystemExit(1 if run_ychg_cells(
            args.out, max_res=args.ychg_max_res, device=args.device) else 0)
    raise SystemExit(1 if run_lm_cells(
        args.out, args.arch, args.shape, args.mesh, args.variant,
        args.mesh_shape) else 0)


if __name__ == "__main__":
    main()
