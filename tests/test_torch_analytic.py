"""The LM dry run's arithmetic against the JAX package's, and its reckoning.

``launch.analytic`` (``report``, ``flops``, ``hbm_bytes``) and
``roofline.model_flops`` equal the JAX package's to the last bit for
every architecture x ``shapes_for`` x ``VARIANTS``; ``collective_bytes``,
``extrapolate`` and ``terms`` pass the twins of ``tests/test_dryrun.py``
(the synthetic HLO); ``input_specs`` and the cell rules equal JAX's;
each cell's reckoned per-device argument bytes equal the sum worked out
here from JAX's own specs; every cell of the sweep is ``ok`` on the CPU;
and ``reckon_collectives`` is held to values worked by hand on a dense
and a MoE config, a train and a decode cell each. The JAX dry-run module
sets ``XLA_FLAGS`` when it is imported, so it is imported with the
environment restored after.
"""

import dataclasses
import json
import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.sharding import logical as jlogical  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import analytic, dryrun, roofline  # noqa: E402
from repro_torch.sharding.logical import AbstractMesh  # noqa: E402

with mock.patch.dict(os.environ):
    from repro.launch import dryrun as jdryrun  # noqa: E402

ARCHS = jconfigs.list_archs()


@dataclasses.dataclass(frozen=True)
class StubMesh:
    shape: dict


PRODUCTION = {False: StubMesh({"data": 16, "model": 16}),
              True: StubMesh({"pod": 2, "data": 16, "model": 16})}


# ---- analytic and model_flops, bit for bit


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_and_model_flops_match_jax(arch):
    assert sorted(dryrun.VARIANTS) == sorted(jdryrun.VARIANTS)
    for variant in sorted(dryrun.VARIANTS):
        jcfg = jdryrun.VARIANTS[variant](jconfigs.get_config(arch))
        tcfg = dryrun.VARIANTS[variant](tconfigs.get_config(arch))
        for jshape, tshape in zip(jconfigs.shapes_for(jcfg),
                                  tconfigs.shapes_for(tcfg)):
            what = (arch, variant, tshape.name)
            assert analytic.report(tcfg, tshape) == \
                janalytic.report(jcfg, jshape), what
            assert analytic.flops(tcfg, tshape) == \
                janalytic.flops(jcfg, jshape), what
            assert analytic.hbm_bytes(tcfg, tshape) == \
                janalytic.hbm_bytes(jcfg, jshape), what
            assert roofline.model_flops(tcfg, tshape) == \
                jroofline.model_flops(jcfg, jshape), what


# ---- twins of tests/test_dryrun.py's parser, extrapolation and terms

HLO = """
  %ag = f32[512,128]{1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = bf16[1024]{0} all-reduce(%y), replica_groups=[16,16]<=[16,16]T(1,0)
  %cp = s32[64]{0} collective-permute(%z), source_target_pairs={{0,1},{1,0}}
  %rs = f32[32]{0} reduce-scatter(%w), replica_groups=[2,8]<=[16]
"""
MORE_HLO = """
  %a2a = bf16[4,8,32]{2,1,0} all-to-all(%q), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %ars = (f32[64]{0}, f32[64]{0}) all-reduce-start(%u), replica_groups=[8,2]<=[16]
  %ard = f32[64]{0} all-reduce-done(%ars)
  %agi = s8[256]{0} all-gather(%v), replica_groups={{0,1}}
  %nothing = f32[8]{0} add(%p, %q)
"""


def test_collective_parser_on_synthetic_hlo():
    out = roofline.collective_bytes(HLO)
    # f32 clamped to bf16: 512*128*2 = 131072; ring (g-1)/g with g=16
    assert abs(out["all-gather"] - 131072 * 15 / 16) < 1
    assert abs(out["all-reduce"] - 1024 * 2 * 2 * 15 / 16) < 1
    assert out["collective-permute"] == 64 * 4  # ints not clamped
    assert abs(out["reduce-scatter"] - 32 * 2 * 7) < 1
    assert out["_count_all-reduce"] == 1


@pytest.mark.parametrize("hlo", [HLO, MORE_HLO, HLO + MORE_HLO])
@pytest.mark.parametrize("clamp", [True, False])
def test_collective_parser_matches_jax(hlo, clamp):
    for group in (16, 4):
        assert roofline.collective_bytes(
            hlo, clamp_float_to_bf16=clamp, default_group=group) == \
            jroofline.collective_bytes(hlo, clamp_float_to_bf16=clamp,
                                       default_group=group)


def test_extrapolation():
    m1 = {"flops": 10.0, "total": 4.0}
    m2 = {"flops": 16.0, "total": 7.0}
    out = roofline.extrapolate(m1, m2, 10)
    assert out["flops"] == 10.0 - 6.0 + 10 * 6.0
    assert out["total"] == 4.0 - 3.0 + 10 * 3.0
    assert out == jroofline.extrapolate(m1, m2, 10)


def test_roofline_terms_and_dominant():
    t = roofline.terms(flops_global=1e15, bytes_global=1e12,
                       coll_bytes_per_partition=1e9, n_partitions=256,
                       operation="bfloat16")
    assert t["compute_s"] == pytest.approx(1e15 / (256 * 989e12))
    assert t["memory_s"] == pytest.approx(1e12 / (256 * 3.35e12))
    assert t["collective_s"] == pytest.approx(1e9 / 450e9)
    assert roofline.dominant(t) in ("compute_s", "memory_s", "collective_s")
    assert roofline.PEAK_OPS_PER_S["bfloat16"] == 989e12


# ---- the dry run's cells


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_cell_rules_match_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for jshape, tshape in zip(jconfigs.shapes_for(jcfg),
                              tconfigs.shapes_for(tcfg)):
        want = jdryrun.input_specs(jcfg, jshape)
        got = dryrun.input_specs(tcfg, tshape)
        assert list(got) == list(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (arch, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(
                v.dtype), (arch, k)
            assert got[k].device.type == "meta"
        assert dryrun._cell_rules(tcfg, tshape) == \
            jdryrun._cell_rules(jcfg, jshape)


def _jax_bytes(axes_tree, shape_tree, rules, mesh) -> int:
    """Per-device bytes of a JAX tree under JAX's own specs."""
    import jax

    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(a, (str, type(None))) for a in x)
    total = 0
    for axes, leaf in zip(jax.tree_util.tree_leaves(axes_tree,
                                                    is_leaf=is_axes),
                          jax.tree_util.tree_leaves(shape_tree)):
        spec = jlogical.spec_for(axes, rules, mesh, leaf.shape)
        pieces = int(np.prod([mesh.shape[a] for e in spec if e is not None
                              for a in ((e,) if isinstance(e, str) else e)]))
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // pieces
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_from_jax_specs(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jaxes = jmodels.param_logical_axes(jcfg)
    jparams = jmodels.abstract_params(jcfg)
    for jshape, tshape in zip(jconfigs.shapes_for(jcfg),
                              tconfigs.shapes_for(tcfg)):
        rules = jdryrun._cell_rules(jcfg, jshape)
        for multi, mesh in PRODUCTION.items():
            params = _jax_bytes(jaxes, jparams, rules, mesh)
            inputs = 0
            for k, v in jdryrun.input_specs(jcfg, jshape).items():
                axes = (("act_batch", "act_seq") if k in ("tokens", "labels")
                        else ("act_batch", "act_seq", "act_embed"))
                inputs += _jax_bytes(
                    {"x": axes}, {"x": v}, rules, mesh)
            if jshape.kind == "train":
                import jax

                moments = jax.tree_util.tree_map(
                    lambda p: jax.ShapeDtypeStruct(p.shape, np.float32),
                    jparams)
                want = params + 2 * _jax_bytes(jaxes, moments, rules,
                                               mesh) + 4 + inputs
            elif jshape.kind == "prefill":
                want = params + inputs
            else:
                b, s = jshape.global_batch, jshape.seq_len
                want = params + _jax_bytes(
                    jmodels.cache_logical_axes(jcfg, b, s),
                    jmodels.abstract_cache(jcfg, b, s), rules, mesh) \
                    + inputs + 4
            rec = dryrun.run_cell(tcfg, tshape, multi, verbose=False)
            assert rec["ok"], rec.get("traceback")
            assert rec["memory"]["argument_size_in_bytes"] == want, (
                arch, jshape.name, multi)


def test_lm_sweep_every_cell_ok_on_the_cpu(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--device", "cpu", "--out", str(tmp_path)])
    assert exc.value.code == 0
    recs = [json.loads(p.read_text()) for p in sorted(
        Path(tmp_path).glob("*.json"))]
    cells = sum(2 * len(tconfigs.shapes_for(tconfigs.get_config(a)))
                for a in ARCHS)
    assert len(recs) == cells == 64
    for r in recs:
        assert r["ok"] and r["reckoned"], r["arch"]
        assert "compile_s" not in r and "lower_s" not in r
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
        assert r["memory"]["temp_size_in_bytes"] is None
        assert r["model_flops"] > 0 and r["collectives"]["total"] >= 0
        assert r["roofline"]["compute_s"] == pytest.approx(
            r["analytic"]["flops"] / (r["chips"] * 989e12))
    assert "64 ok, 0 failed (reckoned)" in capsys.readouterr().out


# ---- collective reckoning, worked by hand

MESH = AbstractMesh((2, 4), ("data", "model"))
DENSE = ModelConfig(name="t-dense", family="dense", num_layers=2, d_model=64,
                    num_heads=8, num_kv_heads=4, d_ff=128, vocab_size=256)
MOE = ModelConfig(name="t-moe", family="moe", num_layers=2, d_model=64,
                  num_heads=8, num_kv_heads=4, d_ff=32, vocab_size=256,
                  num_experts=4, experts_per_token=2,
                  layer_pattern=(LayerSpec("attn", "moe"),), remat="none",
                  moe_impl="alltoall")
TRAIN = ShapeConfig("t", "train", 16, 8)
DECODE = ShapeConfig("d", "decode", 32, 8)

# Per-device (local) float32 parameter bytes on (data 2, model 4), train
# rules: embed and lm_head (256 x 64, split 8 ways) 8192 each; wq and wo
# (2 x 64 x 8 x 8) 4096; wk and wv (2 x 64 x 4 x 8) 2048; the MLP's three
# (2 x 64 x 128) 8192 each, the experts' three (2 x 4 x 64 x 32) 8192
# each; all of these use "data", so each is all-gathered in the forward
# (one op a layer group: 16 ops, ring traffic result x 1/2 = local, 53,248
# B in both configs) and reduce-scattered (local x 1, one op a leaf).
# DTensor gathers the layers' weights again in the backward (the dense
# model's seven, 36,864 B; the MoE's four attention ones, 12,288 B: the
# all-to-all keeps its gathered experts), not the table and the head,
# which are laid out whole before their use. Replicated over "data",
# all-reduced (local x 2 x 1/2): final_norm 256, norm1 and norm2 (2 x 64)
# 512 each, the router (2 x 64 x 4) 2048. Activations (8, 16, 64)
# bfloat16 over data: 8192 B a rank; a TP all-reduce over model 4 moves
# 8192 x 2 x 3/4 = 12,288, once a layer group in the forward and again in
# the backward. The vocab-parallel lookup sums its (4 x 16, 64) float32
# rows, 16,384 B, over the table's vocab split (model 4): 24,576 moved;
# the cross-entropy its (64,) float32 max, sum and label logits, 256 B,
# 384 moved each. Decode (8, 1, 64): 512 B a rank, 768 moved an
# all-reduce; the lookup's (4, 64) float32 rows 1024 B, 1536 moved; the
# KV cache's sequence over model 4, 4 rows a rank: max and sum (4 x 8)
# float32 = 128 B, values (4 x 8 x 8) = 1024 B, x 3/2 moved: 192 + 192 +
# 1536 a layer; the new token's query (4 x 8 x 8) bfloat16 = 512 B
# gathered over its head split (384 moved), its key and value (4 x 4 x 8)
# = 256 B each over theirs (192 moved).
CASES = {
    # two groups: wo and w_down all-reduce a layer, forward and backward
    ("dense", "train"): {
        "all-gather": 53248 + 36864, "reduce-scatter": 53248,
        "all-reduce": (256 + 512 + 512) + 24576 + 8 * 12288 + 3 * 384,
        "all-to-all": 0, "counts": {"all-gather": 16 + 14,
                                    "reduce-scatter": 9,
                                    "all-reduce": 3 + 1 + 8 + 3}},
    # no FSDP in decode; wo and w_down all-reduce once a layer; 2 groups
    ("dense", "decode"): {
        "all-gather": 2 * 384 + 4 * 192, "reduce-scatter": 0,
        "all-reduce": 1536 + 4 * 768 + 2 * (192 + 192 + 1536),
        "all-to-all": 0, "counts": {"all-gather": 2 + 4,
                                    "all-reduce": 1 + 4 + 6}},
    # the MoE on the all-to-all path: T_loc = 4 x 16 = 64, 16 a model
    # rank, cap = max(ceil(1.25 x 16 x 2 / 4), 4) = 10, buffer 4 x 10 x
    # 64 x 2 = 5120 B, 3840 moved, two exchanges x 2 (backward) x 2
    # groups; its slices gathered back over model (8192 B, 6144 moved)
    # once a group; wo alone all-reduces (2 forward, 2 backward)
    ("moe", "train"): {
        "all-gather": 53248 + 12288 + 2 * 6144, "reduce-scatter": 53248,
        "all-reduce": (256 + 512 + 512 + 2048) + 24576 + 4 * 12288
        + 3 * 384,
        "all-to-all": 8 * 3840,
        "counts": {"all-gather": 16 + 8 + 2, "reduce-scatter": 9,
                   "all-reduce": 4 + 1 + 4 + 3, "all-to-all": 8}},
    # decode on the dispatch path: wo all-reduces once a layer (the
    # experts' output comes back whole); the router's two (4,) float32
    # means over the 2 batch shards (16 moved each); the expert ids, (8,
    # 2) int64 = 128 B, and the routed rows, (16, 64) bfloat16 = 2048 B,
    # gathered from 2 batch shards (64 and 1024 moved), the expert
    # outputs, (4 x cap 8, 64) bfloat16 = 4096 B, from the 4 expert
    # shards (3072 moved), and the attention's gathers as in the dense
    # decode, once a layer
    ("moe", "decode"): {
        "all-gather": 2 * (64 + 1024 + 3072 + 384 + 2 * 192),
        "reduce-scatter": 0,
        "all-reduce": 4 * 16 + 1536 + 2 * 768 + 2 * (192 + 192 + 1536),
        "all-to-all": 0, "counts": {"all-gather": 12,
                                    "all-reduce": 4 + 1 + 2 + 6}},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reckoned_collectives_worked_by_hand(case):
    model, kind = case
    cfg = DENSE if model == "dense" else MOE
    if case == ("moe", "decode"):
        cfg = cfg.scaled(moe_impl="dispatch")
    shape = TRAIN if kind == "train" else DECODE
    rules = dryrun._cell_rules(cfg, shape)
    got = dryrun.reckon_collectives(cfg, shape, MESH, rules)
    want = CASES[case]
    for op in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all"):
        assert got[op] == want[op], (case, op, got)
    assert got["collective-permute"] == 0
    assert got["total"] == sum(want[op] for op in (
        "all-gather", "reduce-scatter", "all-reduce", "all-to-all"))
    for op in roofline.COLL_TYPES:
        assert got["_count_" + op] == want["counts"].get(op, 0), (case, op)
    assert sum(got["by_pattern"].values()) == got["total"]
