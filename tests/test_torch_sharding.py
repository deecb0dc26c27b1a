"""The port's logical sharding against the JAX package's, exactly.

``spec_for`` reads only ``mesh.shape`` in both packages, so a stub mesh
of a ``{name: size}`` dict stands in for 256 or 512 devices. Every leaf
of ``param_logical_axes``, of the optimiser state and of
``cache_logical_axes`` of every full-size architecture resolves to the
same spec (as tuples) under the train, prefill and decode rules, with
each shape's ``rule_overrides`` and each config's
``decode_rule_overrides``, on the two production meshes, a small one and
``{model: 3}`` (which forces the divisibility fallback). Then the twins of
``tests/test_substrates.py::test_spec_*``, and the port's own additions:
DTensor ``placements``, ``tree_shardings`` and ``place`` refusing a mesh
with no devices.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.optim.adamw import abstract_opt_state as j_abstract_opt  # noqa: E402
from repro.sharding import logical as jlogical  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro_torch.models.layers import tree_leaves_with_path  # noqa: E402
from repro_torch.optim.adamw import abstract_opt_state  # noqa: E402
from repro_torch.sharding import logical  # noqa: E402

ARCHS = jconfigs.list_archs()


@dataclasses.dataclass(frozen=True)
class StubMesh:
    """What both packages' ``spec_for`` read of a mesh: its shape."""

    shape: dict


MESHES = {
    "single": StubMesh({"data": 16, "model": 16}),
    "multi": StubMesh({"pod": 2, "data": 16, "model": 16}),
    "small": StubMesh({"data": 2, "model": 4}),
    "model3": StubMesh({"model": 3}),
}


def _jax_leaves(tree):
    """(key path as a tuple of dict keys, leaf) of a JAX tree."""
    import jax

    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple) and all(
                isinstance(a, (str, type(None))) for a in x)):
        out.append((tuple(getattr(k, "key", getattr(k, "name", None))
                          for k in path), leaf))
    return out


def _rule_tables(jcfg):
    """Every rule table a cell of ``jcfg`` can take: each kind bare, and
    each shape's cell rules (its overrides and, in decode, the config's)."""
    tables = {(kind, "bare"): (kind, {}) for kind in
              ("train", "prefill", "decode")}
    for shape in jconfigs.shapes_for(jcfg):
        over = dict(jcfg.decode_rule_overrides) \
            if shape.kind == "decode" else {}
        over.update(shape.rule_overrides)
        tables[(shape.kind, shape.name)] = (shape.kind, over)
    return tables


def _assert_specs_equal(jaxes, jshapes, taxes, tshapes, jrules, trules,
                        mesh, what):
    want = dict(_jax_leaves(jaxes))
    got_axes = dict(tree_leaves_with_path(taxes))
    shapes = dict(_jax_leaves(jshapes))
    tsh = dict(tree_leaves_with_path(tshapes))
    assert set(got_axes) == set(want) == set(shapes) == set(tsh), what
    for path, axes in want.items():
        assert got_axes[path] == axes, (what, path)
        assert tuple(tsh[path].shape) == tuple(shapes[path].shape), (what,
                                                                      path)
        j = jlogical.spec_for(axes, jrules, mesh, shapes[path].shape)
        t = logical.spec_for(got_axes[path], trules, mesh,
                             tuple(tsh[path].shape))
        assert isinstance(t, logical.PartitionSpec)
        assert tuple(t) == tuple(j), (what, path, t, j)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_jax_on_every_leaf(arch, mesh_name):
    mesh = MESHES[mesh_name]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams, tparams = jmodels.abstract_params(jcfg), \
        tmodels.abstract_params(tcfg)
    jaxes, taxes = jmodels.param_logical_axes(jcfg), \
        tmodels.param_logical_axes(tcfg)
    jopt, topt = j_abstract_opt(jparams), abstract_opt_state(tparams)
    for (kind, label), (k, over) in _rule_tables(jcfg).items():
        jrules = jlogical.make_rules(k, over)
        trules = logical.make_rules(k, over)
        assert trules == jrules, (kind, label)
        what = f"{arch} {label} {mesh_name}"
        _assert_specs_equal(jaxes, jparams, taxes, tparams, jrules, trules,
                            mesh, f"{what} params")
        for moment in ("mu", "nu"):
            _assert_specs_equal(jaxes, getattr(jopt, moment), taxes,
                                getattr(topt, moment), jrules, trules, mesh,
                                f"{what} opt {moment}")
        assert tuple(logical.spec_for((), trules, mesh, ())) == tuple(
            jlogical.spec_for((), jrules, mesh, ())) == ()
        shapes = {s.name: s for s in jconfigs.shapes_for(jcfg)}
        shape = shapes.get(label)
        b, s = (shape.global_batch, shape.seq_len) if shape else (8, 64)
        _assert_specs_equal(jmodels.cache_logical_axes(jcfg, b, s),
                            jmodels.abstract_cache(jcfg, b, s),
                            tmodels.cache_logical_axes(tcfg, b, s),
                            tmodels.abstract_cache(tcfg, b, s), jrules,
                            trules, mesh, f"{what} cache")


def test_rule_tables_match_jax():
    assert logical.TRAIN_RULES == jlogical.TRAIN_RULES
    assert logical.DECODE_RULES == jlogical.DECODE_RULES
    for kind in ("train", "prefill", "decode"):
        assert logical.make_rules(kind, {"embed": "data"}) == \
            jlogical.make_rules(kind, {"embed": "data"})


# ---- twins of tests/test_substrates.py::test_spec_*

def test_spec_divisibility_fallback():
    mesh = logical.AbstractMesh((1, 1), ("data", "model"))
    rules = logical.make_rules("train")
    spec = logical.spec_for(("embed", "heads", None), rules, mesh,
                            (8, 14, 64))
    assert spec == logical.PartitionSpec("data", "model")
    # 14 heads on a 16-way model axis fall back to replication
    mesh16 = logical.AbstractMesh((1, 16), ("data", "model"))
    assert logical.spec_for(("embed", "heads", None), rules, mesh16,
                            (8, 14, 64)) == logical.PartitionSpec("data")


def test_spec_skips_missing_mesh_axes():
    mesh = logical.AbstractMesh((1, 1), ("data", "model"))
    rules = logical.make_rules("train")
    spec = logical.spec_for(("act_batch", "act_seq"), rules, mesh, (8, 16))
    # ("pod","data") rule with no pod axis -> data only
    assert spec == logical.PartitionSpec("data")


def test_spec_no_duplicate_axis():
    mesh = logical.AbstractMesh((1, 1), ("data", "model"))
    rules = {"a": "model", "b": "model"}
    spec = logical.spec_for(("a", "b"), rules, mesh, (4, 4))
    assert spec == logical.PartitionSpec("model")


# ---- the port's own: placements, tree shardings, place


@dataclasses.dataclass(frozen=True)
class NamesMesh:
    """What ``placements`` reads of a DeviceMesh: its dimension names and
    sizes."""

    mesh_dim_names: tuple
    shape: tuple


def test_placements_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    mesh = NamesMesh(("pod", "data", "model"), (2, 4, 2))
    P = logical.PartitionSpec
    assert logical.placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert logical.placements(P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert logical.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        logical.placements(P(("data", "pod")), mesh)
    # a size-1 mesh dimension splits nothing
    one = NamesMesh(("data", "model"), (1, 4))
    assert logical.placements(P("data", "model"), one) == (
        Replicate(), Shard(1))
    assert logical.placements(P("data", "model"), NamesMesh(
        ("data", "model"), (1, 1))) == (Replicate(), Replicate())


def test_tree_and_param_shardings_and_abstract_place():
    cfg = tconfigs.get_config("qwen2-0.5b")
    mesh = logical.AbstractMesh((16, 16), ("data", "model"))
    rules = logical.make_rules("train")
    shd = logical.param_shardings(cfg, rules, mesh)
    axes = dict(tree_leaves_with_path(tmodels.param_logical_axes(cfg)))
    shapes = dict(tree_leaves_with_path(tmodels.abstract_params(cfg)))
    got = dict(tree_leaves_with_path(shd))
    assert set(got) == set(axes)
    for path, ns in got.items():
        assert ns.mesh is mesh
        assert ns.spec == logical.spec_for(axes[path], rules, mesh,
                                           shapes[path].shape)
    assert got[("embed",)].spec == logical.PartitionSpec("model", "data")
    with pytest.raises(TypeError, match="AbstractMesh"):
        logical.place(tmodels.abstract_params(cfg), shd)


def test_production_mesh_abstract_and_without_a_process_group():
    from repro_torch.launch import mesh as lmesh

    single = lmesh.make_production_mesh(abstract=True)
    multi = lmesh.make_production_mesh(multi_pod=True, abstract=True)
    assert (single.axis_sizes, single.axis_names, single.size) == (
        (16, 16), ("data", "model"), 256)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    with pytest.raises(ValueError):
        logical.AbstractMesh((2, 2), ("data",))
