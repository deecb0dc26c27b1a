"""The port's meshed LM paths in four gloo processes on the CPU.

The processes are ``chip_smoke.py``'s gloo rehearsal (``gloo_rank``),
which the script runs on the card's host too: ``torch.multiprocessing``
spawn inside one subprocess with a timeout, ``init_method=file://`` under
a temporary directory so that test workers never share a port, one torch
thread each, a (2, 2) ("data", "model") ``DeviceMesh`` and small float32
configs. Here its inputs come from the JAX package, and what it measured
is held:

  * the meshed forward of a dense and an MLA model from JAX-initialised
    parameters (``models.convert.params_from_jax``), placed by the train
    rules, against the JAX package's unmeshed ``forward`` (the reference's
    own meshed run fails on jax 0.9, ROADMAP Queue C 2), within the
    float32 bar (atol 2e-5, rtol 1e-5);
  * the twin of ``tests/test_moe_alltoall.py``: ``moe_impl="alltoall"``
    against dispatch under the same mesh within 1e-3, the all-to-all path
    taken, a finite, positive gradient norm through it, and its
    cross-entropy's gradient against dispatch's leaf by leaf within 1e-5
    of the leaf's norm (the aux loss is each token slice's mean, as the
    reference's is, not dispatch's over all the tokens); on a
    (4, 1) mesh (``model`` = 1) and on a local token count that does not
    divide by ``model`` the path is dispatch, as in the reference;
  * a meshed train step against the unmeshed one, parameters within half
    the step's lr; the same meshed step at ``remat="full"`` equal to the
    "none" step bit for bit, and the all-to-all path's gradient at "dots"
    and "full" equal to its "none" gradient bit for bit;
  * ``ServeEngine(mesh=...)`` greedy tokens equal to the unmeshed
    engine's, dense and MLA;
  * a checkpoint saved by the JAX package restored with ``shardings=`` on
    a (4, 1) mesh and on (2, 2): equal full tensors and the placements
    asked for; and one saved by the port under (2, 2) restored under
    (4, 1);
  * the collectives each step issued (``chip_smoke.collective_log``)
    against ``launch.dryrun.reckon_collectives`` on the same mesh: equal
    op counts and ring bytes by kind for decode (dense, MLA, MoE on both
    paths) and for the train cell's forward (dense, MoE all-to-all); the
    whole train step moves at least the reckoned bytes (DTensor's
    backward moves more than the reckoning's, ROADMAP Queue C); at
    ``remat="full"`` the backward's recompute issues the groups' forward
    collectives again, which the reckoning does not count (Queue C 20).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.sharding import AbstractMesh, make_rules  # noqa: E402

CONFIGS = cs.GLOO_MODELS


def _jax_config(name, kw, mixer):
    return JModelConfig(name=name, layer_pattern=(JLayerSpec(mixer, "mlp"),),
                        **{**cs.GLOO_BASE, **kw})


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """JAX's parameters and checkpoint, then the four processes, with
    JAX's reference forwards computed while they run."""
    out_dir = str(tmp_path_factory.mktemp("mesh"))
    jax_models = {}
    for label, (kw, mixer) in CONFIGS.items():
        jcfg = _jax_config("t", kw, mixer)
        jax_models[label] = (jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    inputs = cs.gloo_write_inputs(
        np, out_dir, {label: jax.tree_util.tree_map(np.asarray, p)
                      for label, (_, p) in jax_models.items()},
        lambda path: JCheckpointer(path).save(1, jax_models["dense"][1]))
    proc = cs.gloo_start(out_dir)
    try:
        want = {label: np.asarray(jax.jit(
            lambda p, t, c=jcfg: JM.forward(p, c, t)[0])(
                jparams, jnp.asarray(inputs["tokens"])))
            for label, (jcfg, jparams) in jax_models.items()}
    finally:
        got = cs.gloo_results(proc, out_dir, 240)
    return got, want, jax.tree_util.tree_map(np.asarray,
                                             jax_models["dense"][1])


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_meshed_forward_matches_jax_unmeshed(dist_run, label):
    got, want, _ = dist_run
    assert got["mesh"] == (2, 2)
    np.testing.assert_allclose(got["forward"][label], want[label],
                               atol=2e-5, rtol=1e-5)


def test_alltoall_matches_dispatch(dist_run):
    got, _, _ = dist_run
    assert got["a2a_calls"] == 2           # one a MoE layer, two layers
    assert got["a2a_err"] < 1e-3, got["a2a_err"]
    gn = got["a2a_grad_norm_sq"]
    assert np.isfinite(gn) and gn > 0


def test_alltoall_gradient_matches_dispatch(dist_run):
    got, _, _ = dist_run
    rel = got["a2a_grad_rel"]
    assert any("w_gate" in k for k in rel) and any("router" in k for k in rel)
    assert max(rel.values()) <= 1e-5, rel


def test_alltoall_only_where_the_reference_takes_it(dist_run):
    got, _, _ = dist_run
    assert got["applies"] == {"2x2": True, "4x1": False, "odd": False,
                              "dispatch": False}
    assert got["mesh41"] == (4, 1)
    assert got["model1_calls"] == got["odd_calls"] == 0
    assert got["model1_err"] < 1e-3 and got["odd_err"] < 1e-3


def test_meshed_train_step_matches_unmeshed(dist_run):
    t = dist_run[0]["train"]["dense"]
    assert t["step"] == 1 and t["moments_placed"] and t["params_placed"]
    assert t["param_max_abs"] <= 0.5 * t["lr"], t
    assert t["loss"][1] == pytest.approx(t["loss"][0], rel=1e-5)
    assert t["grad_norm"][1] == pytest.approx(t["grad_norm"][0], rel=1e-5)


def test_meshed_serve_engine_greedy_tokens_equal(dist_run):
    want, tokens = dist_run[0]["serve"]["dense"]
    assert tokens.shape == (4, 8)
    np.testing.assert_array_equal(tokens, want)


def test_meshed_mla_serve_engine_greedy_tokens_equal(dist_run):
    want, tokens = dist_run[0]["serve"]["mla"]
    assert tokens.shape == (4, 8)
    np.testing.assert_array_equal(tokens, want)


@pytest.mark.parametrize("name", ["4x1", "2x2", "port 2x2 -> 4x1"])
def test_checkpoint_restores_onto_a_mesh(dist_run, name):
    got, _, ckpt = dist_run
    leaves = dict(jax.tree_util.tree_leaves_with_path(ckpt))
    want = {"/".join(k.key for k in path): v for path, v in leaves.items()}
    restored = got["ckpt"][name]
    assert set(restored) == set(want)
    for path, (full, placed, on_mesh) in restored.items():
        np.testing.assert_array_equal(full, want[path])
        assert placed and on_mesh, path


def _reckoned(step, label):
    cfg = cs.gloo_model_config(label)
    kind = "decode" if step == "decode" else "train"
    shape = ShapeConfig("t", kind, cs.GLOO_SEQ, cs.GLOO_BATCH)
    rules = make_rules(kind, cfg.decode_rule_overrides
                       if kind == "decode" else None)
    return dryrun.reckon_collectives(cfg, shape, AbstractMesh(
        (2, 2), ("data", "model")), rules)


@pytest.mark.parametrize("case", [c for c in cs.GLOO_COLLECTIVE_CASES
                                  if c[0] != "train"],
                         ids="-".join)
def test_collectives_match_the_reckoning(dist_run, case):
    measured = dist_run[0]["collectives"][case]["all"]
    want = _reckoned(*case)["forward"]
    kinds = {k for k, n in want["counts"].items() if n}
    assert set(measured["counts"]) == kinds, (measured, want)
    for k in kinds:
        assert measured["counts"][k] == want["counts"][k], (k, measured, want)
        assert measured["bytes"][k] == pytest.approx(want["bytes"][k],
                                                     rel=1e-12), k


@pytest.mark.parametrize("label", ["dense", "moe"])
def test_train_step_moves_at_least_the_reckoned_bytes(dist_run, label):
    measured = dist_run[0]["collectives"]["train", label]["all"]
    want = _reckoned("train", label)
    assert sum(measured["bytes"].values()) >= want["total"], (measured,
                                                              want)
    # the forward's part is reckoned exactly (test_collectives_match_the_
    # reckoning); the step adds at least the reckoned backward
    fwd = dist_run[0]["collectives"]["forward", label]["all"]
    assert sum(measured["bytes"].values()) - sum(fwd["bytes"].values()) \
        >= want["total"] - sum(want["forward"]["bytes"].values())


def test_meshed_train_step_at_full_remat_equals_none(dist_run):
    """The dense model's meshed train step at ``remat="full"``: each group's
    body checkpointed around its ``on_shards`` and DTensor redistributes;
    the parameters, loss and gradient norm equal the ``"none"`` step's bit
    for bit."""
    r = dist_run[0]["remat_full"]
    assert r["params_equal"] and r["metrics_equal"], r


def test_full_remat_reissues_the_group_collectives(dist_run):
    """What the ``"full"`` step logs against the ``"none"`` step and the
    reckoning: the forward issues the same collectives; the backward's
    recompute issues a group's forward collectives again, so the step
    moves more than the ``"none"`` step, by at most the forward's bytes
    (the embedding lookup and the cross-entropy are not recomputed). The
    reckoning (``dryrun.reckon_collectives``) counts no recompute
    (ROADMAP Queue C)."""
    got = dist_run[0]
    full = got["remat_full"]["collectives"]
    none = got["collectives"]["train", "dense"]
    fwd = got["collectives"]["forward", "dense"]["all"]
    assert full["forward"] == none["forward"]
    extra = {k: full["all"]["bytes"][k] - none["all"]["bytes"].get(k, 0.0)
             for k in full["all"]["bytes"]}
    assert sum(extra.values()) > 0, (full, none)
    for k, b in extra.items():
        assert 0 <= b <= fwd["bytes"].get(k, 0.0), (k, extra, fwd)
    reckoned = _reckoned("train", "dense")
    assert sum(full["all"]["bytes"].values()) >= reckoned["total"]


def test_alltoall_gradient_bit_for_bit_across_remat(dist_run):
    """The MoE all-to-all path's cross-entropy gradient under the mesh at
    ``remat`` "dots" and "full" equals the "none" one bit for bit: the
    recompute redoes the routing and both exchanges."""
    assert dist_run[0]["a2a_remat_equal"] == {"dots": True, "full": True}
