"""The port's LM models against the JAX package's.

Exact: the parameter and cache trees (key paths, shapes, dtypes, logical
axes) and ``count_params``/``active_params`` of the full configs, built on
``meta`` with nothing allocated; the ``NotImplementedError`` of every
family not ported yet (ROADMAP 6b).

Float32 logits within atol 2e-5, rtol 1e-5 of JAX's: the cases of
``tests/test_models.py`` that the port covers, each at two sequence
lengths (one past ``attn_chunk``, so the chunked core runs, and one under
it, so the full score matrix does), with JAX's parameters carried across
by ``params_from_jax``. Each compares ``forward``, ``decode_step`` step by
step and ``loss_fn``; decode against the port's own forward stays within
the JAX package's 3e-4 (``tests/test_models.py:23``). Measured on this
suite's inputs: at most 3.3e-6 against JAX on logits up to 3.4 in
magnitude, 2.2e-6 decode against forward, 4.8e-7 on the loss.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    Sharder,
    tree_leaves_with_path,
)

ATOL, RTOL = 2e-5, 1e-5
DECODE_TOL = 3e-4
PORTED = ("qwen2-0.5b", "qwen3-4b", "command-r-35b", "llava-next-34b",
          "musicgen-medium", "minicpm3-4b")
NOT_PORTED = ("jamba-v0.1-52b", "rwkv6-3b", "phi3.5-moe-42b-a6.6b",
              "llama4-maverick-400b-a17b")

BASE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
            vocab_size=97, activation_dtype="float32", param_dtype="float32",
            remat="none", attn_chunk=8)
MLA = dict(q_lora_rank=16, kv_lora_rank=8, qk_rope_dim=4, qk_nope_dim=8,
           v_head_dim=8)
# the cases of tests/test_models.py the port covers: (config overrides,
# pattern of mixers, frontend prefix length)
CASES = {
    "gqa_bias_qknorm_tied": (dict(family="dense", qkv_bias=True,
                                  qk_norm=True, tie_embeddings=True),
                             "attn", 0),
    "chunked_attention_path": (dict(family="dense", attn_chunk=4), "attn", 0),
    "mla": (dict(family="dense", **MLA), "mla", 0),
    "parallel_block_layernorm_sinusoidal": (
        dict(family="dense", parallel_block=True, norm_type="layernorm",
             mlp_act="gelu", pos_embed="sinusoidal", num_kv_heads=4),
        "attn", 0),
    "frontend_embeds_prefix": (dict(family="vlm", frontend="vision",
                                    frontend_tokens=4), "attn", 4),
    "scan_vs_unrolled_identical": (dict(family="dense", num_layers=4),
                                   "attn", 0),
}


def _pair(overrides: dict, mixer: str = "attn"):
    """The same config in both packages."""
    kw = {"family": "dense", **BASE, **overrides}
    jc = JModelConfig(name="t", layer_pattern=(JLayerSpec(mixer, "mlp"),),
                      **kw)
    tc = ModelConfig(name="t", layer_pattern=(LayerSpec(mixer, "mlp"),), **kw)
    return jc, tc


def _carry(jc, tc, seed: int = 0):
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                               "cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _jax_paths(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[tuple(k.key for k in path)] = leaf
    return out


def _axes_paths(tree):
    """Logical-axes trees hold tuples as leaves: walk dicts only."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif t is not None:
            out[path] = tuple(t)

    walk(tree, ())
    return out


# ------------------------------------------------------------------ trees


@pytest.mark.parametrize("name", PORTED)
def test_param_tree_and_counts_match_on_meta(name):
    tc, jc = get_config(name), jget_config(name)
    got = dict(tree_leaves_with_path(TM.abstract_params(tc)))
    want = _jax_paths(JM.abstract_params(jc))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
    assert (_axes_paths(TM.param_logical_axes(tc))
            == _axes_paths(JM.param_logical_axes(jc)))
    assert TM.count_params(tc) == JM.count_params(jc)
    assert TM.active_params(tc) == JM.active_params(jc)
    if name == "qwen2-0.5b":
        assert TM.count_params(tc) == 494_032_768


@pytest.mark.parametrize("name", PORTED)
def test_cache_tree_matches(name):
    tc, jc = get_config(name), jget_config(name)
    got = dict(tree_leaves_with_path(TM.abstract_cache(tc, 2, 16)))
    want = _jax_paths(JM.abstract_cache(jc, 2, 16))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
    assert (_axes_paths(TM.cache_logical_axes(tc))
            == _axes_paths(JM.cache_logical_axes(jc)))
    small = TM.init_cache(smoke_config(name), 2, 8, device="cpu")
    for path, leaf in tree_leaves_with_path(small):
        assert leaf.device.type == "cpu" and not leaf.any(), path


@pytest.mark.parametrize("name", NOT_PORTED)
def test_families_not_ported_raise(name):
    """Mamba, RWKV and MoE raise wherever they would be built or run; a
    MoE model's cache (attention k/v only) is the reference's all the
    same."""
    cfg = smoke_config(name)
    for fn in (TM.abstract_params, TM.param_logical_axes,
               lambda c: TM.init_params(c, torch.Generator("cpu"))):
        with pytest.raises(NotImplementedError, match="ROADMAP 6b"):
            fn(cfg)
    if cfg.is_attention_free or cfg.family == "hybrid":
        with pytest.raises(NotImplementedError, match="ROADMAP 6b"):
            TM.init_cache(cfg, 1, 4, device="cpu")
        return
    got = dict(tree_leaves_with_path(TM.init_cache(cfg, 1, 4, device="cpu")))
    want = _jax_paths(JM.init_cache(jarchs.smoke_config(name), 1, 4))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path


def test_int8_weights_and_a_mesh_raise():
    _, tc = _pair({})
    q = tc.scaled(weight_quant="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP 6b"):
        TM.abstract_params(q)
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for fn in (lambda: TM.forward(params, q, tokens),
               lambda: TM.decode_step(params, q, None, tokens[:, :1], 0)):
        with pytest.raises(NotImplementedError, match="ROADMAP 6b"):
            fn()
    with pytest.raises(NotImplementedError, match="ROADMAP 6e"):
        Sharder(mesh=object(), rules={})
    assert Sharder()(tokens, ("act_batch", None)) is tokens


def test_init_params_fan_in_counts_the_group_axis():
    """The reference's fan-in is the product of all dims but the last, the
    stacked leading ``num_groups`` axis included; the port keeps it, so
    its init scales match JAX's (statistically: the draws differ)."""
    jc, tc = _pair({"num_layers": 4})
    gen = torch.Generator("cpu").manual_seed(0)
    got = TM.init_params(tc, gen)
    want = JM.init_params(jc, jax.random.PRNGKey(0))
    wq = got["layers"]["p0"]["mixer"]["wq"]            # (G=4, 32, 4, 8)
    fan_in = 4 * 32 * 4
    assert abs(float(wq.std()) * math.sqrt(fan_in) - 1) < 0.05
    assert abs(float(np.asarray(
        want["layers"]["p0"]["mixer"]["wq"]).std()) * math.sqrt(fan_in)
        - 1) < 0.05
    assert abs(float(got["embed"].std()) / 0.02 - 1) < 0.1
    assert wq.device.type == "cpu" and wq.dtype == torch.float32
    for path, leaf in tree_leaves_with_path(got):
        if path[-1] in ("scale", "q_norm", "k_norm"):
            assert bool((leaf == 1).all()), path
    again = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    assert torch.equal(again["embed"], got["embed"])


def test_params_from_jax_checks_every_leaf():
    jc, tc = _pair({})
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init_params(jc, jax.random.PRNGKey(0)))
    bad_shape = dict(tree, embed=np.zeros((3, 32), np.float32))
    bad_dtype = dict(tree, embed=tree["embed"].astype(np.float64))
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    for bad in (bad_shape, bad_dtype, missing):
        with pytest.raises(ValueError):
            params_from_jax(bad, tc, "cpu")
    # a bfloat16 config: the reference's concrete init leaves its fan-in
    # weights float32 (ROADMAP Queue C 9), which the check refuses; cast to
    # the abstract tree's dtypes, the bits carry across exactly
    bf16 = tc.scaled(param_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32"):
        params_from_jax(tree, bf16, "cpu")
    cast = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)
    got = params_from_jax(cast, bf16, "cpu")
    for path, leaf in _jax_paths(cast).items():
        t = got
        for k in path:
            t = t[k]
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      leaf.view(np.int16))


# ---------------------------------------------------------------- numerics


def _jax_forward_and_loss(jc, jp, tok, labels, fe):
    """JAX's logits and loss in one compiled call (its eager forward
    compiles its layer scan on every call)."""
    def run(p, t, y, f):
        logits = JM.forward(p, jc, t, frontend_embeds=f)[0]
        loss, m = JM.loss_fn(p, jc, t, y, frontend_embeds=f)
        return logits, loss, m["ce"], m["ntokens"]

    return jax.jit(run)(jp, jnp.asarray(tok), jnp.asarray(labels),
                        None if fe is None else jnp.asarray(fe))


@pytest.mark.parametrize("seq", [16, 6])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_decode_and_loss_match_jax(case, seq):
    """``forward`` and ``loss_fn`` against JAX at both lengths;
    ``decode_step`` step by step against JAX's (and the caches it wrote)
    at the chunked length, and against the port's own forward at both."""
    overrides, mixer, prefix = CASES[case]
    jc, tc = _pair(overrides, mixer)
    jp, tp = _carry(jc, tc)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, jc.vocab_size, (2, seq)).astype(np.int32)
    labels = np.full_like(tok, -1)
    labels[:, :-1] = tok[:, 1:]
    labels[0, :2] = -1   # ignored positions
    fe = (rng.standard_normal((2, prefix, jc.d_model)).astype(np.float32)
          if prefix else None)
    tfe = None if fe is None else torch.from_numpy(fe)
    jl, jloss, jce, jn = _jax_forward_and_loss(jc, jp, tok, labels, fe)
    with torch.inference_mode():
        tl, aux, _ = TM.forward(tp, tc, torch.from_numpy(tok),
                                frontend_embeds=tfe)
        loss, m = TM.loss_fn(tp, tc, torch.from_numpy(tok),
                             torch.from_numpy(labels), frontend_embeds=tfe)
        plain = (tl if fe is None
                 else TM.forward(tp, tc, torch.from_numpy(tok))[0])
    _close(tl, jl)
    _close(loss, jloss)
    _close(m["ce"], jce)
    assert float(aux) == 0.0 and float(m["aux"]) == 0.0
    assert int(m["ntokens"]) == int(jn) and m["ntokens"].dtype == torch.int32
    if fe is not None:
        # the prefix replaces the first positions: the logits move
        assert bool((plain - tl).abs().max() > 1e-6)

    cache = TM.init_cache(tc, 2, seq, device="cpu")
    steps = []
    with torch.inference_mode():
        for i in range(seq):
            lg, cache = TM.decode_step(tp, tc, cache,
                                       torch.from_numpy(tok[:, i:i + 1]), i)
            steps.append(lg)
    assert float((torch.stack(steps, 1) - plain).abs().max()) < DECODE_TOL
    if seq != 16:
        return
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(p, jc, c, t, i))
    jcache = JM.init_cache(jc, 2, seq)
    for i in range(seq):
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(tok[:, i:i + 1]),
                              jnp.int32(i))
        _close(steps[i], jlg)
    got = dict(tree_leaves_with_path(cache))
    for path, leaf in _jax_paths(jcache).items():
        _close(got[path], leaf)


def test_scan_and_unrolled_are_one_loop():
    """``scan_layers`` is a field only: both settings give the same bits,
    and both match JAX's scanned and unrolled forwards."""
    jc, tc = _pair(CASES["scan_vs_unrolled_identical"][0])
    jp, tp = _carry(jc, tc)
    tok = np.random.default_rng(1).integers(0, 97, (2, 16)).astype(np.int32)
    with torch.inference_mode():
        a = TM.forward(tp, tc, torch.from_numpy(tok))[0]
        b = TM.forward(tp, tc.scaled(scan_layers=False),
                       torch.from_numpy(tok))[0]
    assert torch.equal(a, b)
    _close(a, JM.forward(jp, jc.scaled(scan_layers=False),
                         jnp.asarray(tok))[0])


def test_forward_cache_matches_jax():
    """``return_cache``: the stacked per-group k/v (and MLA's ckv/k_rope)
    that prefill hands the serving engine."""
    for mixer, extra in (("attn", {}), ("mla", MLA)):
        jc, tc = _pair(extra, mixer)
        jp, tp = _carry(jc, tc)
        tok = np.random.default_rng(2).integers(0, 97, (2, 16)).astype(
            np.int32)
        _, _, jcache = JM.forward(jp, jc, jnp.asarray(tok), return_cache=True)
        with torch.inference_mode():
            _, _, cache = TM.forward(tp, tc, torch.from_numpy(tok),
                                     return_cache=True)
        want = _jax_paths(jcache)
        got = dict(tree_leaves_with_path(cache))
        assert sorted(got) == sorted(want)
        for path, leaf in want.items():
            _close(got[path], leaf)


def test_decode_position_outside_the_cache_raises():
    _, tc = _pair({})
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    cache = TM.init_cache(tc, 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for bad in (4, -1):
        with pytest.raises(IndexError):
            TM.decode_step(params, tc, cache, tok, bad)
    TM.decode_step(params, tc, cache, tok, 3)
