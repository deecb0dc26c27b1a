"""The port's LM models against the JAX package's.

Exact: the parameter and cache trees (key paths, shapes, dtypes, logical
axes) and ``count_params``/``active_params`` of the full configs of all
ten architectures, int8 ones included, built on ``meta`` with nothing
allocated; the MoE router's gates' order, its expert indices, the
dispatch's slots and capacity drops; int8 quantization bit for bit.

Float32 logits within atol 2e-5, rtol 1e-5 of JAX's: the cases of
``tests/test_models.py`` that the port covers, each at two sequence
lengths (one past ``attn_chunk``, so the chunked core runs, and one under
it, so the full score matrix does), with JAX's parameters carried across
by ``params_from_jax``. Each compares ``forward``, ``decode_step`` step by
step and ``loss_fn``; decode against the port's own forward stays within
the JAX package's 3e-4 (``tests/test_models.py:23``). Measured on this
suite's inputs: at most 3.3e-6 against JAX on logits up to 3.4 in
magnitude, 2.2e-6 decode against forward, 4.8e-7 on the loss.

The other families (``test_models.py``'s MoE top-2, Mamba, RWKV-6, the
jamba-style hybrid, llama4's shared expert, int8 decode) are held to the
same atol 2e-5, rtol 1e-5 on logits, loss and MoE aux, with their
zero-initialised leaves (biases, decay bases, token-shift mixes, bonus)
drawn at random so that every term counts. The port runs the Mamba and
RWKV recurrences one step at a time where the reference scans in chunks
(an associative scan inside each chunk for Mamba), so their sums fall in
another order; the bar held all the same. Measured on this suite's
inputs: at most 1.2e-5 (the hybrid, logits up to 4.2).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro.models.layers import Sharder as JSharder  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import quant as tquant  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    Sharder,
    tree_leaves_with_path,
)

ATOL, RTOL = 2e-5, 1e-5
DECODE_TOL = 3e-4
ARCHS = ("qwen2-0.5b", "qwen3-4b", "command-r-35b", "llava-next-34b",
         "musicgen-medium", "minicpm3-4b", "jamba-v0.1-52b", "rwkv6-3b",
         "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
# tests/test_arch_smoke.py::EXPECTED_B: the full configs' sizes in 1e9
EXPECTED_B = {
    "qwen2-0.5b": (0.3, 0.7),
    "command-r-35b": (25, 40),
    "minicpm3-4b": (3, 5),
    "qwen3-4b": (3, 5),
    "jamba-v0.1-52b": (45, 60),
    "rwkv6-3b": (2.5, 4),
    "llava-next-34b": (30, 40),
    "phi3.5-moe-42b-a6.6b": (38, 46),
    "llama4-maverick-400b-a17b": (350, 450),
    "musicgen-medium": (1.0, 2.2),
}

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


MOE = dict(num_experts=4, experts_per_token=2, moe_capacity_factor=8.0)
RWKV = dict(rwkv_head_dim=8, rwkv_decay_lora=8, rwkv_mix_lora=4,
            norm_type="layernorm", ssm_chunk=4)
# the other families of tests/test_models.py: (name, family, overrides,
# layer pattern as (mixer, channel) pairs)
FAMILIES = {
    "moe_top2": ("t", "moe", MOE, (("attn", "moe"),)),
    "mamba": ("t", "ssm", dict(ssm_chunk=4), (("mamba", "mlp"),)),
    "rwkv6": ("t", "ssm", RWKV, (("rwkv", "rwkv_ffn"),)),
    "jamba_style_hybrid": (
        "t", "hybrid", dict(MOE, ssm_chunk=4, num_layers=4),
        (("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp"),
         ("mamba", "moe"))),
    "llama4_style_shared_expert_top1": (
        "llama4-t", "moe", dict(MOE, experts_per_token=1),
        (("attn", "mlp"), ("attn", "moe"))),
}



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: its models are small,
    and the suite's other workers share the CPU (eight threads a worker
    spin against each other)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

def _pair(overrides: dict, mixer: str = "attn", pattern=None,
          name: str = "t"):
    """The same config in both packages."""
    kw = {"family": "dense", **BASE, **overrides}
    pattern = pattern or ((mixer, "mlp"),)
    jc = JModelConfig(name=name, layer_pattern=tuple(
        JLayerSpec(*spec) for spec in pattern), **kw)
    tc = ModelConfig(name=name, layer_pattern=tuple(
        LayerSpec(*spec) for spec in pattern), **kw)
    return jc, tc


def _family(case: str):
    name, family, overrides, pattern = FAMILIES[case]
    return _pair(dict(overrides, family=family), pattern=pattern, name=name)


def _carry(jc, tc, seed: int = 0, jitter: float = 0.0):
    """JAX's parameters and the port's copy. ``jitter`` adds seeded noise
    to every leaf first, so that leaves initialised to 0 or 1 count."""
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    if jitter:
        rng = np.random.default_rng(seed + 5)
        jp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + jitter * rng.standard_normal(
                a.shape).astype(np.asarray(a).dtype)), jp)
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


@pytest.mark.parametrize("name", ARCHS)
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


@pytest.mark.parametrize("name", ARCHS)
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


@pytest.mark.parametrize("name", ARCHS)
def test_full_config_param_count(name):
    """``tests/test_arch_smoke.py``'s twin: each full config's size lands
    in its advertised range (the count itself equals JAX's above)."""
    lo, hi = EXPECTED_B[name]
    assert lo <= TM.count_params(get_config(name)) / 1e9 <= hi


@pytest.mark.parametrize("name", ["qwen2-0.5b", "jamba-v0.1-52b"])
def test_int8_trees_match_on_meta(name):
    """``weight_quant="int8"``: int8 layer stacks, a float32 (G,) scale a
    stacked leaf, its ``('layers',)`` axes, the counts; and the smoke
    config's cache unchanged by it."""
    tc = get_config(name).scaled(weight_quant="int8")
    jc = jget_config(name).scaled(weight_quant="int8")
    got = dict(tree_leaves_with_path(TM.abstract_params(tc)))
    want = _jax_paths(JM.abstract_params(jc))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
    assert any(p[0] == "layers_scale" for p in got)
    assert (_axes_paths(TM.param_logical_axes(tc))
            == _axes_paths(JM.param_logical_axes(jc)))
    assert TM.count_params(tc) == JM.count_params(jc)
    assert TM.active_params(tc) == JM.active_params(jc)


def test_int8_weights_and_a_mesh_raise():
    """int8 weights now build and run (the tests below). A ``Sharder``
    took no mesh until the sharding slice (it raised, naming ROADMAP 6e);
    now, as the reference's, it is a no-op unless it has both a mesh and
    rules, and with both it lays activations out on the mesh
    (``tests/test_torch_sharding_dist.py``)."""
    _, tc = _pair({})
    q = tc.scaled(weight_quant="int8")
    assert "layers_scale" in TM.abstract_params(q)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    assert Sharder()(tokens, ("act_batch", None)) is tokens
    assert Sharder(mesh=object())(tokens, ("act_batch", None)) is tokens
    assert not Sharder(mesh=object()).active
    assert Sharder(mesh=object(), rules={}).active


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


# ------------------------------------------------------- the other families


def _labels(tok):
    labels = np.full_like(tok, -1)
    labels[:, :-1] = tok[:, 1:]
    labels[0, :2] = -1   # ignored positions
    return labels


@pytest.mark.parametrize("seq", [16, 6])
@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_family_forward_decode_and_loss_match_jax(case, seq):
    """``test_models.py``'s MoE, Mamba, RWKV, hybrid and llama4 cases:
    ``forward`` (logits, aux and the cache it returns), ``loss_fn`` (its
    CE and MoE aux term) against JAX at both lengths (one past
    ``ssm_chunk`` and not a multiple of it); ``decode_step`` against the
    port's own forward at both, and step by step against JAX's, with the
    caches it wrote, at 16."""
    jc, tc = _family(case)
    jp, tp = _carry(jc, tc, jitter=0.1)
    tok = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, seq)).astype(np.int32)
    labels = _labels(tok)

    def run(p, t, y):
        logits, aux, cache = JM.forward(p, jc, t, return_cache=True)
        loss, m = JM.loss_fn(p, jc, t, y)
        return logits, aux, cache, loss, m["ce"], m["aux"]

    jl, jaux, jcache, jloss, jce, jmaux = jax.jit(run)(
        jp, jnp.asarray(tok), jnp.asarray(labels))
    with torch.inference_mode():
        tl, aux, cache = TM.forward(tp, tc, torch.from_numpy(tok),
                                    return_cache=True)
        loss, m = TM.loss_fn(tp, tc, torch.from_numpy(tok),
                             torch.from_numpy(labels))
    for got, want in ((tl, jl), (aux, jaux), (loss, jloss), (m["ce"], jce),
                      (m["aux"], jmaux)):
        _close(got, want)
    has_moe = any(spec.channel == "moe" for spec in tc.layer_pattern)
    assert (float(aux) > 0) == has_moe
    got = dict(tree_leaves_with_path(cache))
    want = _jax_paths(jcache)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == torch.float32, path
        _close(got[path], leaf)

    tcache = TM.init_cache(tc, 2, seq, device="cpu")
    steps = []
    with torch.inference_mode():
        for i in range(seq):
            lg, tcache = TM.decode_step(tp, tc, tcache,
                                        torch.from_numpy(tok[:, i:i + 1]), i)
            steps.append(lg)
    assert float((torch.stack(steps, 1) - tl).abs().max()) < DECODE_TOL
    if seq != 16:
        return
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(p, jc, c, t, i))
    jcache = JM.init_cache(jc, 2, seq)
    for i in range(seq):
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(tok[:, i:i + 1]),
                              jnp.int32(i))
        _close(steps[i], jlg)
    got = dict(tree_leaves_with_path(tcache))
    for path, leaf in _jax_paths(jcache).items():
        _close(got[path], leaf)


def _group0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _tgroup0(tree):
    if isinstance(tree, dict):
        return {k: _tgroup0(v) for k, v in tree.items()}
    return None if tree is None else tree[0]


@pytest.mark.parametrize("case", ["moe_top2",
                                  "llama4_style_shared_expert_top1"])
def test_moe_route_and_dispatch_match_jax(case):
    """Every integer decision of the dispatch is the reference's: the
    router's expert indices and gates (softmax top-2 renormalised;
    llama4's sigmoid top-1), the aux loss, the capacity, each entry's
    buffer slot with the sentinel drop row, at a capacity factor that
    drops entries and at one that does not; then the whole channel, drops
    included, against JAX's dispatch path."""
    jc, tc = _family(case)
    jp, tp = _carry(jc, tc, jitter=0.1)
    layer = "p0" if case == "moe_top2" else "p1"
    jm = _group0(jp["layers"][layer]["channel"])
    tm = _tgroup0(tp["layers"][layer]["channel"])
    assert ("shared" in tm) == (case != "moe_top2")
    x = np.random.default_rng(3).standard_normal((2, 20, 32)).astype(
        np.float32)
    xt = x.reshape(40, 32)
    jg, ji, ja = jax.jit(lambda p, v: jmoe._route(p, v, jc))(
        jm, jnp.asarray(xt))
    tg, ti, ta = tmoe._route(tm, torch.from_numpy(xt), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    _close(ta, ja)
    k, e = tc.experts_per_token, tc.num_experts
    for cf, drops in ((0.25, True), (8.0, False)):
        cap = tmoe.capacity(tc.scaled(moe_capacity_factor=cf), 40)
        assert cap == max(-(-int(cf * 40 * k) // e), 8)
        _, jslot = jmoe._local_dispatch(jnp.asarray(xt), jg, ji, e, cap, 32)
        slot = tmoe.dispatch_slots(ti, e, cap)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        assert bool((slot == e * cap).any()) == drops
        jcf, tcf = (jc.scaled(moe_capacity_factor=cf),
                    tc.scaled(moe_capacity_factor=cf))
        jy, jaux = jax.jit(lambda p, v: jmoe.moe_apply_dispatch(
            p, v, jcf, JSharder()))(jm, jnp.asarray(x))
        ty, taux = tmoe.moe_apply(tm, torch.from_numpy(x), tcf, Sharder())
        _close(ty, jy)
        _close(taux, jaux)
    # moe_impl="alltoall" without a mesh is the dispatch path in both
    a2a = tc.scaled(moe_impl="alltoall")
    assert torch.equal(tmoe.moe_apply(tm, torch.from_numpy(x), a2a,
                                      Sharder())[0],
                       tmoe.moe_apply(tm, torch.from_numpy(x), tc,
                                      Sharder())[0])


def test_int8_quantize_layers_bit_for_bit():
    """``quantize_layers`` on the same float tree: int8 values and scales
    equal to JAX's, a scale of 0 for an all-zero leaf (its values divide
    by the clamped 1e-12), half-way values rounded to even; the scale
    tree's ``None`` for a leaf that cannot be quantized; and
    ``dequantize_group`` against JAX's."""
    jc, tc = _pair({"num_layers": 4})
    jp, tp = _carry(jc, tc)
    half = np.array([[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]]], np.float32)
    extra = {"zeros": np.zeros((4, 3), np.float32), "half": half,
             "flat": np.ones((4,), np.float32)}
    jlayers = dict(jp["layers"], **{k: jnp.asarray(v)
                                    for k, v in extra.items()})
    tlayers = dict(tp["layers"], **{k: torch.from_numpy(v)
                                    for k, v in extra.items()})
    jq, js = jquant.quantize_layers(jlayers)
    tq, ts = tquant.quantize_layers(tlayers)
    assert ts["flat"] is None and js["flat"] is None
    assert torch.equal(tq["flat"], tlayers["flat"])
    np.testing.assert_array_equal(tq["half"].numpy(),
                                  [[[127, 0, 2, 2, 0, -2]]])
    assert float(ts["zeros"].abs().max()) == 0.0
    for path, leaf in _jax_paths(jq).items():
        got = dict(tree_leaves_with_path(tq))[path]
        assert got.dtype == (torch.int8 if path != ("flat",)
                             else torch.float32), path
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    for path, leaf in _jax_paths(js).items():
        np.testing.assert_array_equal(
            dict(tree_leaves_with_path(ts))[path].numpy(), np.asarray(leaf))
    jd = jquant.dequantize_group(_group0(jq), _group0(js), jnp.float32)
    td = tquant.dequantize_group(_tgroup0(tq), _tgroup0(ts), torch.float32)
    got = dict(tree_leaves_with_path(td))
    for path, leaf in _jax_paths(jd).items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf))


def test_int8_weight_quant_decode():
    """``test_models.py``'s twin: decode on the int8 tree tracks the float
    tree's logits (cosine > 0.99), and equals JAX's decode on the same
    int8 tree (carried across with its scales) within the float32 bar, as
    does ``forward``, which reads the int8 values without their scale in
    both packages (ROADMAP Queue C 14)."""
    jc, tc = _pair({"num_layers": 4})
    jq, tq = jc.scaled(weight_quant="int8"), tc.scaled(weight_quant="int8")
    _, tp = _carry(jc, tc)
    jpq, tpq = _carry(jq, tq)
    assert tpq["layers"]["p0"]["mixer"]["wq"].dtype == torch.int8
    tok = np.random.default_rng(1).integers(0, 97, (2, 8)).astype(np.int32)
    c1 = TM.init_cache(tc, 2, 8, device="cpu")
    c2 = TM.init_cache(tq, 2, 8, device="cpu")
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(p, jq, c, t, i))
    jcache = JM.init_cache(jq, 2, 8)
    a, b = [], []
    with torch.inference_mode():
        for i in range(8):
            t = torch.from_numpy(tok[:, i:i + 1])
            a.append(TM.decode_step(tp, tc, c1, t, i)[0])
            b.append(TM.decode_step(tpq, tq, c2, t, i)[0])
            jlg, jcache = jdecode(jpq, jcache, jnp.asarray(tok[:, i:i + 1]),
                                  jnp.int32(i))
            _close(b[-1], jlg)
        a, b = torch.stack(a), torch.stack(b)
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        assert cos > 0.99 and bool(torch.isfinite(b).all())
        raw = TM.forward(tpq, tq, torch.from_numpy(tok))[0]
    _close(raw, jax.jit(lambda p, t: JM.forward(p, jq, t)[0])(
        jpq, jnp.asarray(tok)))
