"""Activation rematerialization in the port's training path, against the
JAX package's and against itself.

``cfg.remat`` ("none", "dots", "full") checkpoints each layer group's body
where autograd records, and ``cfg.ssm_chunk`` checkpoints the Mamba and
RWKV recurrences a chunk of steps at a time, as the reference does with
``jax.checkpoint``. Held here:

  * the twin of ``tests/test_models.py::test_remat_matches_no_remat``:
    the port's gradients at ``remat="full"`` against JAX's at "full",
    from the same parameters (``models.convert.params_from_jax``): the
    loss and the gradient's global norm within
    ``tests/test_torch_train.py``'s rtol 1e-5, and every leaf of the
    dense model within the JAX test's atol 1e-5 (measured at most 1.9e-6,
    the embedding). The Mamba and RWKV models' leaves are held within 1e-4
    of each leaf's largest magnitude: their recurrences sum in another
    order (ROADMAP Queue C 15), the same bits at "none". Measured at most
    1.8e-6 (Mamba) and 4.7e-5 (RWKV's embedding, 8.7e-4 of 18.4; its
    gradient norm within 9.3e-6);
  * the port's gradients and one train step bit for bit (``torch.equal``)
    across the three ``remat`` values on the dense, MLA, MoE, jamba-smoke
    and rwkv-smoke configs;
  * the chunked scans at ``ssm_chunk`` 1, 3, 4, S and S + 5 (S = 10):
    outputs and gradients bit for bit those of the step-by-step loop the
    port ran before the chunks (kept here as ``_stepwise_*``), and within
    ROADMAP Queue C 15's float32 bar (atol 2e-5, rtol 1e-5) of the
    reference's ``selective_scan`` / ``_time_mix_scan`` at the same chunk,
    gradients included;
  * what a forward keeps for the backward, counted with
    ``torch.autograd.graph.saved_tensors_hooks`` (each storage once, the
    parameters left out; a checkpoint's tensor arguments are packed
    through the hooks, a selective checkpoint's saved outputs are read
    from its policy): a chunked scan keeps one state a chunk, "full" one
    group input carry a group, "dots" the projections' outputs and none
    of attention's or the experts' batched products;
  * no checkpoint where autograd records nothing: prefill, decode and
    ``ServeEngine`` at "full" run none.

The meshed train step at "full" is in ``tests/test_torch_sharding_dist.py``
(the gloo rehearsal).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.utils.checkpoint as ckpt  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.models import rwkv, ssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    tree_leaves_with_path,
    tree_map,
)
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

REMATS = ("none", "dots", "full")
LOSS_RTOL = GNORM_RTOL = 1e-5               # tests/test_torch_train.py's
GRAD_ATOL = 1e-5                             # tests/test_models.py's
RECURRENT_GRAD_REL = 1e-4                    # of a leaf's largest magnitude
SCAN_ATOL, SCAN_RTOL = 2e-5, 1e-5           # ROADMAP Queue C 15's

# tests/test_models.py::BASE
BASE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
            vocab_size=97, activation_dtype="float32", param_dtype="float32",
            remat="none", attn_chunk=8)
MLA = dict(q_lora_rank=16, kv_lora_rank=8, qk_rope_dim=4, qk_nope_dim=8,
           v_head_dim=8)
MOE = dict(num_experts=4, experts_per_token=2, moe_capacity_factor=1.0)
# label -> (config overrides, layer pattern as (mixer, channel) pairs), or
# the name of an architecture whose smoke config is taken
MODELS = {
    "dense": (dict(family="dense"), (("attn", "mlp"),)),
    "mla": (dict(family="dense", **MLA), (("mla", "mlp"),)),
    # capacity 1.0: the recompute redoes the top-k and the drops
    "moe-dispatch": (dict(family="moe", **MOE), (("attn", "moe"),)),
    "moe-alltoall": (dict(family="moe", moe_impl="alltoall", **MOE),
                     (("attn", "moe"),)),
    "jamba-smoke": "jamba-v0.1-52b",
    "rwkv-smoke": "rwkv6-3b",
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: its models are small,
    and the suite's other workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms`` for a bit-for-bit test, as on
    the card: with several threads the CPU's ``index_put`` with
    accumulation (the embedding lookup's backward) adds rows in thread
    order, so two runs of the same step may differ in the last bit
    whatever the remat."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _config(label: str, **overrides) -> ModelConfig:
    entry = MODELS[label]
    if isinstance(entry, str):
        return smoke_config(entry).scaled(**overrides)
    kw, pattern = entry
    return ModelConfig(name="t", layer_pattern=tuple(
        LayerSpec(*p) for p in pattern), **{**BASE, **kw, **overrides})


def _tokens(cfg, b: int = 2, s: int = 17, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))


def _live(params):
    """Leaves detached and requiring grad, as ``train.step`` makes them."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_leaves_with_path(params)]
    it = iter(leaves)
    return leaves, tree_map(lambda _: next(it), params)


def _grads(cfg, params, tokens):
    leaves, live = _live(params)
    loss, _ = TM.loss_fn(live, cfg, tokens[:, :-1], tokens[:, 1:])
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              allow_unused=True)


# ---------------------------------------------------------------- the twin


# the twin's models: tests/test_models.py's dense BASE, and its Mamba and
# RWKV-6 cases (tests/test_torch_models.py::FAMILIES) at the same widths
TWINS = {
    "dense": ({}, (("attn", "mlp"),)),
    "mamba": (dict(family="ssm", ssm_chunk=4), (("mamba", "mlp"),)),
    "rwkv6": (dict(family="ssm", rwkv_head_dim=8, rwkv_decay_lora=8,
                   rwkv_mix_lora=4, norm_type="layernorm", ssm_chunk=4),
              (("rwkv", "rwkv_ffn"),)),
}


def _jax_pair(label: str, **overrides):
    """The same config in both packages."""
    kw, pattern = TWINS[label]
    kw = {"family": "dense", **BASE, **kw, **overrides}
    return (JModelConfig(name="t", layer_pattern=tuple(
                JLayerSpec(*p) for p in pattern), **kw),
            ModelConfig(name="t", layer_pattern=tuple(
                LayerSpec(*p) for p in pattern), **kw))


@pytest.mark.parametrize("label", sorted(TWINS))
def test_remat_full_gradients_match_jax(label):
    """``test_models.py::test_remat_matches_no_remat``'s twin: JAX's
    gradients at ``remat="full"`` against the port's at "full", from JAX's
    parameters, on the dense model of that test and on a Mamba and an
    RWKV-6 model of its widths (their chunk checkpoints nested in the
    group's; S = 15 tokens, not a multiple of the chunk)."""
    jc, tc = _jax_pair(label, remat="full")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    tok = _tokens(tc, s=16)
    jt = jnp.asarray(tok.numpy())
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jc, jt[:, :-1], jt[:, 1:])[0]))(jp)
    loss, grads = _grads(tc, tp, tok)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    got = {path: g.numpy() for (path, _), g in zip(tree_leaves_with_path(tp),
                                                   grads)}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(
        math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                      for g in got.values())),
        math.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                      for w in want.values())), rtol=GNORM_RTOL)
    for path, g in got.items():
        bound = (GRAD_ATOL if label == "dense" else
                 RECURRENT_GRAD_REL * float(np.abs(want[path]).max()))
        np.testing.assert_allclose(g, want[path], atol=bound, rtol=0,
                                   err_msg="/".join(path))


# ------------------------------------------------------- across the remats


@pytest.mark.parametrize("label", sorted(MODELS))
def test_remat_gradients_and_train_step_bit_for_bit(deterministic, label):
    """Gradients of ``loss_fn`` and one ``make_train_step`` (AdamW at the
    schedule's peak) equal bit for bit at "none", "dots" and "full": the
    checkpoints change what the backward keeps, never what it computes."""
    cfg = _config(label)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    tok = _tokens(cfg)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    runs = {}
    for remat in REMATS:
        c = cfg.scaled(remat=remat)
        loss, grads = _grads(c, params, tok)
        p, o, m = make_train_step(c, warmup_steps=0)(
            params, adamw_init(params), batch)
        runs[remat] = (loss, grads, p, o, m)
    loss, grads, p, o, m = runs["none"]
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)
    for remat in ("dots", "full"):
        loss2, grads2, p2, o2, m2 = runs[remat]
        assert torch.equal(loss, loss2), remat
        for (path, _), g, g2 in zip(tree_leaves_with_path(params), grads,
                                    grads2):
            assert (g is None and g2 is None) or torch.equal(g, g2), (
                remat, path)
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert torch.equal(m[k], m2[k]), (remat, k)
        for tree, tree2 in ((p, p2), (o.mu, o2.mu), (o.nu, o2.nu)):
            for (path, t), (_, t2) in zip(tree_leaves_with_path(tree),
                                          tree_leaves_with_path(tree2)):
                assert torch.equal(t, t2), (remat, path)


def test_unknown_remat_raises():
    cfg = _config("dense", remat="partial")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        TM.forward(params, cfg, _tokens(cfg))


# ------------------------------------------------------------ the scans


def _stepwise_selective_scan(dt, B, C, xg, A, h0):
    """The port's scan before the chunk checkpoints: one step at a time
    over the whole sequence."""
    b_, s, di = xg.shape
    h = h0
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t, :, None] * A)
        bx = (dt[:, t] * xg[:, t])[..., None] * B[:, t, None, :]
        h = a * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else xg.new_zeros((b_, 0, di), dtype=torch.float32))
    return y, h


def _stepwise_time_mix_scan(r, k, v, w, u, s0):
    """The port's RWKV scan before the chunk checkpoints."""
    st = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 st + u[..., None] * kv))
        st = w[:, t, :, :, None] * st + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return out, st


SCAN_B, SCAN_S, SCAN_DI, SCAN_N = 2, 10, 6, 4
SCAN_H, SCAN_K = 3, 4
CHUNKS = (1, 3, 4, SCAN_S, SCAN_S + 5)


def _scan_inputs(family: str, seed: int = 0) -> list:
    """float32 inputs of a scan, as the mixers make them: Mamba's dt > 0,
    B, C, xg and A < 0, the state h0; RWKV's r, k, v, decays w in (0, 1),
    the bonus u and the state s0."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    b, s = SCAN_B, SCAN_S
    if family == "mamba":
        return [np.log1p(np.exp(n(b, s, SCAN_DI))), n(b, s, SCAN_N),
                n(b, s, SCAN_N), n(b, s, SCAN_DI),
                -np.exp(n(SCAN_DI, SCAN_N, scale=0.5)),
                n(b, SCAN_DI, SCAN_N)]
    h, k = SCAN_H, SCAN_K
    return [n(b, s, h, k), n(b, s, h, k, scale=0.5), n(b, s, h, k),
            np.exp(-np.exp(n(b, s, h, k, scale=0.5))).astype(np.float32),
            n(h, k, scale=0.5), n(b, h, k, k)]


def _port_scan(family: str, chunk):
    """The port's scan at ``chunk`` (None: the step-by-step copy), as
    f(*inputs) -> (output, last state)."""
    if family == "mamba":
        if chunk is None:
            return _stepwise_selective_scan
        return lambda dt, B, C, xg, A, h0: ssm.selective_scan(
            dt, B, C, xg, A, chunk, h0)
    if chunk is None:
        return _stepwise_time_mix_scan
    return lambda *a: rwkv._time_mix_scan(*a, chunk)


def _jax_scan(family: str, chunk: int):
    if family == "mamba":
        return lambda dt, B, C, xg, A, h0: jssm.selective_scan(
            dt, B, C, xg, A, chunk, h0)
    return lambda *a: jrwkv._time_mix_scan(*a, chunk)


def _run_port(fn, inputs, cot):
    """Outputs and the gradient of <outputs, cot> for every input."""
    xs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in inputs]
    y, last = fn(*xs)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(cot[0])).sum()
        + (last * torch.from_numpy(cot[1])).sum(), xs)
    return y.detach(), last.detach(), grads


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("family", ["mamba", "rwkv"])
def test_chunked_scan_matches_stepwise_and_reference(family, chunk):
    """A chunked scan's outputs, last state and input gradients equal the
    step-by-step loop's bit for bit, at every chunk (one step, chunks that
    do not divide S, the whole sequence, a chunk longer than it); and the
    reference's scan at the same chunk within Queue C 15's bar."""
    inputs = _scan_inputs(family)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        y0, last0 = _port_scan(family, None)(
            *[torch.from_numpy(a) for a in inputs])
    cot = [rng.standard_normal(y0.shape).astype(np.float32),
           rng.standard_normal(last0.shape).astype(np.float32)]
    want = _run_port(_port_scan(family, None), inputs, cot)
    got = _run_port(_port_scan(family, chunk), inputs, cot)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)
    with torch.no_grad():   # without a graph: no checkpoint, the same bits
        y, last = _port_scan(family, chunk)(
            *[torch.from_numpy(a) for a in inputs])
    assert torch.equal(y, want[0]) and torch.equal(last, want[1])

    jfn = _jax_scan(family, chunk)

    def loss(*xs):
        y, last = jfn(*xs)
        return jnp.sum(y * cot[0]) + jnp.sum(last * cot[1])

    jy, jlast = jax.jit(jfn)(*inputs)
    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs)))))(
        *inputs)
    for a, b in ((got[0], jy), (got[1], jlast), *zip(got[2], jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=SCAN_ATOL, rtol=SCAN_RTOL)


# -------------------------------------------------- what the backward keeps


class Kept:
    """While active, what a forward keeps for its backward: every tensor
    packed through ``saved_tensors_hooks`` (the non-reentrant checkpoint
    packs its tensor arguments through them; what it saves inside is
    dropped and recomputed), each storage counted once, the storages of
    ``exclude`` (the parameters) left out; and the outputs a selective
    checkpoint's policy decides to save, read from the policy."""

    def __init__(self, monkeypatch, exclude=()):
        self.storages = {}
        self.shapes = []
        self.saved_outputs = []
        self.exclude = {t.untyped_storage().data_ptr() for t in exclude}
        real = ckpt.create_selective_checkpoint_contexts

        def spy(policy, *a, **k):
            def recording(ctx, op, *args, **kw):
                decision = policy(ctx, op, *args, **kw)
                if decision in (ckpt.CheckpointPolicy.MUST_SAVE,
                                ckpt.CheckpointPolicy.PREFER_SAVE):
                    self.saved_outputs.append(
                        (op.overloadpacket.__name__,
                         tuple(ctx.op_output.shape),
                         ctx.op_output.numel()
                         * ctx.op_output.element_size()))
                return decision
            return real(recording, *a, **k)

        monkeypatch.setattr(ckpt, "create_selective_checkpoint_contexts",
                            spy)

    def _pack(self, t):
        st = t.untyped_storage()
        if st.data_ptr() not in self.exclude:
            self.storages[st.data_ptr()] = st.nbytes()
            self.shapes.append(tuple(t.shape))
        return t

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)

    @property
    def bytes(self) -> int:
        return sum(self.storages.values()) + sum(
            b for _, _, b in self.saved_outputs)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("family", ["mamba", "rwkv"])
def test_chunked_scan_keeps_one_state_a_chunk(family, chunk):
    """A chunked scan keeps ceil(S / chunk) states for the backward (each
    chunk's input state), where the step-by-step loop keeps one or more a
    step."""
    def states(fn):
        inputs = [torch.from_numpy(a).requires_grad_(True)
                  for a in _scan_inputs(family)]
        shape = tuple(inputs[-1].shape)
        ptrs = set()

        def pack(t):
            if tuple(t.shape) == shape:
                ptrs.add(t.untyped_storage().data_ptr())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(*inputs)
        del out
        return len(ptrs)

    assert states(_port_scan(family, chunk)) == math.ceil(SCAN_S / chunk)
    assert states(_port_scan(family, None)) >= SCAN_S


def _kept(monkeypatch, cfg, params, tokens) -> Kept:
    """What ``loss_fn``'s forward keeps, the parameters left out."""
    leaves, live = _live(params)
    with Kept(monkeypatch, exclude=leaves) as kept:
        loss, _ = TM.loss_fn(live, cfg, tokens[:, :-1], tokens[:, 1:])
    kept.loss = loss
    return kept


@pytest.mark.parametrize("label", ["dense", "moe-dispatch", "jamba-smoke",
                                   "rwkv-smoke"])
def test_full_remat_keeps_the_group_inputs(monkeypatch, label):
    """At "full" each group adds its input carry (x (B, S, d) and the
    float32 aux scalar) to what the forward keeps, and nothing else: the
    step from G to G + 1 groups is that carry; at "none" it is the group's
    activations, many times more. What stays is the model's outside the
    loop (the lookup, the head, the cross-entropy)."""
    cfg0 = _config(label)
    period = len(cfg0.layer_pattern)
    tok = _tokens(cfg0)
    kept = {}
    for remat in ("none", "full"):
        for groups in (1, 2, 3):
            cfg = cfg0.scaled(remat=remat, num_layers=groups * period)
            params = TM.init_params(cfg, torch.Generator().manual_seed(0))
            kept[remat, groups] = _kept(monkeypatch, cfg, params, tok).bytes
    b, s = tok.shape[0], tok.shape[1] - 1
    carry = b * s * cfg0.d_model * 4 + 4
    assert kept["full", 2] - kept["full", 1] == carry, kept
    assert kept["full", 3] - kept["full", 2] == carry, kept
    per_group = kept["none", 3] - kept["none", 2]
    assert per_group == kept["none", 2] - kept["none", 1]
    assert per_group > 4 * carry, kept
    for groups in (1, 2, 3):
        assert kept["full", groups] < kept["none", groups]


def test_dots_saves_the_projections_alone(monkeypatch):
    """At "dots" the forward keeps the group inputs and the outputs of the
    products with no batch dimension: per layer the q, k, v and output
    projections and the MLP's gate, up and down, each (B, S, width); no
    attention score or weighted sum (``bhqk``), though ``torch.einsum``
    issues the same ``bmm`` for both."""
    cfg = _config("dense", remat="dots")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    tok = _tokens(cfg)
    kept = _kept(monkeypatch, cfg, params, tok)
    rows = tok.shape[0] * (tok.shape[1] - 1)
    hd = cfg.d_model // cfg.num_heads
    widths = [cfg.num_heads * hd, cfg.num_kv_heads * hd,
              cfg.num_kv_heads * hd, cfg.d_model, cfg.d_ff, cfg.d_ff,
              cfg.d_model]
    want = sorted(rows * w * 4 for w in widths * cfg.num_layers)
    assert sorted(b for _, _, b in kept.saved_outputs) == want
    assert {op for op, _, _ in kept.saved_outputs} <= {"bmm", "mm"}
    full = _kept(monkeypatch, cfg.scaled(remat="full"), params, tok)
    assert not full.saved_outputs
    assert kept.bytes == full.bytes + sum(want)


def test_dots_saves_the_router_and_not_the_experts(monkeypatch):
    """The MoE layer at "dots": the router's ``td,de->te`` is saved, the
    experts' batched ``ecd,edf->ecf`` products are not."""
    cfg = _config("moe-dispatch", remat="dots")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    tok = _tokens(cfg)
    kept = _kept(monkeypatch, cfg, params, tok)
    tokens = tok.shape[0] * (tok.shape[1] - 1)
    shapes = [sh for _, sh, _ in kept.saved_outputs]
    numels = [math.prod(sh) for sh in shapes]
    assert numels.count(tokens * cfg.num_experts) == cfg.num_layers
    assert not any(sh[0] == cfg.num_experts for sh in shapes), shapes


@pytest.mark.parametrize("label", ["dense", "moe-dispatch", "jamba-smoke",
                                   "rwkv-smoke"])
def test_no_checkpoint_where_autograd_records_nothing(monkeypatch, label):
    """At "full": ``forward`` with its cache, ``decode_step`` and
    ``ServeEngine.generate`` run no checkpoint (no graph, nothing to
    keep), and give the bits they give at "none"."""
    cfg = _config(label, remat="full")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    tok = _tokens(cfg, s=9)

    def refuse(*a, **k):
        raise AssertionError("a checkpoint ran without a graph")

    def serve(c):
        with torch.no_grad():
            logits, _, cache = TM.forward(params, c, tok, return_cache=True)
        with torch.inference_mode():
            step, _ = TM.decode_step(params, c, TM.init_cache(
                c, 2, 12, device="cpu"), tok[:, :1], 0)
        tokens = ServeEngine(c, params, 16, device="cpu").generate(
            tok[:, :4].numpy(), 4).tokens
        return logits, cache, step, tokens

    want = serve(cfg.scaled(remat="none"))
    monkeypatch.setattr(ckpt, "checkpoint", refuse)
    got = serve(cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    for (_, a), (_, b) in zip(tree_leaves_with_path(got[1]),
                              tree_leaves_with_path(want[1])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[3], want[3])
    # and with a graph the same forward does checkpoint
    with pytest.raises(AssertionError, match="without a graph"):
        _grads(cfg, params, tok)
