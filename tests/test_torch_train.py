"""The port's training against the JAX package's: AdamW, clipping and the
schedule; ``make_train_step`` on every architecture's smoke config;
``TrainLoop`` (loss falls, resume, gradient accumulation, the NaN skip,
the step deadline); training checkpoints shared by both packages; and
``launch.train`` and the ``train_lm`` example with ``--device cpu``.

Tolerances, each measured on these inputs:
  * the optimiser on the same float32 trees: within 1e-7 of JAX's (one
    float32 rounding of values near 1);
  * a train step (smoke configs, float32, 2 x 32 tokens, two steps, the
    second at lr 1.5e-4): loss and ``grad_norm`` within rtol 1e-5 of
    JAX's (measured at most 8.6e-8 and 1.4e-6, the latter RWKV's: the
    Mamba and RWKV recurrences sum in another order); the first moments
    within 1e-5 (measured 3.4e-7); the updated parameters within 7.5e-5,
    half the step's lr. AdamW divides each gradient component by its own
    root mean square, so a component whose gradient is at the rounding
    level of its terms (near eps) moves by up to its share of lr in
    either package, and a flipped sign would move it by 2 lr; measured at
    most 4.2e-5 (jamba, an entry of a Mamba ``w_dt``), under 1e-5 for
    every family without a recurrence.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.archs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro.train import TrainLoopConfig as JTrainLoopConfig  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    TokenDataset,
    TokenDatasetConfig,
)
from repro_torch.examples import train_lm as example  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_leaves_with_path  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    warmup_cosine,
)
from repro_torch.optim.adamw import abstract_opt_state  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TrainLoop,
    TrainLoopConfig,
    make_train_step,
)

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = 1e-7
LOSS_RTOL, GNORM_RTOL, MU_ATOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5, 7.5e-5

# tests/test_system.py::_tiny_cfg
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            tie_embeddings=True, param_dtype="float32",
            activation_dtype="float32", remat="none", attn_chunk=64)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: its models are small,
    and the suite's other workers share the CPU (eight threads a worker
    spin against each other)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

def _jax_paths(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _carry(jc, tc, seed: int = 0):
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                               "cpu")


def _tree_max_err(tree, jtree) -> float:
    want = _jax_paths(jtree)
    got = dict(tree_leaves_with_path(tree))
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[p].float().numpy() - w.astype(np.float32))
                     .max()) for p, w in want.items())


def _batches(ds, start: int, stop: int = 10_000):
    return (ds.batch(i) for i in range(start, stop))


# ------------------------------------------------------------------ optim


def test_adamw_first_step_is_signed_lr():
    """``test_substrates.py``'s twin: with wd 0 the first step moves each
    weight by lr against its gradient's sign; JAX's step on the same tree
    agrees."""
    p = {"w": torch.ones(4)}
    g = {"w": torch.tensor([1.0, -2.0, 3.0, -4.0])}
    st = adamw_init(p)
    p2, st2 = adamw_update(p, g, st, lr=1e-2, weight_decay=0.0)
    np.testing.assert_allclose((p2["w"] - p["w"]).numpy(),
                               -1e-2 * np.sign(g["w"].numpy()), rtol=1e-4)
    assert int(st2.step) == 1 and st2.step.dtype == torch.int32
    assert torch.equal(p["w"], torch.ones(4))   # out of place
    jp2, _ = jopt.adamw_update({"w": jnp.ones(4)}, {"w": jnp.asarray(
        g["w"].numpy())}, jopt.adamw_init({"w": jnp.ones(4)}), lr=1e-2,
        weight_decay=0.0)
    np.testing.assert_allclose(p2["w"].numpy(), np.asarray(jp2["w"]),
                               atol=OPT_TOL, rtol=0)


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - math.sqrt(90.0)) < 1e-4
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-4
    small, gn2 = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))
    jclipped, jgn = jopt.clip_by_global_norm({"a": jnp.full((10,), 3.0)}, 1.0)
    assert abs(float(gn) - float(jgn)) <= OPT_TOL * 10
    np.testing.assert_allclose(clipped["a"].numpy(), np.asarray(jclipped["a"]),
                               atol=OPT_TOL, rtol=0)


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(torch.tensor(s, dtype=torch.int32),
                               peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in range(100)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 0.11
    assert lrs[99] < 0.2
    assert max(lrs) <= 1.0 + 1e-6
    want = [float(jopt.warmup_cosine(jnp.int32(s), peak_lr=1.0,
                                     warmup_steps=10, total_steps=100))
            for s in range(100)]
    np.testing.assert_allclose(lrs, want, atol=OPT_TOL, rtol=0)


def test_adamw_update_matches_jax_on_mixed_dtypes():
    """Three steps on a tree of float32 and bfloat16 leaves: float32
    moments whatever the leaf's dtype, decay on every leaf, the leaves
    cast back to their dtype; equal to JAX's to one float32 rounding
    (bfloat16 leaves exactly)."""
    rng = np.random.default_rng(0)
    p32 = rng.standard_normal((3, 5)).astype(np.float32)
    pbf = rng.standard_normal((7,)).astype(np.float32)
    jp = {"a": jnp.asarray(p32), "b": jnp.asarray(pbf).astype(jnp.bfloat16)}
    tp = {"a": torch.from_numpy(p32.copy()),
          "b": torch.from_numpy(pbf.copy()).to(torch.bfloat16)}
    jst, tst = jopt.adamw_init(jp), adamw_init(tp)
    assert tst.mu["b"].dtype == torch.float32
    for step in range(3):
        g32 = rng.standard_normal((3, 5)).astype(np.float32)
        gbf = rng.standard_normal((7,)).astype(np.float32)
        jg = {"a": jnp.asarray(g32), "b": jnp.asarray(gbf).astype(jnp.bfloat16)}
        tg = {"a": torch.from_numpy(g32),
              "b": torch.from_numpy(gbf).to(torch.bfloat16)}
        jp, jst = jopt.adamw_update(jp, jg, jst, lr=1e-2)
        tp, tst = adamw_update(tp, tg, tst, lr=torch.tensor(1e-2))
    assert tp["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               atol=OPT_TOL, rtol=0)
    np.testing.assert_array_equal(tp["b"].float().numpy(),
                                  np.asarray(jp["b"]).astype(np.float32))
    for name in ("mu", "nu"):
        for k in ("a", "b"):
            np.testing.assert_allclose(
                getattr(tst, name)[k].numpy(),
                np.asarray(getattr(jst, name)[k]), atol=OPT_TOL, rtol=1e-6)
    abstract = abstract_opt_state(tp)
    assert abstract.mu["b"].device.type == "meta"
    assert abstract.step.dtype == torch.int32


# ------------------------------------------------------------- train step


@pytest.mark.parametrize("name", list_archs())
def test_smoke_train_step_matches_jax(name):
    """``test_arch_smoke.py::test_smoke_train_step_and_decode``'s twin on
    every architecture: two train steps (the first at lr 0 of the
    warm-up, the second at 1.5e-4) from JAX's parameters on the same
    batch, then a decode step; loss, ``grad_norm``, ``lr`` and the
    updated parameters against JAX's step."""
    jc, tc = jsmoke(name), smoke_config(name)
    jp, tp = _carry(jc, tc)
    b, s = 2, 32
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32)}
    if jc.frontend != "none" and jc.frontend_tokens:
        batch["frontend_embeds"] = rng.standard_normal(
            (b, jc.frontend_tokens, jc.d_model)).astype(np.float32)
    jstep = jax.jit(jmake_train_step(jc, total_steps=10, warmup_steps=2))
    step = make_train_step(tc, total_steps=10, warmup_steps=2)
    jo, to = jopt.adamw_init(jp), adamw_init(tp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(2):
        jp, jo, jm = jstep(jp, jo, jbatch)
        tp, to, m = step(tp, to, batch)
        assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "lr"]
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                                   rtol=LOSS_RTOL, atol=1e-7)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GNORM_RTOL)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(to.step) == 2
    assert _tree_max_err(tp, jp) <= PARAM_ATOL
    assert _tree_max_err(to.mu, jo.mu) <= MU_ATOL
    cache = TM.init_cache(tc, b, s, device="cpu")
    with torch.inference_mode():
        lg, _ = TM.decode_step(tp, tc, cache,
                               torch.from_numpy(batch["tokens"][:, :1]), 0)
    assert lg.shape == (b, tc.vocab_size) and bool(torch.isfinite(lg).all())


def test_train_step_refuses_int8_weights():
    tc = ModelConfig(**TINY).scaled(weight_quant="int8")
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    batch = TokenDataset(TokenDatasetConfig(
        vocab_size=128, seq_len=8, global_batch=2)).batch(0)
    with pytest.raises(ValueError, match="floating-point"):
        make_train_step(tc)(params, adamw_init(params), batch)


# ------------------------------------------------------------------ system


def test_loss_decreases_over_training():
    """``test_system.py``'s twin, and its first loss equals JAX's."""
    jc, tc = JModelConfig(**TINY), ModelConfig(**TINY)
    jp, params = _carry(jc, tc)
    opt = adamw_init(params)
    ds = TokenDataset(TokenDatasetConfig(vocab_size=128, seq_len=32,
                                         global_batch=8, n_patterns=4))
    step = make_train_step(tc, peak_lr=3e-3, warmup_steps=5, total_steps=60)
    losses = []
    for i in range(60):
        params, opt, m = step(params, opt, ds.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    jstep = jax.jit(jmake_train_step(jc, peak_lr=3e-3, warmup_steps=5,
                                     total_steps=60))
    _, _, jm = jstep(jp, jopt.adamw_init(jp),
                     {k: jnp.asarray(v) for k, v in ds.batch(0).items()})
    np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=LOSS_RTOL)


def test_train_loop_resume(tmp_path):
    """Kill/restart: the resumed run continues from the checkpointed step
    and ends on the uninterrupted run's parameters and moments, bit for
    bit (the CPU's arithmetic is deterministic and the data a pure
    function of the step)."""
    tc = ModelConfig(**TINY)
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    opt = adamw_init(params)
    ds = TokenDataset(TokenDatasetConfig(vocab_size=128, seq_len=16,
                                         global_batch=4))
    step = make_train_step(tc, total_steps=30)

    def loop(total, directory):
        return TrainLoop(step, TrainLoopConfig(
            total_steps=total, ckpt_dir=directory, ckpt_every=5,
            log_every=100))

    p1, o1, s1 = loop(10, str(tmp_path / "a")).run(params, opt,
                                                   _batches(ds, 0))
    assert s1 == 10
    loop2 = loop(20, str(tmp_path / "a"))
    p2, o2, start = loop2.resume_or_init(params, opt)
    assert start == 10 and isinstance(o2, OptState)
    assert int(o2.step) == 10 and o2.step.dtype == torch.int32
    p3, o3, s3 = loop2.run(p2, o2, _batches(ds, start), start_step=start)
    assert s3 == 20
    pw, ow, _ = loop(20, str(tmp_path / "b")).run(params, opt,
                                                  _batches(ds, 0))
    for path, leaf in tree_leaves_with_path({"p": pw, "mu": ow.mu}):
        got = dict(tree_leaves_with_path({"p": p3, "mu": o3.mu}))[path]
        assert torch.equal(got, leaf), path


def test_grad_accum_matches_single_batch():
    """``test_system.py``'s twin (its bound 5e-3), and the port's
    accumulated step against JAX's."""
    jc, tc = JModelConfig(**TINY), ModelConfig(**TINY)
    jp, params = _carry(jc, tc)
    batch = TokenDataset(TokenDatasetConfig(vocab_size=128, seq_len=16,
                                            global_batch=8)).batch(0)
    p1, _, m1 = make_train_step(tc)(params, adamw_init(params), batch)
    p2, _, m2 = make_train_step(tc, grad_accum=2)(params, adamw_init(params),
                                                  batch)
    d = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_leaves_with_path(p1), tree_leaves_with_path(p2)))
    assert d < 5e-3, d
    jstep = jax.jit(jmake_train_step(jc, grad_accum=2))
    jp2, _, jm2 = jstep(jp, jopt.adamw_init(jp),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(jm2["grad_norm"]), rtol=GNORM_RTOL)
    assert _tree_max_err(p2, jp2) <= PARAM_ATOL


def test_nan_batch_leaves_the_parameters_unchanged():
    """A batch whose loss is not finite (a NaN in the frontend embeddings)
    is skipped and counted; the parameters and the optimiser state the
    loop returns are the ones it was given, bit for bit, since the step
    writes nothing in place; the next finite batch trains."""
    tc = ModelConfig(**dict(TINY, family="vlm", frontend="vision",
                            frontend_tokens=2))
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    before = {p: t.clone() for p, t in tree_leaves_with_path(params)}
    opt = adamw_init(params)
    good = TokenDataset(TokenDatasetConfig(vocab_size=128, seq_len=8,
                                           global_batch=2)).batch(0)
    bad = dict(good, frontend_embeds=np.full((2, 2, 64), np.nan, np.float32))
    step = make_train_step(tc, warmup_steps=0)   # lr is the peak at once
    loop = TrainLoop(step, TrainLoopConfig(total_steps=1, log_every=100))
    p, o, n = loop.run(params, opt, iter([bad]))
    assert n == 1 and loop.nan_skips == 1
    assert int(o.step) == 0
    for path, leaf in tree_leaves_with_path(p):
        assert torch.equal(leaf, before[path]), path
    loop = TrainLoop(step, TrainLoopConfig(total_steps=2, log_every=100))
    p, o, n = loop.run(params, opt, iter([bad, good]))
    assert loop.nan_skips == 1 and int(o.step) == 1
    assert not torch.equal(p["embed"], before[("embed",)])
    for path, leaf in tree_leaves_with_path(params):
        assert torch.equal(leaf, before[path]), path


def test_step_deadline_self_evicts(tmp_path):
    """Every step over a zero deadline: after ``max_step_retries`` + 1
    consecutive misses the loop checkpoints the step it reached and raises
    ``TimeoutError``."""
    tc = ModelConfig(**TINY)
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    ds = TokenDataset(TokenDatasetConfig(vocab_size=128, seq_len=8,
                                         global_batch=2))
    loop = TrainLoop(make_train_step(tc), TrainLoopConfig(
        total_steps=10, ckpt_dir=str(tmp_path), log_every=100,
        step_timeout_s=0.0, max_step_retries=1))
    with pytest.raises(TimeoutError, match="self-evicting"):
        loop.run(params, adamw_init(params), _batches(ds, 0))
    assert loop.deadline_misses == 2
    assert Checkpointer(str(tmp_path)).latest_step() == 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_training_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """A ``TrainLoop`` checkpoint ({"params", "opt"} with the optimiser's
    ``.step``, ``.mu[...]`` and ``.nu[...]`` paths) written by one package
    resumes in the other, every leaf equal and ``step`` int32 in both;
    the resumed step trains on."""
    jc, tc = JModelConfig(**TINY), ModelConfig(**TINY)
    jp, tp = _carry(jc, tc)
    ds = TokenDataset(TokenDatasetConfig(vocab_size=128, seq_len=16,
                                         global_batch=4))
    jstep = jax.jit(jmake_train_step(jc, total_steps=30))
    tstep = make_train_step(tc, total_steps=30)
    cfg = dict(total_steps=3, ckpt_dir=str(tmp_path), ckpt_every=100,
               log_every=100)
    if writer == "jax":
        wp, wo, _ = JTrainLoop(jstep, JTrainLoopConfig(**cfg)).run(
            jp, jopt.adamw_init(jp),
            ({k: jnp.asarray(v) for k, v in ds.batch(i).items()}
             for i in range(10)))
        p, o, start = TrainLoop(tstep, TrainLoopConfig(**dict(
            cfg, total_steps=4))).resume_or_init(tp, adamw_init(tp))
        assert start == 3 and o.step.dtype == torch.int32
        assert int(o.step) == 3
        for got, want in ((p, wp), (o.mu, wo.mu), (o.nu, wo.nu)):
            assert _tree_max_err(got, want) == 0.0
        TrainLoop(tstep, TrainLoopConfig(**dict(cfg, total_steps=4))).run(
            p, o, _batches(ds, 3), start_step=3)
    else:
        wp, wo, _ = TrainLoop(tstep, TrainLoopConfig(**cfg)).run(
            tp, adamw_init(tp), _batches(ds, 0))
        jck = JCheckpointer(str(tmp_path))
        assert jck.latest_step() == 3
        got = jck.restore(3, {"params": jp, "opt": jopt.adamw_init(jp)})
        assert got["opt"].step.dtype == jnp.int32
        assert int(got["opt"].step) == 3
        for want, tree in ((wp, got["params"]), (wo.mu, got["opt"].mu),
                           (wo.nu, got["opt"].nu)):
            assert _tree_max_err(want, tree) == 0.0


def test_bfloat16_leaves_checkpoint_as_the_jax_package_writes_them(tmp_path):
    """bfloat16 tensors are saved as their two bytes a value (NumPy's
    ``V2``, as the JAX package's bfloat16 arrays are) with ``bfloat16`` in
    the manifest, and restore bit for bit."""
    x = torch.randn(5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    ck = Checkpointer(str(tmp_path / "t"))
    ck.save(1, {"x": x, "opt": adamw_init({"x": x})})
    got = ck.restore(1, {"x": torch.zeros(5, dtype=torch.bfloat16),
                         "opt": adamw_init({"x": x})})
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], x)
    jck = JCheckpointer(str(tmp_path / "j"))
    jck.save(1, {"x": jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)})
    for d in ("t", "j"):
        man = (tmp_path / d / "step_00000001" / "manifest.json").read_text()
        assert '"dtype": "bfloat16"' in man, d
    back = Checkpointer(str(tmp_path / "j")).restore(
        1, {"x": torch.zeros(5, dtype=torch.bfloat16)})
    assert torch.equal(back["x"], x)


# -------------------------------------------------------- CLI and example


def test_launch_train_cli_on_the_cpu(capsys, tmp_path):
    launch_train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "20",
                       "--device", "cpu", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "qwen2-0.5b: 0.09M params on cpu"
    assert out[1].startswith("step 10: loss=") and out[2].startswith(
        "step 20: loss=")
    assert Checkpointer(str(tmp_path)).latest_step() == 20


@pytest.mark.parametrize("arch", ["rwkv6-3b", "llava-next-34b"])
def test_launch_train_other_families(capsys, arch):
    launch_train.main(["--arch", arch, "--smoke", "--steps", "10", "--batch",
                       "2", "--seq", "16", "--grad-accum", "2", "--device",
                       "cpu"])
    assert "step 10: loss=" in capsys.readouterr().out


def test_launch_train_wants_the_card_without_a_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])


def test_train_lm_example_resumes(capsys, tmp_path):
    example.main(["--tiny", "--steps", "20", "--device", "cpu", "--ckpt",
                  str(tmp_path)])
    out = capsys.readouterr().out
    assert "model qwen2-2m: 0.8M params on cpu" in out
    assert "step 20: loss=" in out and "nan_skips=0" in out
    example.main(["--tiny", "--steps", "30", "--device", "cpu", "--ckpt",
                  str(tmp_path)])
    out = capsys.readouterr().out
    assert "resumed from step 20" in out and "step 30: loss=" in out


def test_launch_train_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--steps", "10", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("step 10: loss=")
