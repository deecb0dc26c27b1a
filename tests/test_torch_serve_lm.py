"""The port's LM serving against the JAX package's: ``ServeEngine``
greedy tokens exactly equal to JAX's on the same weights (carried across
by ``params_from_jax``), the step builders, the engine's checks, and
``launch.serve --workload lm`` and the ``serve_lm`` example with
``--device cpu``.

Sampling with ``temperature > 0`` draws from a ``torch.Generator``, not
``jax.random``, so those tokens are held to reproducibility and range
only (ROADMAP Queue C).
"""

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
from repro.configs.archs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train.step import make_prefill_step as jprefill  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.examples import serve_lm as example  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_leaves_with_path  # noqa: E402
from repro_torch.serve import GenerationResult, ServeEngine  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# tests/test_substrates.py::test_serve_engine_greedy_matches_forward's model
SUBSTRATES = dict(name="t", family="dense", num_layers=2, d_model=32,
                  num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=61,
                  param_dtype="float32", activation_dtype="float32",
                  remat="none", attn_chunk=64)
PROMPTS = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: its models are small,
    and the suite's other workers share the CPU (eight threads a worker
    spin against each other)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

def _engines(jc, tc, max_len):
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return (JServeEngine(jc, jp, max_len=max_len),
            ServeEngine(tc, tp, max_len=max_len, device="cpu"))


@pytest.mark.parametrize("arch", [
    None, "minicpm3-4b", "musicgen-medium", "rwkv6-3b", "jamba-v0.1-52b",
    "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"])
def test_greedy_tokens_equal_jax(arch):
    """Greedy tokens exactly equal to JAX's ServeEngine: the substrates
    test's model, and the MLA, the LayerNorm/GELU/sinusoidal, the RWKV,
    the hybrid and the two MoE smoke configs (prompts past
    ``attn_chunk``, so prefill runs the chunked core; the recurrent
    families prefill their state and decode from it)."""
    if arch is None:
        jc, tc = JModelConfig(**SUBSTRATES), ModelConfig(**SUBSTRATES)
        prompts, new, max_len = PROMPTS, 6, 32
    else:
        jc, tc = jsmoke(arch), smoke_config(arch)
        prompts = np.random.default_rng(3).integers(
            0, tc.vocab_size, (2, 128)).astype(np.int32)
        new, max_len = 8, 136
    jeng, teng = _engines(jc, tc, max_len)
    want = jeng.generate(prompts, max_new=new)
    got = teng.generate(prompts, max_new=new)
    assert isinstance(got, GenerationResult)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (2, new)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.n_generated == want.n_generated == new
    np.testing.assert_array_equal(teng.generate(prompts, max_new=new).tokens,
                                  got.tokens)


def test_greedy_tokens_are_forwards_argmax():
    """Each greedy token is the first maximum of a full forward over the
    prompt and the tokens before it."""
    tc = ModelConfig(**SUBSTRATES)
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(1))
    out = ServeEngine(tc, params, 16, device="cpu").generate(PROMPTS, 5)
    seq = np.concatenate([PROMPTS, out.tokens], axis=1)
    with torch.inference_mode():
        logits = TM.forward(params, tc, torch.from_numpy(seq))[0]
    want = torch.argmax(logits[:, 3:-1], dim=-1).numpy()
    np.testing.assert_array_equal(out.tokens, want)


def test_steps_match_jax_prefill():
    jc, tc = JModelConfig(**SUBSTRATES), ModelConfig(**SUBSTRATES)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    jlast, jcache = jprefill(jc)(jp, {"tokens": jnp.asarray(PROMPTS)})
    with torch.inference_mode():
        last, cache = make_prefill_step(tc)(
            tp, {"tokens": torch.from_numpy(PROMPTS)})
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   atol=2e-5, rtol=1e-5)
        assert last.shape == (2, tc.vocab_size)
        full = TM.init_cache(tc, 2, 8, device="cpu")
        serve = make_serve_step(tc)
        for i in range(4):
            lg, full = serve(tp, full, torch.from_numpy(PROMPTS[:, i:i + 1]),
                             i)
        np.testing.assert_allclose(lg.numpy(), last.numpy(), atol=2e-5,
                                   rtol=1e-5)
    got = dict(tree_leaves_with_path(cache))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
        key = tuple(k.key for k in path)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(leaf),
                                   atol=2e-5, rtol=1e-5)
    # a mesh without rules lays nothing out, as the reference's Sharder
    # (a mesh raised here until the sharding slice, ROADMAP 6e)
    with torch.inference_mode():
        lg2, _ = make_serve_step(tc, mesh=object())(
            tp, TM.init_cache(tc, 2, 8, device="cpu"),
            torch.from_numpy(PROMPTS[:, :1]), 0)
        first = make_serve_step(tc)(tp, TM.init_cache(tc, 2, 8, device="cpu"),
                                    torch.from_numpy(PROMPTS[:, :1]), 0)[0]
        assert torch.equal(lg2, first)


def test_sampling_is_seeded_and_in_range():
    tc = ModelConfig(**SUBSTRATES)
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    eng = ServeEngine(tc, params, 32, device="cpu")
    a = eng.generate(PROMPTS, 20, temperature=0.9, seed=5).tokens
    b = eng.generate(PROMPTS, 20, temperature=0.9, seed=5).tokens
    c = eng.generate(PROMPTS, 20, temperature=0.9, seed=6).tokens
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < tc.vocab_size


def test_engine_checks_its_inputs():
    tc = ModelConfig(**SUBSTRATES)
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    eng = ServeEngine(tc, params, 8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(PROMPTS, 5)
    with pytest.raises(ValueError, match="outside"):
        eng.generate(np.array([[1, 61]], np.int32), 2)
    with pytest.raises(ValueError, match="not on"):
        ServeEngine(tc, params, 8, device="meta")
    first = eng.generate(PROMPTS[:1], 1).tokens[0, 0]
    stopped = eng.generate(PROMPTS[:1], 4, eos_id=int(first))
    assert stopped.n_generated == 1 and stopped.tokens.shape == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(tc, params, 8)


def test_pad_cache_grows_the_sequence_axis():
    for arch in ("qwen2-0.5b", "minicpm3-4b"):
        tc = smoke_config(arch)
        params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
        eng = ServeEngine(tc, params, 12, device="cpu")
        with torch.inference_mode():
            _, cache = eng._prefill(params, torch.from_numpy(PROMPTS))
            padded = eng._pad_cache(cache)
        for path, leaf in tree_leaves_with_path(padded):
            assert leaf.shape[2] == 12, path
            small = dict(tree_leaves_with_path(cache))[path]
            assert torch.equal(leaf[:, :, :4], small) and not leaf[:, :, 4:].any()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_pad_cache_passes_state_entries_through(arch):
    """The recurrent state (Mamba's ``h`` and ``conv``, RWKV's ``wkv`` and
    both ``shift`` entries) has no sequence axis: ``_pad_cache`` hands it
    on untouched, the same tensors, while attention's k/v grow."""
    tc = smoke_config(arch)
    params = TM.init_params(tc, torch.Generator("cpu").manual_seed(0))
    eng = ServeEngine(tc, params, 12, device="cpu")
    with torch.inference_mode():
        _, cache = eng._prefill(params, torch.from_numpy(PROMPTS))
        padded = eng._pad_cache(cache)
    before = dict(tree_leaves_with_path(cache))
    names = set()
    for path, leaf in tree_leaves_with_path(padded):
        names.add(path[-1])
        if path[-1] in ("k", "v"):
            assert leaf.shape[2] == 12, path
        else:
            assert leaf is before[path], path
    assert names >= ({"wkv", "shift"} if arch == "rwkv6-3b"
                     else {"h", "conv", "k", "v"})


def test_serve_lm_cli_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "lm", "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "qwen2-0.5b: 0.09M params on cpu"
    assert lines[-1].startswith("generated 128 tokens in ")


def test_serve_lm_in_process_and_the_ychg_default(capsys):
    serve_main(["--workload", "lm", "--arch", "minicpm3-4b", "--smoke",
                "--batch", "2", "--prompt", "8", "--max-new", "4",
                "--device", "cpu"])
    assert "generated 8 tokens in " in capsys.readouterr().out
    serve_main(["--res", "32", "--batch", "2", "--device", "cpu"])
    assert "ychg service[torch] on cpu: 2 x 32^2 masks" in (
        capsys.readouterr().out)


def test_serve_lm_example(capsys):
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving qwen2-serve-tiny: 5.0M params on cpu" in out
    assert "generated 64 steps (512 tokens)" in out
    assert "greedy decode deterministic — OK" in out
