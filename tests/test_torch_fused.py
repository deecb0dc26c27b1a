"""Parity: the port's fused kernel wrappers and ``analyze_fused`` on the CPU
against the JAX package's Pallas kernels in interpret mode.

On a CPU tensor each wrapper runs its kernel's plain version; the CUDA
kernels themselves are held to those plain versions on the card by
``chip_smoke.py``. Here: both routes, the seam shapes, routing parity, the
wrappers' refusals, and that importing builds nothing.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ychg_fused import (  # noqa: E402
    fused_analyze_pallas,
    fused_analyze_streamed,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ychg_fused as kf  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT_KEYS = ("runs", "transitions", "births", "deaths", "n_hyperedges",
            "n_transitions")


def assert_same(got, want, label=""):
    g = got.cpu().numpy()
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{label}: {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{label}: {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=label)


def assert_dicts_same(got, want):
    assert set(got) == set(want) == set(OUT_KEYS)
    for k in OUT_KEYS:
        assert_same(got[k], want[k], k)


def _stack(shape, seed, p=0.5, dtype=np.uint8):
    return (np.random.default_rng(seed).random(shape) < p).astype(dtype)


# ------------------------------------------------------- full-column route


@pytest.mark.parametrize("shape,dtype", [
    ((2, 7, 5), np.uint8), ((2, 33, 200), np.int32),
    ((3, 16, 128), np.bool_), ((1, 5, 1024), np.float32),
    ((2, 1, 300), np.uint8), ((2, 200, 1), np.uint8),
    ((1, 1, 1), np.uint8), ((2, 19, 141), np.int16),
])
def test_full_matches_pallas_interpret(shape, dtype):
    imgs = _stack(shape, sum(shape), dtype=dtype)
    assert_dicts_same(kf.ychg_fused_full(torch.from_numpy(imgs)),
                      fused_analyze_pallas(jnp.asarray(imgs), interpret=True))


@pytest.mark.parametrize("fill", [0, 1])
def test_full_constant_masks(fill):
    imgs = np.full((3, 19, 141), fill, np.uint8)
    assert_dicts_same(kf.ychg_fused_full(torch.from_numpy(imgs)),
                      fused_analyze_pallas(jnp.asarray(imgs), interpret=True))


# ----------------------------------------------------------- split-H route


@pytest.mark.parametrize("shape,block_h", [
    ((2, 130, 140), 4), ((2, 130, 140), 16), ((2, 33, 129), 16),
    ((1, 130, 257), 16), ((3, 257, 131), 16), ((2, 64, 8), 16),
])
def test_splith_matches_streamed_interpret(shape, block_h):
    """The seam shapes of tests/test_ychg_fused.py: H and W not multiples of
    the block sizes, and runs crossing every H seam."""
    p = 1.0 if shape == (2, 64, 8) else 0.6
    imgs = _stack(shape, sum(shape), p=p)
    assert_dicts_same(
        kf.ychg_fused_splith(torch.from_numpy(imgs), block_h=block_h),
        fused_analyze_streamed(jnp.asarray(imgs), block_h=block_h,
                               interpret=True))


def test_splith_matches_full_plain():
    imgs = torch.from_numpy(_stack((2, 96, 200), 2))
    assert_dicts_same(kf.ychg_fused_splith_plain(imgs, 32),
                      {k: v.numpy() for k, v in
                       kf.ychg_fused_full_plain(imgs).items()})


# ------------------------------------------------------------ analyze_fused


@pytest.mark.parametrize("shape", [(45, 77), (3, 33, 200), (0, 8, 9)])
def test_analyze_fused_matches_jax(shape):
    imgs = _stack(shape, len(shape))
    got = tops.analyze_fused(torch.from_numpy(imgs))
    want = jops.analyze_fused(jnp.asarray(imgs))
    for f in SUMMARY_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f)


def test_routing_matches_jax(monkeypatch):
    """The split-H kernel runs exactly where the reference streams: when
    H * block_w exceeds the budget; results stay identical either way."""
    calls = []

    def spy(mod, name, tag):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(tag)
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(kf, "ychg_fused_full", "port-full")
    spy(kf, "ychg_fused_splith", "port-split")
    spy(jops._f, "fused_analyze_pallas", "jax-full")
    spy(jops._f, "fused_analyze_streamed", "jax-split")
    imgs = _stack((2, 70, 150), 3)
    for budget in (1, 70 * 128 - 1, 70 * 128, 1 << 30):
        calls.clear()
        got = tops.analyze_fused(torch.from_numpy(imgs), block_h=32,
                                 vmem_budget=budget)
        want = jops.analyze_fused(jnp.asarray(imgs), block_h=32,
                                  vmem_budget=budget)
        split = budget < 70 * 128
        assert calls == (["port-split", "jax-split"] if split
                         else ["port-full", "jax-full"]), (budget, calls)
        for f in SUMMARY_FIELDS:
            assert_same(getattr(got, f), getattr(want, f), f)


# ---------------------------------------------------------------- refusals


def test_wrappers_refuse_bad_input():
    x4 = torch.zeros((1, 2, 3, 4), dtype=torch.uint8)
    for fn in (kf.ychg_fused_full, kf.ychg_fused_splith):
        with pytest.raises(ValueError, match="stack"):
            fn(x4)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros((2, 8, 6), dtype=torch.uint8).transpose(1, 2))
        with pytest.raises(TypeError):
            fn(np.zeros((1, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="block_h"):
        kf.ychg_fused_splith(torch.zeros((1, 4, 4)), block_h=0)
    with pytest.raises(ValueError):
        tops.analyze_fused(x4)


def test_kernel_path_refuses_without_cuda():
    """The kernel path never falls back: a CPU tensor is refused, and the
    library will not load (or build) in a process that sees no card."""
    x = torch.zeros((1, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kf.launch_full(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kf.launch_splith(x, block_h=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("ychg_fused", kf._SIGNATURES)
    assert _build.loaded() == ()


def test_importing_builds_nothing(tmp_path):
    """Importing the kernel modules and running their CPU path starts no
    process (no nvcc) and loads no library."""
    script = textwrap.dedent("""
        import subprocess

        def refuse(*a, **k):
            raise AssertionError("a process was started")

        subprocess.Popen = subprocess.run = refuse
        import torch
        from repro_torch.kernels import _build, ops, ychg_fused
        ops.analyze_fused(torch.ones((2, 5, 7), dtype=torch.uint8))
        ops.analyze_fused(torch.ones((2, 5, 7)), vmem_budget=0, block_h=2)
        assert _build.loaded() == (), _build.loaded()
        assert ychg_fused.LAUNCHES == {"ychg_fused_full": 0,
                                       "ychg_fused_splith": 0}
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_library_path_names_source_hash():
    """A change to the source or the flags gives another library name, so a
    stale build is never loaded."""
    path = _build.library_path("ychg_fused")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libychg_fused-") and path.suffix == ".so"
    assert path == _build.library_path("ychg_fused")
