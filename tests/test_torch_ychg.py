"""Parity: the port's plain-torch ``core.ychg`` against ``repro.core.ychg``.

The same seeded numpy inputs go through both packages; every field must
match exactly, dtypes included (the JAX package runs with x64 off, so
counts are int32 and transitions bool).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ychg as jychg  # noqa: E402
from repro_torch.core import ychg as tychg  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS, structured_masks  # noqa: E402

# the shape x dtype sweep of tests/test_ychg_fused.py
SHAPES = [(1, 1), (7, 5), (16, 128), (33, 200), (128, 384), (257, 131), (5, 1024)]
DTYPES = [np.uint8, np.int32, np.bool_, np.float32]


def assert_same(got, want, label=""):
    """Port tensor == JAX array: dtype, shape and every value."""
    g = got.cpu().numpy()
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{label}: {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{label}: {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=label)


def assert_summary_same(got, want):
    for f in SUMMARY_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_analyze_matches_jax_batched(shape, dtype):
    rng = np.random.default_rng(sum(shape) * 31 + DTYPES.index(dtype))
    imgs = (rng.random((3,) + shape) < 0.45).astype(dtype)
    assert_summary_same(tychg.analyze(torch.from_numpy(imgs)),
                        jychg.analyze(jnp.asarray(imgs)))


@pytest.mark.parametrize("index", range(len(structured_masks())))
def test_analyze_matches_jax_degenerate(index):
    img = structured_masks()[index]
    t, j = torch.from_numpy(img), jnp.asarray(img)
    assert_summary_same(tychg.analyze(t), jychg.analyze(j))
    assert_same(tychg.hyperedge_count(t), jychg.hyperedge_count(j),
                "hyperedge_count")
    assert bool(tychg.check_conservation(tychg.analyze(t)))


def test_step_functions_match_jax():
    """column_runs / hyperedge_transitions / hyperedge_count / the
    conservation check each match, with two leading batch dims."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 3, (2, 3, 19, 41)).astype(np.int32)
    t, j = torch.from_numpy(imgs), jnp.asarray(imgs)
    assert_same(tychg.column_runs(t), jychg.column_runs(j), "runs")
    tt = tychg.hyperedge_transitions(tychg.column_runs(t))
    jt = jychg.hyperedge_transitions(jychg.column_runs(j))
    assert set(tt) == set(jt)
    for k in jt:
        assert_same(tt[k], jt[k], k)
    assert_same(tychg.hyperedge_count(t), jychg.hyperedge_count(j), "count")
    assert_same(tychg.check_conservation(tychg.analyze(t)),
                jychg.check_conservation(jychg.analyze(j)), "conservation")


def test_float_mask_signed_zero_and_nan():
    """-0.0 is background and NaN foreground in both packages."""
    vals = np.array([0.0, -0.0, 2.5, np.nan, -1.0], np.float32)
    imgs = vals[np.random.default_rng(3).integers(0, 5, (2, 23, 37))]
    assert_summary_same(tychg.analyze(torch.from_numpy(imgs)),
                        jychg.analyze(jnp.asarray(imgs)))
