"""The port's ``Checkpointer`` (``repro_torch.checkpoint``): the cases of
``tests/test_checkpoint.py`` as parametrised cases, and the format shared
with the JAX package's: a checkpoint written by either restores in the
other with equal values and an equal ``manifest.json`` index.

Corruption is simulated deliberately (a truncated shard zip, a partial
manifest, LATEST naming a lost directory); each recovery case asserts the
fallback step and the ``RuntimeWarning`` that signals it. Restores compare
values, dtypes and shapes exactly.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    _flatten_with_paths,
)


def _tree(seed=0):
    """Nested tree with mixed dtypes and shapes (no int64/float64, so the
    JAX package restores it unnarrowed)."""
    rng = np.random.default_rng(seed)
    return {
        "state": {
            "runs": rng.integers(0, 100, 37).astype(np.int32),
            "carry": (rng.random(37) < 0.5).astype(np.uint8),
        },
        "meta": [np.int32(seed), np.float32(seed / 2)],
        "scalar": np.zeros((), np.int32) + seed,
    }


def _leaves(tree):
    return [np.asarray(v) for _, v in _flatten_with_paths(tree)]


def _assert_tree_equal(got, want):
    g_leaves, w_leaves = _leaves(got), _leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _corrupt_shard(ckpt_dir, step):
    """Truncate a step's first shard: the zip central directory is at the
    end of the file, so this is unreadable, like a torn disk write."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    shard = sorted(f for f in os.listdir(d) if f.endswith(".npz"))[0]
    with open(os.path.join(d, shard), "r+b") as f:
        f.truncate(8)


def _manifest(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


# -------------------------------------------------------------- round trip


@pytest.mark.parametrize("async_save", [False, True])
def test_save_restore_round_trip(tmp_path, async_save):
    ckpt = Checkpointer(str(tmp_path), async_save=async_save)
    tree = _tree(seed=3)
    ckpt.save(100, tree)
    ckpt.wait()   # flush: the write thread owns the files until joined
    assert ckpt.latest_step() == 100
    _assert_tree_equal(ckpt.restore(100, like=tree), tree)


def test_keep_gc_drops_oldest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        ckpt.save(step, _tree(seed=step))
    names = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert names == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step() == 4


def test_latest_none_on_empty_dir(tmp_path):
    assert Checkpointer(str(tmp_path)).latest_step() is None


def test_leftover_tmp_dir_is_ignored(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(3, _tree(seed=3))
    # a kill between staging and the atomic rename leaves only .tmp
    os.makedirs(os.path.join(tmp_path, "step_00000009.tmp"))
    assert ckpt.latest_step() == 3


# ------------------------------------------------- crash-recovery fallback


def _truncate_manifest(d):
    man = os.path.join(d, "step_00000002", "manifest.json")
    with open(man) as f:
        text = f.read()
    with open(man, "w") as f:
        f.write(text[: len(text) // 2])   # kill mid-json.dump


def _drop_done_flag(d):
    man = os.path.join(d, "step_00000002", "manifest.json")
    with open(man) as f:
        m = json.load(f)
    del m["done"]
    with open(man, "w") as f:
        json.dump(m, f)


def _remove_shards(d):
    step = os.path.join(d, "step_00000002")
    for f in os.listdir(step):
        if f.endswith(".npz"):
            os.remove(os.path.join(step, f))


@pytest.mark.parametrize("corrupt, match", [
    (lambda d: _corrupt_shard(d, 2), "step_00000002"),
    (_truncate_manifest, "step_00000002"),
    (_drop_done_flag, "step_00000002"),
    (_remove_shards, "step_00000002"),
], ids=["torn-shard", "truncated-manifest", "no-done-flag", "missing-shard"])
def test_invalid_newest_step_falls_back_with_warning(tmp_path, corrupt, match):
    ckpt = Checkpointer(str(tmp_path))
    good = _tree(seed=1)
    ckpt.save(1, good)
    ckpt.save(2, _tree(seed=2))
    corrupt(str(tmp_path))
    with pytest.warns(RuntimeWarning, match=match):
        assert ckpt.latest_step() == 1
    _assert_tree_equal(ckpt.restore(1, like=good), good)


def test_latest_pointing_at_missing_dir_falls_back(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(5, _tree(seed=5))
    with open(os.path.join(tmp_path, "LATEST"), "w") as f:
        f.write("step_00000099")   # pointer updated, dir lost
    with pytest.warns(RuntimeWarning, match="step_00000099"):
        assert ckpt.latest_step() == 5


def test_all_checkpoints_corrupt_returns_none(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, _tree(seed=1))
    _corrupt_shard(str(tmp_path), 1)
    with pytest.warns(RuntimeWarning):
        assert ckpt.latest_step() is None


# ------------------------------------------ the format both packages share


def test_leaf_paths_are_jax_keystr():
    tree = {"b": [1, (np.zeros(2), 3)], "a": {"z": 1, "y": None, "x": 2}}
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert [p for p, _ in _flatten_with_paths(tree)] == want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    tree = _tree(seed=6)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxCheckpointer(jdir).save(42, tree)
    Checkpointer(pdir).save(42, tree)
    assert _manifest(jdir, 42)["index"] == _manifest(pdir, 42)["index"]
    src = jdir if writer == "jax" else pdir
    reader = Checkpointer(src) if writer == "jax" else JaxCheckpointer(src)
    assert reader.latest_step() == 42
    _assert_tree_equal(reader.restore(42, like=tree), tree)


def test_torch_leaves_save_and_restore_as_tensors(tmp_path):
    tree = {"runs": torch.arange(5, dtype=torch.int32),
            "mask": torch.tensor([True, False]),
            "step": np.int64(7)}
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, tree)
    index = _manifest(str(tmp_path), 1)["index"]
    assert index["['runs']"]["dtype"] == "int32"
    assert index["['mask']"]["dtype"] == "bool"
    got = ckpt.restore(1, like=tree)
    assert isinstance(got["runs"], torch.Tensor)
    assert torch.equal(got["runs"], tree["runs"])
    assert torch.equal(got["mask"], tree["mask"])
    # int64 stays int64 (the JAX package narrows it to int32 on restore)
    assert isinstance(got["step"], np.ndarray)
    assert got["step"].dtype == np.int64 and int(got["step"]) == 7
    on_cpu = ckpt.restore(1, like=tree, device="cpu")
    assert on_cpu["step"].dtype == torch.int64 and int(on_cpu["step"]) == 7


def test_restore_casts_onto_the_like_dtypes(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"a": np.arange(4, dtype=np.int64)})
    got = ckpt.restore(1, like={"a": np.zeros(1, np.int32)})
    assert got["a"].dtype == np.int32 and got["a"].tolist() == [0, 1, 2, 3]
