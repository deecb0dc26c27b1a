"""Fault-tolerant checkpointing: atomic npz shards + manifest, resume logic.

The port's counterpart of ``repro.checkpoint.checkpointer``, with the same
on-disk format, so a checkpoint written by either package restores in the
other:

  ckpt_dir/
    step_000100/
      manifest.json        {step, index: path -> {file, key, shape, dtype}, done: true}
      shard_00000.npz      flat leaves (keys leaf_000000, ...), ~512 MB a file
    step_000200/ ...
    LATEST                 atomic pointer file, written last

Crash safety: shards are written to ``step_X.tmp/`` then the directory is
atomically renamed and LATEST updated (the manifest itself is also written
via temp + ``os.replace`` inside the staging dir); a step directory whose
manifest is missing, unparsable, lacks ``done: true``, or references a
shard file that is absent or not a valid zip archive is treated as
*invalid*: ``latest_step`` warns and falls back to the newest **valid**
step instead of crashing the restoring job, so a kill mid-save — or a torn
disk write that corrupts the newest checkpoint — costs at most one
checkpoint interval, never the whole bulk job. ``keep`` bounds disk usage.

Trees: a small walker of its own stands in for ``jax.tree_util``. It
descends dicts (keys in sorted order, as JAX flattens them), lists and
tuples; ``None`` holds no leaf; anything else is a leaf: numpy arrays and
scalars, Python numbers, torch tensors (saved via ``.cpu().numpy()``).
Leaf paths are written as JAX's ``keystr`` writes them (``['runs']``,
``[0]``).

Restore: ``restore(step, like, device=None)`` rebuilds ``like``'s
structure; each leaf takes ``like``'s dtype. A leaf whose ``like`` is a
torch tensor comes back as a tensor (on ``device``, or where ``like``'s
lies), every leaf does when ``device`` is given, and the rest come back as
numpy arrays. The reference narrows int64 to int32 on restore (JAX runs with
x64 off); the port keeps int64.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zipfile
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

_SHARD_BYTES = 512 * 1024 * 1024


def _flatten_with_paths(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{path}[{k!r}]")
    elif type(tree) in (list, tuple):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if type(like) in (list, tuple):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any) -> str:
        """Blocking unless async_save; returns the final step directory."""
        items = [(p, _to_host(v)) for p, v in _flatten_with_paths(tree)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, items), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, items)
        return os.path.join(self.dir, f"step_{step:08d}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, items: List[Tuple[str, np.ndarray]]):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index, shard, size, shard_id = {}, {}, 0, 0

        def flush():
            nonlocal shard, size, shard_id
            if shard:
                np.savez(os.path.join(tmp, f"shard_{shard_id:05d}.npz"), **shard)
                shard, size = {}, 0
                shard_id += 1

        for i, (path, arr) in enumerate(items):
            key = f"leaf_{i:06d}"
            index[path] = {
                "file": f"shard_{shard_id:05d}.npz",
                "key": key,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
            shard[key] = arr
            size += arr.nbytes
            if size >= _SHARD_BYTES:
                flush()
        flush()
        # manifest via temp + atomic rename: a kill mid-json.dump leaves a
        # .tmp file the validator ignores, never a half-written manifest
        # that parses but lies
        man_tmp = os.path.join(tmp, "manifest.json.tmp")
        with open(man_tmp, "w") as f:
            json.dump({"step": step, "index": index, "done": True}, f)
        os.replace(man_tmp, os.path.join(tmp, "manifest.json"))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def _validate_step_dir(self, name: str) -> Optional[int]:
        """Step number if ``name`` holds a complete, readable checkpoint.

        A valid step dir has a parsable manifest with ``done: true`` whose
        every referenced shard file exists and is a well-formed zip (npz)
        containing the expected member. Anything else — truncated JSON from
        a kill mid-write, a missing or torn shard — returns None.
        """
        d = os.path.join(self.dir, name)
        man = os.path.join(d, "manifest.json")
        try:
            with open(man) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return None
        if not m.get("done") or not isinstance(m.get("step"), int):
            return None
        index = m.get("index", {})
        try:
            members_by_file: dict[str, set] = {}
            for meta in index.values():
                members_by_file.setdefault(meta["file"], set()).add(
                    meta["key"] + ".npy")
            for fname, members in members_by_file.items():
                with zipfile.ZipFile(os.path.join(d, fname)) as z:
                    if not members.issubset(set(z.namelist())):
                        return None
        except (OSError, KeyError, TypeError, zipfile.BadZipFile):
            return None
        return m["step"]

    def latest_step(self) -> Optional[int]:
        """Newest *valid* step, or None.

        The LATEST pointer is a hint, not an authority: if the step it
        names fails validation (kill during ``_write``, torn shard), this
        warns and scans the step directories newest-first for the first
        one that validates, so a corrupt checkpoint costs one save
        interval instead of crashing the whole bulk job.
        """
        ptr = os.path.join(self.dir, "LATEST")
        pointed: Optional[str] = None
        if os.path.exists(ptr):
            try:
                with open(ptr) as f:
                    pointed = f.read().strip()
            except OSError:
                pointed = None
        if pointed:
            step = self._validate_step_dir(pointed)
            if step is not None:
                return step
            warnings.warn(
                f"checkpoint {pointed!r} (named by LATEST) is incomplete "
                f"or corrupt; falling back to the newest valid step",
                RuntimeWarning, stacklevel=2)
        candidates = sorted(
            (d for d in os.listdir(self.dir)
             if d.startswith("step_") and not d.endswith(".tmp")),
            reverse=True)
        for name in candidates:
            if name == pointed:
                continue  # already failed validation above
            step = self._validate_step_dir(name)
            if step is not None:
                return step
            warnings.warn(
                f"checkpoint {name!r} is incomplete or corrupt; skipping",
                RuntimeWarning, stacklevel=2)
        return None

    def restore(self, step: int, like: Any, device: Any = None) -> Any:
        """Restore into the structure of ``like``; optionally onto a torch
        ``device``."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        index = manifest["index"]
        files: dict[str, Any] = {}

        def load(path: str, leaf: Any) -> Any:
            meta = index[path]
            if meta["file"] not in files:
                files[meta["file"]] = np.load(os.path.join(d, meta["file"]))
            arr = files[meta["file"]][meta["key"]]
            if isinstance(leaf, torch.Tensor):
                dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
                return torch.from_numpy(arr.astype(dtype)).to(
                    leaf.device if device is None else device)
            if hasattr(leaf, "dtype"):
                arr = arr.astype(leaf.dtype)
            return arr if device is None else torch.from_numpy(
                np.asarray(arr)).to(device)

        out = [load(p, leaf) for p, leaf in _flatten_with_paths(like)]
        return _unflatten(like, iter(out))
