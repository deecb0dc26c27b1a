"""Carry a JAX parameter tree across to the port.

The JAX side hands over ``jax.tree_util.tree_map(np.asarray, params)``: a
nested dict of NumPy arrays (bfloat16 leaves come as the ``ml_dtypes``
bfloat16 dtype, which this module reads by name and never imports). The
port's tree keeps the reference's key paths and shapes exactly, so the
conversion is a plain map, checked leaf by leaf against
``abstract_params``, whose structure it keeps: int8 layer stacks, the
per-group ``layers_scale`` tree with its ``None`` entries, MoE expert
stacks and the Mamba and RWKV leaves carry across like any other.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    resolve_device,
    tree_leaves_with_path,
    tree_map_with_path,
)
from repro_torch.models.model import abstract_params


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)   # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Any, cfg: ModelConfig, device=None) -> Any:
    """The port's parameter tree for ``cfg`` from a JAX tree of NumPy
    arrays, on ``device`` (default: the card). Raises ``ValueError`` on
    any difference of key paths, shapes or dtypes from
    ``abstract_params(cfg)``."""
    device = resolve_device(device)
    abstract = abstract_params(cfg)
    want = dict(tree_leaves_with_path(abstract))
    got = dict(tree_leaves_with_path(tree))
    if set(got) != set(want):
        raise ValueError(
            f"key paths differ: missing {sorted(set(want) - set(got))}, "
            f"unexpected {sorted(set(got) - set(want))}")

    def carry(path, ref):
        t = _to_tensor(got[path])
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(
                f"{'/'.join(path)}: {tuple(t.shape)} {t.dtype}, want "
                f"{tuple(ref.shape)} {ref.dtype}")
        return t.to(device)

    return tree_map_with_path(carry, abstract)
