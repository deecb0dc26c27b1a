"""Logical-axis -> mesh-axis sharding rules (MaxText-style, with fallback).

The port's counterpart of ``repro.sharding.logical``. Every param,
activation and cache leaf carries a tuple of logical axis names (see
``models/``). A *rule table* maps logical names to mesh axis names (or
tuples for multi-axis sharding, or None). ``spec_for`` resolves a leaf to
a ``PartitionSpec`` against a mesh with the reference's guard rails:

  * mesh axes absent from the mesh are ignored (the same table works for
    the (data, model) single-pod mesh and the (pod, data, model) one);
  * a dim not divisible by its mesh-axis product *falls back* by dropping
    trailing axes until divisible (14 heads on a 16-way model axis are
    replicated, never a crash);
  * a mesh axis never appears twice in one spec (first dim wins);
  * trailing ``None`` entries are trimmed.

``spec_for`` reads only ``mesh.shape`` (axis name -> size), so it works on
a ``torch.distributed.device_mesh.DeviceMesh`` and on an ``AbstractMesh``
(axis names and sizes, no devices), which is what the dry run reckons
against. ``placements`` maps a spec onto DTensor placements, one per mesh
dimension; ``place`` distributes a tree of tensors by a tree of
``NamedSharding`` (the counterpart of ``jax.device_put(tree,
shardings)``), on a real ``DeviceMesh`` only.

Rule tables:
  TRAIN_RULES  — TP over "model" + FSDP ("embed" params over "data") +
                 batch DP over ("pod", "data").
  DECODE_RULES — TP over "model", batch over ("pod", "data"), no FSDP
                 (weights stay resident), the KV cache's sequence over
                 "model"; long-context cells override act_kv_seq and
                 act_batch through ShapeConfig.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Rule = Union[None, str, Tuple[str, ...]]

TRAIN_RULES: Dict[str, Rule] = {
    # params
    "vocab": "model",
    # FSDP axis (ZeRO-3-style 2-D weight sharding); spans pods when present
    # (400B-param optimizer state does not fit one pod's worth of chips)
    "embed": ("pod", "data"),
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "embed_out": "model",
    "experts": "model",
    "q_lora": None,
    "kv_lora": None,
    "head": None,
    "layers": None,
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_mlp": "model",
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_kv_seq": None,
    "act_vocab": "model",
}

DECODE_RULES: Dict[str, Rule] = {
    **TRAIN_RULES,
    "embed": None,            # no FSDP at inference
    # KV cache sharded along SEQUENCE over the TP axis (flash-decode style):
    # every assigned arch has kv_heads < 16, so head-sharding alone would
    # fall back to replication and a 32k cache would not fit one device.
    # Softmax over the sharded axis needs a max/sum all-reduce pair.
    "act_kv_seq": "model",
    "act_kv_heads": None,
}


def make_rules(kind: str, overrides: Optional[Dict[str, Rule]] = None
               ) -> Dict[str, Rule]:
    base = TRAIN_RULES if kind in ("train", "prefill") else DECODE_RULES
    rules = dict(base)
    if overrides:
        rules.update(overrides)
    return rules


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh-axis name, a tuple of names
    (major to minor), or ``None`` (replicated); trailing dimensions that
    are not listed are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes with no devices behind it: enough for
    ``spec_for`` and the dry run's reckoning."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size: ``mesh.shape`` where it is a mapping (an
    ``AbstractMesh``, a JAX mesh, a stub), else a ``DeviceMesh``'s
    ``mesh_dim_names`` against its tuple of sizes."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec


def _norm(rule: Rule, shape: Dict[str, int]) -> Tuple[str, ...]:
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if a in shape)


def spec_for(
    logical_axes: Sequence[Optional[str]],
    rules: Dict[str, Rule],
    mesh,
    shape: Sequence[int],
) -> PartitionSpec:
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        axes = () if name is None else _norm(rules.get(name), sizes)
        axes = tuple(a for a in axes if a not in used)
        # divisibility fallback: drop trailing axes until the dim divides
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if dim % prod == 0:
                break
            axes = axes[:-1]
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_count(spec: PartitionSpec, mesh) -> int:
    """How many pieces ``spec`` cuts a tensor into over ``mesh``."""
    sizes = mesh_shape(mesh)
    n = 1
    for entry in spec:
        for a in spec_axes(entry):
            n *= sizes[a]
    return n


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements for ``spec``, one per dimension of ``mesh``:
    ``Shard(dim)`` on each mesh dimension that splits tensor dim ``dim``,
    ``Replicate()`` elsewhere. A dim split over several mesh axes takes
    them major to minor, as GSPMD does, which DTensor does when their
    order in the spec is their order in the mesh. A mesh dimension of size
    1 splits nothing and stays ``Replicate()``: the same layout, which
    DTensor's propagation handles everywhere (torch 2.11 refuses to
    flatten two dims marked sharded, even over size-1 axes)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for a in axes:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def tree_shardings(axes_tree, rules: Dict[str, Rule], mesh, shape_tree):
    """Map (logical-axes tree, shape tree) -> NamedSharding tree. Trees are
    nested dicts (and the optimiser's ``OptState``); ``None`` is an empty
    subtree."""
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(v, rules, mesh, shape_tree[k])
                for k, v in axes_tree.items()}
    if axes_tree is None:
        return None
    return NamedSharding(mesh, spec_for(axes_tree, rules, mesh,
                                        shape_tree.shape))


def param_shardings(cfg, rules, mesh):
    from repro_torch.models import abstract_params, param_logical_axes

    return tree_shardings(param_logical_axes(cfg), rules, mesh,
                          abstract_params(cfg))


def place(tree, shardings):
    """Every tensor of ``tree`` distributed over its ``NamedSharding``'s
    mesh (``torch.distributed.tensor.distribute_tensor``, rank 0's data;
    a DTensor is redistributed): the counterpart of ``jax.device_put(tree,
    shardings)``. Each plain leaf is moved to the mesh's device type
    first. A mesh with no devices (an ``AbstractMesh``) raises
    ``TypeError``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if tree is None:
        return None
    mesh = shardings.mesh
    if isinstance(mesh, AbstractMesh):
        raise TypeError("an AbstractMesh has no devices to place a tensor "
                        "on; build a DeviceMesh (launch.mesh.make_host_mesh)")
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, placements(shardings.spec, mesh))
    t = torch.as_tensor(tree)
    if t.device.type != mesh.device_type:
        t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, placements(shardings.spec, mesh))
