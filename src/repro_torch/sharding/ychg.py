"""Batch mesh for yCHG stacks + the deprecated ``batch_sharded_analyze`` shim.

The port's counterpart of ``repro.sharding.ychg``. The split itself lives in
the engine: ``Engine(cfg, mesh=mesh)`` pads a stack with blank images (zero
runs, zero hyperedges: inert end to end) to a multiple of the mesh size,
runs one chunk on each mesh device and gathers the fields back onto its own
device without the pad (``repro_torch.engine.engine.Engine._run_meshed``),
so callers never see padded-length results.

A :class:`BatchMesh` holds the two things the engine reads from a JAX
``Mesh``: its axis names and its size along the batch axis.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.ychg import YCHGSummary

Tensor = torch.Tensor

BATCH_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh: an ordered tuple of torch devices along one named axis.

    A device may appear more than once: the stack is then cut into as many
    chunks as there are entries, and a device listed twice runs two of them
    in turn. That exercises the split on one card, or on the CPU. The
    ``repr`` names each device as ``str(device)``, so it is the same in
    every process: it enters the service's cache keys.
    """

    devices: Tuple[torch.device, ...]
    axis_name: str = BATCH_AXIS

    def __post_init__(self):
        devices = tuple(_normalise(d) for d in self.devices)
        if not devices:
            raise ValueError("a BatchMesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        names = tuple(str(d) for d in self.devices)
        return f"BatchMesh(axis_name={self.axis_name!r}, devices={names!r})"


def _normalise(device: Any) -> torch.device:
    """``torch.device(device)``, with a CUDA device that names no index
    pinned to the current one, so equal meshes compare and render equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_batch_mesh(axis_name: str = BATCH_AXIS,
                    devices: Optional[Sequence[Any]] = None) -> BatchMesh:
    """1-D mesh over every visible CUDA device, or over ``devices``.

    With ``devices=None`` the mesh covers ``cuda:0`` to ``cuda:N-1`` and
    raises when no CUDA device is visible: there is no CPU fallback. The
    CPU enters a mesh only when listed, for example ``devices=["cpu"] * 3``
    (an explicit list may name one device several times; see
    :class:`BatchMesh`).
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_batch_mesh() covers the visible CUDA devices and this "
                "process sees none; list devices explicitly (for example "
                "devices=['cpu']) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    return BatchMesh(tuple(devices), axis_name)


def pad_batch(imgs: Tensor, multiple: int) -> Tuple[Tensor, int]:
    """Pad the leading batch dim with blank images to a multiple; returns
    (padded stack, original batch size). Blank images contribute zero runs
    and zero hyperedges, so the padding is inert end to end."""
    b = imgs.shape[0]
    pad = -b % multiple
    if pad:
        blank = torch.zeros((pad, *imgs.shape[1:]), dtype=imgs.dtype,
                            device=imgs.device)
        imgs = torch.cat([imgs, blank])
    return imgs, b


def batch_sharded_analyze(
    imgs: Any,
    *,
    mesh: Optional[BatchMesh] = None,
    axis_name: str = BATCH_AXIS,
    block_w: int = 128,
    block_h: int = 2048,
) -> YCHGSummary:
    """DEPRECATED: use ``Engine(cfg, mesh=mesh).analyze_batch(imgs)``.

    (B, H, W) stack -> YCHGSummary, batch-split over the mesh (by default
    every visible CUDA device); bit-identical to ``core.ychg.analyze`` on
    the same stack. The engine runs on the mesh's first device.
    """
    warnings.warn(
        "repro_torch.sharding.batch_sharded_analyze is deprecated; use "
        "repro_torch.engine.Engine(EngineConfig(backend='fused'), "
        "mesh=mesh).analyze_batch(imgs)",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.engine import Engine, EngineConfig

    mesh = make_batch_mesh(axis_name) if mesh is None else mesh
    engine = Engine(
        EngineConfig(backend="fused", block_w=block_w, block_h=block_h,
                     mesh_axis=axis_name),
        mesh=mesh, device=mesh.devices[0],
    )
    return engine.analyze_batch(imgs).to_summary()
