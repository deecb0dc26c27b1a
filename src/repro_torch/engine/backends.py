"""The port's ``ychg`` backends, self-registered on import.

Each ``run(imgs, config)`` maps a (B, H, W) tensor stack to a batched
``core.ychg.YCHGSummary`` bit-identical to ``core.ychg.analyze``.

  name   batch  runs on     auto-picked on
  torch  yes    cpu, cuda   cpu (the plain reference, counterpart of ``jax``)
  fused  yes    cuda, cpu*  cuda (the hand-written CUDA kernels)

  * on a CPU tensor ``fused`` runs its kernels' plain versions, as the JAX
    package's ``fused`` runs in interpret mode off the TPU: exact, not fast.

Neither claims ``supports_mesh`` yet: the port has no mesh path, and
``EngineConfig.mesh_axis`` is kept only so JAX configs map over.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core import ychg
from repro_torch.core.ychg import YCHGSummary
from repro_torch.engine.registry import BackendSpec, register_backend
from repro_torch.kernels import ops as kops

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.engine.engine import EngineConfig


def _run_torch(imgs, config: "EngineConfig") -> YCHGSummary:
    return ychg.analyze(imgs)


def _run_fused(imgs, config: "EngineConfig") -> YCHGSummary:
    return kops.analyze_fused(
        imgs,
        block_w=config.block_w,
        block_h=config.block_h,
        vmem_budget=config.stream_vmem_budget,
    )


register_backend(BackendSpec(
    name="torch", run=_run_torch, supports_batch=True, supports_mesh=False,
    device_kinds=("cpu", "cuda"),
    priority={"cpu": 100, "cuda": 50},
))
register_backend(BackendSpec(
    name="fused", run=_run_fused, supports_batch=True, supports_mesh=False,
    device_kinds=("cuda", "cpu"),
    priority={"cuda": 100, "cpu": 40},
))
