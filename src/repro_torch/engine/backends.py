"""The port's backends, self-registered on import.

Each ``run(imgs, config)`` maps a (B, H, W) tensor stack to the op's
batched summary, bit-identical to the op's reference (``engine.ops``).

  op       name   runs on     auto-picked on
  ychg     torch  cpu, cuda   cpu (the plain reference, counterpart of ``jax``)
  ychg     fused  cuda, cpu*  cuda (the hand-written CUDA kernels)
  ccl      torch  cpu, cuda   cpu (``kernels.ccl.labels``)
  ccl      cuda   cuda, cpu*  cuda (``csrc/ccl.cu``, then ``_canonicalize``)
  denoise  torch  cpu, cuda   cpu (``kernels.denoise.denoise``)
  denoise  cuda   cuda, cpu*  cuda (``csrc/denoise.cu``)

  * on a CPU tensor a kernel backend runs its kernels' plain versions, as
    the JAX package's kernel backends run in interpret mode off the TPU:
    exact, not fast. ``cuda`` is the counterpart of the JAX package's
    ``pallas`` backend of ``ccl`` and ``denoise``.

None claims ``supports_mesh`` yet: the port has no mesh path, and
``EngineConfig.mesh_axis`` is kept only so JAX configs map over.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core import ychg
from repro_torch.core.ychg import YCHGSummary
from repro_torch.engine.registry import BackendSpec, register_backend
from repro_torch.kernels import ccl as kccl
from repro_torch.kernels import denoise as kdenoise
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

def _run_ccl_torch(imgs, config: "EngineConfig") -> kccl.CCLSummary:
    return kccl.labels(imgs)


def _run_ccl_cuda(imgs, config: "EngineConfig") -> kccl.CCLSummary:
    return kccl.labels_kernel(imgs)


def _run_denoise_torch(imgs, config: "EngineConfig"
                       ) -> kdenoise.DenoiseSummary:
    return kdenoise.denoise(imgs)


def _run_denoise_cuda(imgs, config: "EngineConfig"
                      ) -> kdenoise.DenoiseSummary:
    return kdenoise.denoise_kernel(imgs)


for _op, _torch, _cuda in [("ccl", _run_ccl_torch, _run_ccl_cuda),
                           ("denoise", _run_denoise_torch, _run_denoise_cuda)]:
    register_backend(BackendSpec(
        op=_op, name="torch", run=_torch, supports_batch=True,
        supports_mesh=False, device_kinds=("cpu", "cuda"),
        priority={"cpu": 100, "cuda": 50},
    ))
    register_backend(BackendSpec(
        op=_op, name="cuda", run=_cuda, supports_batch=True,
        supports_mesh=False, device_kinds=("cuda", "cpu"),
        priority={"cuda": 100, "cpu": 40},
    ))
