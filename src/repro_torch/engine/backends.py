"""The port's backends, self-registered on import.

Each ``run(imgs, config)`` maps a (B, H, W) tensor stack to the op's
batched summary, bit-identical to the op's reference (``engine.ops``).

  op       name    batch  runs on     auto-picked on
  ychg     torch   yes    cpu, cuda   cpu (the plain reference, counterpart
                                      of ``jax``)
  ychg     fused   yes    cuda, cpu*  cuda (one launch for the whole stack)
  ychg     cuda    no     cuda, cpu*  - (the paper's two kernels, two
                                      launches an image, one host call a
                                      stack; explicit only)
  ychg     serial  no     cpu         - (the paper's NumPy CPU baseline)
  ychg     scalar  no     cpu         - (per-pixel loops; tiny images only)
  ccl      torch   yes    cpu, cuda   cpu (``kernels.ccl.labels``)
  ccl      cuda    yes    cuda, cpu*  cuda (``csrc/ccl.cu``, then
                                      ``_canonicalize``)
  denoise  torch   yes    cpu, cuda   cpu (``kernels.denoise.denoise``)
  denoise  cuda    yes    cuda, cpu*  cuda (``csrc/denoise.cu``)

  * on a CPU tensor a kernel backend runs its kernels' plain versions, as
    the JAX package's kernel backends run in interpret mode off the TPU:
    exact, not fast. ``cuda`` is the counterpart of the JAX package's
    ``pallas`` backend of every op.

``serial`` and ``scalar`` keep NumPy's float32 subnormals as foreground,
as the JAX package's do (``core.serial``).

None claims ``supports_mesh`` yet: the port has no mesh path, and
``EngineConfig.mesh_axis`` is kept only so JAX configs map over.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from repro_torch.core import serial, ychg
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


def _run_cuda(imgs, config: "EngineConfig") -> YCHGSummary:
    """The paper's two kernels: one step-1 and one step-2 launch an image,
    as the JAX package's ``pallas`` backend makes, all from one host call
    for the stack into outputs allocated once (``kops.analyze_batch``)."""
    return YCHGSummary(**kops.analyze_batch(
        imgs,
        block_w=config.block_w,
        block_h=config.block_h,
        vmem_budget=config.stream_vmem_budget,
    ))


def _run_host(analyze: Callable) -> Callable:
    """A backend running ``analyze`` (a ``core.serial`` function) on each
    image on the host, its results stacked back onto the input's device."""

    def run(imgs, config: "EngineConfig") -> YCHGSummary:
        if imgs.shape[0] == 0:
            return ychg.analyze(imgs)
        x = imgs.cpu()
        # the JAX package hands its host backends float32 (x64 is off);
        # NumPy has no bfloat16, and float32 holds every bfloat16 exactly
        if x.dtype in (torch.float64, torch.bfloat16):
            x = x.float()
        host = x.numpy()
        dicts = [analyze(host[i]) for i in range(len(host))]
        return YCHGSummary(**{
            k: torch.from_numpy(np.stack([d[k] for d in dicts])).to(
                imgs.device)
            for k in dicts[0]})

    return run


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
register_backend(BackendSpec(
    name="cuda", run=_run_cuda, supports_batch=False, supports_mesh=False,
    device_kinds=("cuda", "cpu"),
    priority={"cuda": 60, "cpu": 20},
))
register_backend(BackendSpec(
    name="serial", run=_run_host(serial.analyze_numpy), supports_batch=False,
    supports_mesh=False, device_kinds=("cpu",),
    priority={"cpu": 10},
))
register_backend(BackendSpec(
    name="scalar", run=_run_host(serial.analyze_scalar), supports_batch=False,
    supports_mesh=False, device_kinds=("cpu",),
    priority={"cpu": 1},
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
