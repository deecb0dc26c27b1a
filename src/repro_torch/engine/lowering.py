"""``Engine.lower``'s artifacts: the port's counterparts of JAX's
``Lowered`` and ``Compiled`` for one (op, backend, stack shape) cell.

Nothing here allocates on the device or launches a kernel. A
:class:`Lowered` holds the cell's input and output types
(:class:`ShapeDtype`, the counterpart of ``jax.ShapeDtypeStruct``) and the
backend's plan (``kernels.plan.Plan``), all reckoned from the shape.
:meth:`Lowered.compile` builds and loads the route's CUDA sources on a CUDA
engine (nvcc at first use, cached by source hash: ``kernels._build``) and
builds nothing on a CPU engine. :class:`Compiled` answers
``cost_analysis()`` under JAX's key names, so ``launch.roofline.cost_dict``
reads either package's artifact, and ``memory_analysis()`` with JAX's
attribute names.

The reckoning is the card's route on any device: on a CPU engine the
kernel backends run their kernels' plain versions, but the plan still
says what the card would launch and allocate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.engine import ops as engine_ops
from repro_torch.kernels import _build
from repro_torch.kernels import ccl as _ccl
from repro_torch.kernels import denoise as _denoise
from repro_torch.kernels import ychg_colscan as _colscan
from repro_torch.kernels import ychg_fused as _fused
from repro_torch.kernels.plan import Plan

# CUDA source -> the ctypes signatures of its C entry points
_SIGNATURES = {"ychg_fused": _fused._SIGNATURES,
               "ychg_colscan": _colscan._SIGNATURES,
               "ccl": _ccl._SIGNATURES,
               "denoise": _denoise._SIGNATURES}


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype, with no storage."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """The counterpart of XLA's ``CompiledMemoryStats`` for one cell:
    the stack's bytes, the result's, and what the wrappers and the ops
    around the kernels allocate beside the result (None where the route's
    tensors are not reckoned: the plain ``torch`` backends)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: Optional[int]


class Lowered:
    """One cell lowered for an abstract stack: its types and its plan."""

    def __init__(self, *, op: str, backend: str, in_info: ShapeDtype,
                 out_info: Any, plan: Plan, device: torch.device):
        self.op = op
        self.backend = backend
        self.in_info = in_info
        self.out_info = out_info
        self.plan = plan
        self.device = device

    @property
    def route(self) -> Optional[str]:
        """``full`` or ``splith`` for the ychg kernel backends, else None."""
        return self.plan.route

    def compile(self) -> "Compiled":
        """Build and load the route's CUDA sources on a CUDA engine (nothing
        on a CPU engine); launches nothing, allocates nothing on the
        device."""
        seconds: Dict[str, float] = {}
        if self.device.type == "cuda" and self.plan.sources:
            seconds = _build.build(self.plan.sources)
            for name in self.plan.sources:
                _build.load(name, _SIGNATURES[name])
        return Compiled(self, seconds)


class Compiled:
    """A lowered cell whose kernels are built; its cost and memory."""

    def __init__(self, lowered: Lowered, build_seconds: Dict[str, float]):
        self.lowered = lowered
        self.in_info = lowered.in_info
        self.out_info = lowered.out_info
        self.backend = lowered.backend
        self.route = lowered.route
        # source -> nvcc seconds in this compile (0.0: built before)
        self.build_seconds = build_seconds

    def cost_analysis(self) -> Dict[str, Any]:
        """``bytes accessed``: every launch's kernel bytes (each kernel's
        bound bytes, ``launch.roofline``) plus ``op bytes``, what the
        PyTorch ops around the kernels read and write; ``flops``: the
        operations of the same reckoning, of type ``operation`` (int32 for
        ychg and ccl, float32 for denoise); ``launches``: kernel -> count
        on the card's route."""
        p = self.lowered.plan
        return {
            "bytes accessed": float(p.kernel_bytes + p.op_bytes),
            "flops": float(p.kernel_ops + p.op_ops),
            "kernel bytes": p.kernel_bytes,
            "op bytes": p.op_bytes,
            "operation": p.operation,
            "launches": dict(p.launches),
        }

    def memory_analysis(self) -> MemoryAnalysis:
        out = sum(getattr(self.out_info, f).nbytes
                  for f in engine_ops.get_op(self.lowered.op).fields)
        return MemoryAnalysis(
            argument_size_in_bytes=self.in_info.nbytes,
            output_size_in_bytes=out,
            temp_size_in_bytes=self.lowered.plan.temp_bytes())
