"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and ``ops.analyze_fused`` over them. Importing builds nothing:
nvcc runs at a kernel's first launch (``kernels._build``)."""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import analyze_fused

__all__ = ["ops", "ref", "analyze_fused"]
