"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and ``ops.analyze_fused`` over them. Importing builds nothing."""
