"""PyTorch and CUDA port of the yConvex Hypergraph (yCHG) system.

A package of its own beside the JAX reference ``repro``, which it never
imports. Entry points run on the card unless the caller asks for the CPU.
"""
