"""The paper's contribution: data-parallel yConvex Hypergraph construction.

The port's counterpart of ``repro.core``. Two-step structure, exactly as
in the poster:
  step 1  column_runs / cut_vertices  — per-column maximal-run (cut-vertex) counts
  step 2  hyperedge_transitions       — neighbour-column diff -> births/deaths

`ychg` is the plain-PyTorch reference (CPU and card). `serial` is the
paper's CPU baseline (NumPy). `regions` materialises the hyperedges
(beyond-paper; the poster only counts). The JAX package's `analyze_jit`
has no counterpart (see `core.ychg`).
"""

from repro_torch.core.ychg import (
    column_runs,
    cut_vertices,
    hyperedge_transitions,
    hyperedge_count,
    analyze,
    analyze_batched,
    check_conservation,
    YCHGSummary,
)
from repro_torch.core import serial
from repro_torch.core import regions

__all__ = [
    "column_runs",
    "cut_vertices",
    "hyperedge_transitions",
    "hyperedge_count",
    "analyze",
    "analyze_batched",
    "check_conservation",
    "YCHGSummary",
    "serial",
    "regions",
]
