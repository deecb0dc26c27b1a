"""`repro_torch.sharding` — the batch mesh the engine splits a stack over.

The port's counterpart of ``repro.sharding``'s yCHG half (``sharding/ychg.py``);
its LM half (``logical.py``) has no counterpart here.
"""

from repro_torch.sharding.ychg import (
    BATCH_AXIS,
    BatchMesh,
    batch_sharded_analyze,
    make_batch_mesh,
    pad_batch,
)

__all__ = [
    "BATCH_AXIS",
    "BatchMesh",
    "batch_sharded_analyze",
    "make_batch_mesh",
    "pad_batch",
]
