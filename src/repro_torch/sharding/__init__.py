"""`repro_torch.sharding` — logical-axis sharding rules for the LM substrate
and the batch mesh the engine splits a yCHG stack over.

The port's counterpart of ``repro.sharding``: ``logical.py`` (rule tables,
``spec_for``, tree shardings; ``AbstractMesh``, DTensor ``placements`` and
``place`` beside them) and ``ychg.py``.
"""

from repro_torch.sharding.logical import (
    TRAIN_RULES,
    DECODE_RULES,
    AbstractMesh,
    NamedSharding,
    PartitionSpec,
    make_rules,
    spec_for,
    param_shardings,
    place,
    placements,
    tree_shardings,
)
from repro_torch.sharding.ychg import (
    BATCH_AXIS,
    BatchMesh,
    batch_sharded_analyze,
    make_batch_mesh,
    pad_batch,
)

__all__ = [
    "TRAIN_RULES",
    "DECODE_RULES",
    "AbstractMesh",
    "NamedSharding",
    "PartitionSpec",
    "make_rules",
    "spec_for",
    "param_shardings",
    "place",
    "placements",
    "tree_shardings",
    "BATCH_AXIS",
    "BatchMesh",
    "batch_sharded_analyze",
    "make_batch_mesh",
    "pad_batch",
]
