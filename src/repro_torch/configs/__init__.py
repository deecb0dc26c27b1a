"""Workload configurations: the LM architectures (``base``, ``archs`` and
one file an architecture, copies of ``repro.configs``) and the paper's
yCHG workload (``ychg_modis``)."""

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    LayerSpec,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    shapes_for,
)

__all__ = [
    "ALL_SHAPES",
    "DECODE_32K",
    "LONG_500K",
    "PREFILL_32K",
    "TRAIN_4K",
    "LayerSpec",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "list_archs",
    "shapes_for",
]
