"""The paper's own workload: yCHG over MODIS-like scenes.

The port's counterpart of ``repro.configs.ychg_modis``. Knobs mirror the
poster's experiments: resolution series up to the 21000x21000 scene (knob
a) and hyperedge series 147 -> 4,124,319 (knob b). The ``engine`` section is
how this workload constructs its engine:
``Engine(config().engine.to_engine_config())``.

:func:`engine_config_from_jax` carries a JAX engine configuration across,
so the two packages can run under one policy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

# JAX-only knobs with no meaning on Hopper: dropped when carried across
_JAX_ONLY_FIELDS = frozenset({"interpret"})


@dataclasses.dataclass(frozen=True)
class EngineSection:
    """Mirror of ``repro_torch.engine.EngineConfig`` inside the workload
    config, kept as plain data so configs import without torch."""

    backend: str = "auto"              # registry-resolved per device type
    block_w: int = 128                 # enters the split-H routing rule
    block_h: int = 2048                # split-H kernel row segment
    dtype: Optional[str] = None        # cast masks on ingest (None = as-is)
    mesh_axis: str = "data"            # batch axis when a mesh is attached
    stream_vmem_budget: int = 4 * 1024 * 1024

    def to_engine_config(self, **overrides: Any):
        """Materialise as a ``repro_torch.engine.EngineConfig``."""
        from repro_torch.engine import EngineConfig

        kw = dataclasses.asdict(self)
        kw.update(overrides)
        return EngineConfig(**kw)


def engine_config_from_jax(d: Mapping[str, Any]):
    """The port's ``EngineConfig`` from ``dataclasses.asdict`` of a JAX
    ``YCHGConfig`` or ``EngineSection``.

    ``interpret`` is dropped; any other field the port does not know raises
    ``ValueError``, so a JAX knob is never silently ignored.
    """
    from repro_torch.engine import EngineConfig

    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(d) - known - _JAX_ONLY_FIELDS)
    if unknown:
        raise ValueError(f"unknown engine config fields {unknown}; the port "
                         f"knows {sorted(known)}")
    return EngineConfig(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class YCHGWorkloadConfig:
    name: str = "ychg-modis"
    resolutions: Tuple[int, ...] = (250, 500, 1000, 2000, 4000, 8000, 12000, 21000)
    hyperedge_series: Tuple[int, ...] = (
        147, 1_000, 10_000, 100_000, 1_000_000, 4_124_319
    )
    hyperedge_resolution: int = 8192   # fixed resolution for knob (b)
    batch: int = 8                     # tiles per device batch
    engine: EngineSection = EngineSection()
    backends: Tuple[str, ...] = ("scalar", "serial", "torch", "cuda", "fused")

    # legacy flat tile knobs, kept as views of the engine section
    @property
    def block_w(self) -> int:
        return self.engine.block_w

    @property
    def block_h(self) -> int:
        return self.engine.block_h


def config() -> YCHGWorkloadConfig:
    return YCHGWorkloadConfig()
