"""Granule sources and the tile-row windowing reader.

A *granule* is one arbitrarily large (H, W) binary scene — a whole MODIS
snow-cover grid, not a service-sized mask. :class:`GranuleReader` windows
it into **overlap-free full-width tile rows** (horizontal strips of
``tile_h`` rows; the last strip is zero-padded at the bottom so every tile
the engine sees has the same static shape — pad rows below a column add no
rising edge, so they are inert to yCHG). Strips deliberately do NOT
overlap: the run that crosses a strip boundary is reconciled exactly by
the seam correction in :mod:`repro_torch.scene.runner`, the same
row-above identity the split-H kernels apply between their H segments,
lifted to scene scale.

Two backing stores, one read API:

  * ``kind="synthetic"`` — :func:`repro_torch.data.scenes.scene_rows`, a pure
    function of (seed, row window): nothing is ever materialised beyond
    the strip being read, so a synthetic granule can be any size;
  * ``kind="memmap"`` — a ``.npy`` file opened with ``mmap_mode="r"``:
    the OS pages in only the rows a strip touches.

``GranuleSpec`` is a frozen, JSON-serialisable description, so a bulk-job
manifest is just a list of specs (``manifest_to_json`` / ``manifest_from_json``).

The port's copy of ``repro.scene.granule`` (NumPy only): a manifest written
by either package reads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data import scenes


@dataclasses.dataclass(frozen=True)
class GranuleSpec:
    """One granule of a bulk-job manifest (frozen, JSON round-trippable)."""

    granule_id: str
    height: int
    width: int
    kind: str = "synthetic"          # "synthetic" | "memmap"
    path: Optional[str] = None       # .npy path for kind="memmap"
    seed: int = 0                    # synthetic content knobs
    cell: int = 64
    coverage: float = 0.45
    dtype: str = "uint8"

    def __post_init__(self):
        if self.height < 1 or self.width < 1:
            raise ValueError(
                f"granule {self.granule_id!r}: size {self.height}x"
                f"{self.width} must be >= 1x1")
        if self.kind not in ("synthetic", "memmap"):
            raise ValueError(f"unknown granule kind {self.kind!r}")
        if self.kind == "memmap" and not self.path:
            raise ValueError(
                f"granule {self.granule_id!r}: kind='memmap' needs a path")

    @property
    def pixels(self) -> int:
        return self.height * self.width


def manifest_to_json(manifest: Sequence[GranuleSpec]) -> str:
    return json.dumps([dataclasses.asdict(s) for s in manifest], indent=2)


def manifest_from_json(text: str) -> List[GranuleSpec]:
    return [GranuleSpec(**obj) for obj in json.loads(text)]


def synthetic_manifest(n_granules: int, height: int, width: int, *,
                       seed: int = 0, cell: int = 64,
                       coverage: float = 0.45) -> List[GranuleSpec]:
    """N same-sized synthetic granules with distinct content seeds."""
    return [
        GranuleSpec(granule_id=f"granule_{seed + i:04d}", height=height,
                    width=width, seed=seed + i, cell=cell, coverage=coverage)
        for i in range(n_granules)
    ]


class GranuleReader:
    """Windows one granule into (tile_h, W) strips, read on demand.

    ``read_stack(t0, n)`` returns strips ``[t0, t0+n)`` as one
    ``(n, tile_h, W)`` host array ready for ``engine.analyze_batch`` —
    the scene runner's unit of device work. Only the requested rows are
    touched, whatever the granule's total size.
    """

    def __init__(self, source: Any, tile_h: int, *,
                 granule_id: str = "granule"):
        if tile_h < 1:
            raise ValueError(f"tile_h must be >= 1, got {tile_h}")
        self._source = source
        self.tile_h = tile_h
        self.granule_id = granule_id
        self.height, self.width = source.shape if hasattr(source, "shape") \
            else (source.height, source.width)
        if self.height < 1 or self.width < 1:
            raise ValueError(
                f"scene must be >= 1x1, got {self.height}x{self.width}")
        self.n_tiles = -(-self.height // tile_h)

    # ------------------------------------------------------------- builders

    @classmethod
    def from_array(cls, arr: np.ndarray, tile_h: int, *,
                   granule_id: str = "granule") -> "GranuleReader":
        if arr.ndim != 2:
            raise ValueError(f"expected an (H, W) scene, got {arr.shape}")
        return cls(arr, tile_h, granule_id=granule_id)

    @classmethod
    def from_npy(cls, path: str, tile_h: int, *,
                 granule_id: Optional[str] = None) -> "GranuleReader":
        """Memory-mapped .npy scene: strips page in on read, never whole."""
        arr = np.load(path, mmap_mode="r")
        if arr.ndim != 2:
            raise ValueError(f"{path}: expected an (H, W) scene, "
                             f"got {arr.shape}")
        return cls(arr, tile_h, granule_id=granule_id or path)

    @classmethod
    def open(cls, spec: GranuleSpec, tile_h: int) -> "GranuleReader":
        if spec.kind == "memmap":
            reader = cls.from_npy(spec.path, tile_h,
                                  granule_id=spec.granule_id)
            if (reader.height, reader.width) != (spec.height, spec.width):
                raise ValueError(
                    f"granule {spec.granule_id!r}: {spec.path} is "
                    f"{reader.height}x{reader.width}, manifest says "
                    f"{spec.height}x{spec.width}")
            return reader
        return cls(_SyntheticSource(spec), tile_h,
                   granule_id=spec.granule_id)

    # -------------------------------------------------------------- reading

    def tile_rows(self, t: int) -> Tuple[int, int]:
        """Real scene rows [row0, row1) covered by strip ``t``."""
        if not 0 <= t < self.n_tiles:
            raise IndexError(f"tile {t} out of range [0, {self.n_tiles})")
        row0 = t * self.tile_h
        return row0, min(row0 + self.tile_h, self.height)

    def read_tile(self, t: int) -> np.ndarray:
        """Strip ``t`` as a (tile_h, W) array (last strip zero-padded)."""
        row0, row1 = self.tile_rows(t)
        rows = np.asarray(self._read_rows(row0, row1))
        if row1 - row0 == self.tile_h:
            return rows
        out = np.zeros((self.tile_h, self.width), rows.dtype)
        out[: row1 - row0] = rows
        return out

    def read_stack(self, t0: int, n: int) -> np.ndarray:
        """Strips [t0, t0+n) as one contiguous (n, tile_h, W) stack."""
        if n < 1 or t0 < 0 or t0 + n > self.n_tiles:
            raise IndexError(
                f"stack [{t0}, {t0 + n}) out of range [0, {self.n_tiles})")
        row0 = t0 * self.tile_h
        row1 = min(row0 + n * self.tile_h, self.height)
        rows = np.asarray(self._read_rows(row0, row1))
        stack = np.zeros((n, self.tile_h, self.width), rows.dtype)
        flat = stack.reshape(n * self.tile_h, self.width)
        flat[: row1 - row0] = rows
        return stack

    def _read_rows(self, row0: int, row1: int) -> np.ndarray:
        if hasattr(self._source, "read_rows"):
            return self._source.read_rows(row0, row1)
        return self._source[row0:row1]


class _SyntheticSource:
    """Row-window view over :func:`repro_torch.data.scenes.scene_rows`."""

    def __init__(self, spec: GranuleSpec):
        self.spec = spec
        self.height = spec.height
        self.width = spec.width

    def read_rows(self, row0: int, row1: int) -> np.ndarray:
        s = self.spec
        return scenes.scene_rows(
            s.height, s.width, row0, row1, seed=s.seed, cell=s.cell,
            coverage=s.coverage, dtype=np.dtype(s.dtype))
