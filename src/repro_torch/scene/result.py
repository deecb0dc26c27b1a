"""Scene-level yCHG results and their deterministic on-disk form.

A :class:`SceneResult` carries the same seven fields ``YCHGResult.to_host()``
produces for a single mask — per-column arrays of width W plus the two
scalar reductions — computed for a whole granule, however it was tiled.

The serialisation is a custom header+raw-bytes layout rather than
``np.savez`` because **byte-identity is the contract**: a bulk job killed
mid-scene and resumed must write files byte-identical to an uninterrupted
run, and zip archives embed member timestamps that would break that for
free. Here the bytes are a pure function of the content: a fixed magic, a
sorted-key JSON header (shapes, dtypes, scene metadata), then each field's
C-order buffer in a fixed field order. Writes go to a temp file in the
same directory and ``os.replace`` into place, so readers never observe a
half-written result and a kill mid-write leaves only a ``.tmp`` file.

The port's copy of ``repro.scene.result`` (NumPy only): the same magic,
header and field order, so either package's ``.ychg`` bytes for the same
content are identical.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np

_MAGIC = b"YCHGSCENE1\n"
# field order is part of the format — never reorder
FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
          "n_hyperedges", "n_transitions")


@dataclasses.dataclass(frozen=True)
class SceneResult:
    """Whole-granule yCHG output on the host, plus how it was produced."""

    granule_id: str
    height: int
    width: int
    tile_h: int
    n_tiles: int
    runs: np.ndarray           # (W,) int32
    cut_vertices: np.ndarray   # (W,) int32
    transitions: np.ndarray    # (W,) bool
    births: np.ndarray         # (W,) int32
    deaths: np.ndarray         # (W,) int32
    n_hyperedges: np.ndarray   # ()   int32
    n_transitions: np.ndarray  # ()   int32

    def to_host(self) -> Dict[str, np.ndarray]:
        """The ``YCHGResult.to_host()``-shaped dict for parity checks."""
        return {f: getattr(self, f) for f in FIELDS}

    def to_bytes(self) -> bytes:
        header = {
            "granule_id": self.granule_id,
            "height": self.height,
            "width": self.width,
            "tile_h": self.tile_h,
            "n_tiles": self.n_tiles,
            "fields": {
                f: {"shape": list(getattr(self, f).shape),
                    "dtype": str(getattr(self, f).dtype)}
                for f in FIELDS
            },
        }
        head = json.dumps(header, sort_keys=True,
                          separators=(",", ":")).encode()
        parts = [_MAGIC, len(head).to_bytes(8, "little"), head]
        for f in FIELDS:
            parts.append(np.ascontiguousarray(getattr(self, f)).tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "SceneResult":
        if blob[: len(_MAGIC)] != _MAGIC:
            raise ValueError("not a scene result file (bad magic)")
        off = len(_MAGIC)
        head_len = int.from_bytes(blob[off: off + 8], "little")
        off += 8
        header = json.loads(blob[off: off + head_len])
        off += head_len
        arrays = {}
        for f in FIELDS:
            meta = header["fields"][f]
            dt = np.dtype(meta["dtype"])
            shape = tuple(meta["shape"])
            n = dt.itemsize * int(np.prod(shape, dtype=np.int64)) \
                if shape else dt.itemsize
            arrays[f] = np.frombuffer(
                blob[off: off + n], dtype=dt).reshape(shape).copy()
            off += n
        if off != len(blob):
            raise ValueError(
                f"scene result file has {len(blob) - off} trailing bytes")
        return cls(granule_id=header["granule_id"], height=header["height"],
                   width=header["width"], tile_h=header["tile_h"],
                   n_tiles=header["n_tiles"], **arrays)


def write_scene_result(path: str, result: SceneResult) -> str:
    """Atomic write (temp + rename); returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(result.to_bytes())
    os.replace(tmp, path)
    return path


def read_scene_result(path: str) -> SceneResult:
    with open(path, "rb") as f:
        return SceneResult.from_bytes(f.read())
