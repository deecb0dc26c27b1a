"""A frozen reader and writer of the ``.ychg`` scene result format.

The format, as the bulk job writes it: the magic ``YCHGSCENE1\\n``; the
header's length as 8 little-endian bytes; a sorted-key, compact JSON header
(``granule_id``, ``height``, ``width``, ``tile_h``, ``n_tiles`` and, per
field, its shape and dtype); then each field's C-order bytes in the order
of ``FIELDS``, and nothing after. Written here from that description, so a
change of format in the program shows as a wrong file and not as a changed
yardstick. The writer serves the control, which stands in for the bulk job.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from bench.reference.ychg import FIELDS

MAGIC = b"YCHGSCENE1\n"


def read(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """(header, fields) of one result file; raises ValueError if the bytes
    do not follow the format."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: bad magic")
    off = len(MAGIC)
    n = int.from_bytes(blob[off:off + 8], "little")
    off += 8
    header = json.loads(blob[off:off + n])
    off += n
    fields = {}
    for name in FIELDS:
        meta = header["fields"][name]
        dt = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        size = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        fields[name] = np.frombuffer(blob[off:off + size],
                                     dt).reshape(shape).copy()
        off += size
    if off != len(blob):
        raise ValueError(f"{path}: {len(blob) - off} trailing bytes")
    return header, fields


def write(path: str, header: dict, fields: Dict[str, np.ndarray]) -> str:
    """Write ``fields`` under ``header`` (without its ``fields`` entry) in
    the format above, through a temporary file and a rename."""
    head = dict(header)
    head["fields"] = {f: {"shape": list(fields[f].shape),
                          "dtype": str(fields[f].dtype)} for f in FIELDS}
    text = json.dumps(head, sort_keys=True, separators=(",", ":")).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + len(text).to_bytes(8, "little") + text)
        for name in FIELDS:
            f.write(np.ascontiguousarray(fields[name]).tobytes())
    os.replace(tmp, path)
    return path
