"""Small sizes of each cell, at which a run on the CPU takes a second or
two: the overrides ``harness.run_cell`` merges into the cell's files."""

from __future__ import annotations

import copy

SERVE_CONFIG = {"service": {"bucket_sides": [32, 64, 128]}}

SMALL = {
    "serve8k.open": {
        "workload": {"params": {"res": 100, "pool": 2, "patch": 16,
                                "buffers": 24, "rate": 60.0, "clients": 4,
                                "warm_seconds": 0.1, "sample": 6}},
        "config": SERVE_CONFIG},
    "serve8k.closed": {
        "workload": {"params": {"res": 100, "pool": 2, "patch": 16,
                                "buffers": 4, "clients": 4,
                                "warm_seconds": 0.1, "sample": 6}},
        "config": SERVE_CONFIG},
    "scene21k.bulk": {
        "workload": {"params": {"res": 200, "hyperedges": 100,
                                "granules": 6}},
        "config": {"bulk": {"tile_h": 32}}},
}
SECONDS = 0.4


def small(cell: str) -> dict:
    return copy.deepcopy(SMALL[cell])

