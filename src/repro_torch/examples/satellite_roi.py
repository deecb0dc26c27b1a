"""End-to-end satellite ROI pipeline (the paper's deployment scenario).

The port's twin of ``examples/satellite_roi.py``. Tiles of a large
MODIS-like scene flow through the data pipeline behind a single
``Engine`` built from the workload config:
  1. background prefetch of tile batches,
  2. the paper's two-step yCHG operator on the device — the engine's fused
     backend: one kernel launch per tile batch (vs two launches per image
     for the original step-1/step-2 pipeline),
  3. empty-tile filtering + anyres crop ranking for a VLM frontend,
  4. the same engine with a batch mesh attached (the visible cards, or
     the CPU with ``--device cpu``; ragged batches are padded and stripped
     inside the engine).

Run:  PYTHONPATH=src python -m repro_torch.examples.satellite_roi [--device cpu]
"""

import time

import numpy as np

from repro_torch.configs.ychg_modis import config as workload_config
from repro_torch.data import modis
from repro_torch.data.pipeline import (
    Prefetcher,
    anyres_select,
    filter_empty_tiles,
    ychg_stats,
)
from repro_torch.engine import Engine
from repro_torch.examples import parse_device
from repro_torch.kernels import ychg_fused
from repro_torch.sharding import make_batch_mesh


def tile_stream(scene: np.ndarray, tile: int):
    h, w = scene.shape
    batch = []
    for y in range(0, h - tile + 1, tile):
        for x in range(0, w - tile + 1, tile):
            batch.append(scene[y:y + tile, x:x + tile])
            if len(batch) == 8:
                yield np.stack(batch)
                batch = []
    if batch:
        yield np.stack(batch)


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    scene = modis.snowfield(1024, seed=11)
    print(f"scene {scene.shape}, coverage {scene.mean():.1%}")

    wl = workload_config()
    # force the fused single-launch path (auto picks the plain reference
    # on the CPU)
    engine = Engine(wl.engine.to_engine_config(backend="fused"),
                    device=device)
    launched = ychg_fused.LAUNCHES["ychg_fused_full"]

    t0 = time.perf_counter()
    n_tiles = n_kept = n_edges = n_batches = 0
    for batch in Prefetcher(tile_stream(scene, 128), depth=2):
        stats = ychg_stats(batch, engine=engine)  # ONE kernel launch/batch
        # filter on the stats already in hand — no second launch per batch
        kept = filter_empty_tiles(batch, stats=stats)
        n_tiles += len(batch)
        n_kept += len(kept)
        n_edges += int(stats["n_hyperedges"].sum())
        n_batches += 1
    dt = time.perf_counter() - t0
    print(f"processed {n_tiles} tiles in {dt:.2f}s "
          f"({n_tiles / dt:.1f} tiles/s on {engine.device}); kept {n_kept}, "
          f"total hyperedges {n_edges}")
    launches = ychg_fused.LAUNCHES["ychg_fused_full"] - launched
    if engine.device.type == "cuda":  # the CPU runs the plain version
        assert launches == n_batches, (launches, n_batches)
    print(f"fused kernel launches: {launches} for {n_batches} batches "
          f"(two-pass pipeline would have issued {2 * n_tiles})")

    # the same engine as a streaming operator: device-resident results per
    # batch, host copy only for the running total
    streamed = sum(
        int(r.n_hyperedges.sum())
        for r in engine.analyze_stream(tile_stream(scene, 128))
    )
    assert streamed == n_edges
    print(f"analyze_stream pass agrees: {streamed} hyperedges")

    # batch-sharded pass over the full tile stack: the fused backend with a
    # mesh attached — nothing else changes
    mesh = (make_batch_mesh(devices=["cpu"]) if engine.device.type == "cpu"
            else make_batch_mesh())
    meshed = engine.with_mesh(mesh)
    stack = np.stack([t for b in tile_stream(scene, 128) for t in b])
    sharded = meshed.analyze_batch(stack)
    assert sharded.batch_size == stack.shape[0]  # pad stripped internally
    assert int(sharded.n_hyperedges.sum()) == n_edges
    print(f"batch-sharded pass over {stack.shape[0]} tiles on a "
          f"{dict(mesh.shape)} mesh: total hyperedges "
          f"{int(sharded.n_hyperedges.sum())} (matches streaming pass)")

    # anyres: pick the 5 most structurally complex crops for the VLM frontend
    offs = anyres_select(scene, tile=256, k=5, device=device)
    print(f"anyres-selected crops (by yCHG hyperedge density): {offs}")


if __name__ == "__main__":
    main()
