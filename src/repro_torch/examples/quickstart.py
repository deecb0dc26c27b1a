"""Quickstart: the paper's two-step yCHG algorithm on a synthetic scene.

The port's twin of ``examples/quickstart.py``. The canonical entry point
is ``repro_torch.engine.Engine``: one engine, every backend,
device-resident results. ``backend="auto"`` resolves from the registry
(the fused single-launch CUDA kernel on the card, the plain PyTorch
reference on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import numpy as np

from repro_torch.core import regions
from repro_torch.data import modis
from repro_torch.engine import Engine, EngineConfig
from repro_torch.examples import parse_device
from repro_torch.service import ServiceConfig, YCHGService


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    # A MODIS-like snow-cover mask (the paper's dataset, synthesised offline)
    img = modis.snowfield(512, seed=7)
    print(f"scene: {img.shape}, coverage {img.mean():.1%}")

    # Step 1 + 2 on the device: one engine call, result stays on the device
    engine = Engine(device=device)  # backend="auto"
    result = engine.analyze(img)
    print(f"engine dispatched to backend={engine.resolve_backend()!r} on "
          f"{engine.device}")
    out = result.to_host()  # host copy only where the example prints
    print(f"step 1: cut-vertex counts per column — max runs "
          f"{out['runs'].max()}, mean {out['runs'].mean():.1f}")
    print(f"step 2: {out['n_transitions']} transition columns, "
          f"{out['n_hyperedges']} yConvex hyperedges")

    # Paper's serial baseline agrees exactly (same engine API, host backend)
    ser = Engine(EngineConfig(backend="serial"),
                 device=device).analyze(img).to_host()
    assert np.array_equal(out["runs"], ser["runs"])
    print("serial baseline agrees exactly")

    # Beyond the poster: materialise the decomposition
    edges = regions.decompose(img)
    biggest = max(edges, key=lambda e: e.area)
    print(f"materialised {len(edges)} y-convex pieces; largest spans "
          f"cols {biggest.col_span} area {biggest.area}px "
          f"(total area {regions.total_area(img)}px)")

    # Serving: the same computation behind the production front end.
    # YCHGService micro-batches single-mask requests into shape-bucketed
    # stacks on a shared engine and caches results by content: a repeated
    # mask is served from the cache without touching any backend.
    cfg = ServiceConfig(bucket_sides=(512,), max_batch=4,
                        max_queue_depth=64, overload_policy="block")
    with YCHGService(engine, cfg) as svc:
        fresh = svc.analyze(img)            # computed (same result as above)
        repeat = svc.analyze(img.copy())    # same bytes -> cache hit
        assert repeat is fresh              # the cached object itself
        assert np.array_equal(fresh.n_hyperedges.cpu().numpy(),
                              [out["n_hyperedges"]])
        m = svc.metrics()
        print(f"service: {m.completed} served "
              f"({m.completed_from_cache} from cache) on "
              f"backend={m.backend!r}, hit rate {m.hit_rate:.0%}, "
              f"p95 {m.p95_latency_ms:.1f}ms, "
              f"dispatched shapes {m.compiled_shapes}, "
              f"shed {m.shed} / blocked {m.blocked}")


if __name__ == "__main__":
    main()
