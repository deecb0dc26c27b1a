"""Host data pipeline: background prefetch + the yCHG preprocessing operator.

The port's counterpart of ``repro.data.pipeline``. Mask tiles flow through
``ychg_stats`` (the two-step algorithm on the device, one engine call a
batch) and the per-tile ROI statistics drive (a) filtering: empty tiles
are dropped before they reach a model, and (b) anyres tile selection for
a VLM frontend: tiles are ranked by hyperedge density (boundary
complexity), a cheap O(HW) proxy for "interesting structure".

``Prefetcher`` is a copy of the JAX package's. Its thread only pulls
host batches; the engine runs in the caller's thread, as in the JAX
package. Results come back as NumPy arrays (``.cpu().numpy()``).
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import TYPE_CHECKING, Any, Dict, Iterator, List, Optional

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.engine import Engine


class Prefetcher:
    """Runs an iterator in a background thread with a bounded queue.

    Straggler note: on a real cluster the get() timeout is the per-step
    data deadline; a timeout surfaces as StopIteration + a counter that the
    caller reports rather than a hang.
    """

    def __init__(self, it: Iterator, depth: int = 2, timeout: float = 300.0):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.timeout = timeout
        self._done = object()
        self.timeouts = 0

        def run():
            try:
                for item in it:
                    self.q.put(item)
            finally:
                self.q.put(self._done)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self.q.get(timeout=self.timeout)
        except queue.Empty:
            self.timeouts += 1
            raise StopIteration
        if item is self._done:
            raise StopIteration
        return item


# legacy backend names accepted by ychg_stats, mapped to engine backends
_STATS_BACKENDS = {"auto": "auto", "fused": "fused", "jnp": "torch"}


@functools.lru_cache(maxsize=None)
def _default_engine(backend: str, device: Optional[str]) -> "Engine":
    from repro_torch.engine import Engine, EngineConfig

    return Engine(EngineConfig(backend=backend), device=device)


def _host(masks: Any) -> np.ndarray:
    if isinstance(masks, torch.Tensor):
        return masks.cpu().numpy()
    return np.asarray(masks)


def ychg_stats(masks: Any, backend: str = "auto", *,
               engine: Optional["Engine"] = None,
               device: Optional[str] = None) -> Dict[str, np.ndarray]:
    """(B,H,W) uint8 -> per-tile ROI statistics via the two-step algorithm.

    Pass ``engine`` (a ``repro_torch.engine.Engine``) to control dispatch:
    the whole batch runs as one engine call under its policy (``fused`` =
    ONE kernel launch a batch). Without an engine, the legacy ``backend``
    string picks a cached default engine on ``device`` (None: the card):
    "auto" resolves per device type (``fused`` on the card, ``torch`` on
    the CPU), "fused"/"jnp" force the fused kernel or the plain reference.
    All are bit-identical.
    """
    if engine is None:
        try:
            engine = _default_engine(_STATS_BACKENDS[backend], device)
        except KeyError:
            raise ValueError(
                f"unknown backend {backend!r}; expected 'auto', 'fused', or 'jnp'"
            ) from None
    s = engine.analyze_batch(masks)
    return {
        "n_hyperedges": s.n_hyperedges.cpu().numpy(),
        "n_transitions": s.n_transitions.cpu().numpy(),
        "coverage": _host(masks).mean(axis=(-1, -2)),
    }


def filter_empty_tiles(masks: Any, min_hyperedges: int = 1,
                       backend: str = "auto",
                       stats: Optional[Dict[str, np.ndarray]] = None,
                       engine: Optional["Engine"] = None, *,
                       device: Optional[str] = None) -> Any:
    """Drop tiles whose ROI has no hyperedges (paper's step 1+2 as a filter).

    Pass ``stats`` (a prior ``ychg_stats`` result for the same masks) to
    filter without recomputing: callers that already ran the operator for
    ranking should not pay a second kernel launch."""
    if stats is None:
        stats = ychg_stats(masks, backend=backend, engine=engine,
                           device=device)
    keep = stats["n_hyperedges"] >= min_hyperedges
    if isinstance(masks, torch.Tensor):
        return masks[torch.from_numpy(keep).to(masks.device)]
    return masks[keep]


def anyres_select(image: Any, tile: int, k: int, *,
                  engine: Optional["Engine"] = None,
                  device: Optional[str] = None) -> List[tuple]:
    """llava-next anyres: split image into (tile x tile) crops, return the k
    crop offsets with the highest yCHG hyperedge density (boundary-complexity
    ranking). Returns [(y, x), ...]."""
    image = _host(image)
    h, w = image.shape
    ys = range(0, h - tile + 1, tile)
    xs = range(0, w - tile + 1, tile)
    crops, offs = [], []
    for y in ys:
        for x in xs:
            crops.append(image[y : y + tile, x : x + tile])
            offs.append((y, x))
    if not crops:
        return [(0, 0)]
    stats = ychg_stats(np.stack(crops), engine=engine, device=device)
    order = np.argsort(-stats["n_hyperedges"])
    return [offs[i] for i in order[:k]]
