"""Content-addressed LRU result cache for the image-operator service.

The key is a pure function of everything that determines the answer:

  (blake2b(mask bytes), shape, dtype, resolved backend name, engine config,
   mesh, op)

Shape and dtype are part of the key because the raw byte string does not
determine them — the same 32 bytes are a (4, 8) or an (8, 4) mask, and an
int8 view of a uint8 buffer is a different request even though the bytes
match. Backend and config are part of the key because the service promises
results identical to ``engine.analyze`` under *that* engine's policy; two
services with different policies may share one cache without ever serving
each other's entries. ``op`` is part of the key because the same mask
under a different operator (or an ordered pipeline of operators, keyed as
``"denoise+ychg"``) is a different answer entirely.

Values are device-resident results (``YCHGResult``), so a hit returns the
exact cached object — no copy, no host round-trip, and crucially no
backend invocation (``tests/test_torch_service.py`` asserts this via the
registry call counters).

A copy of ``repro.service.cache``, ``_canon`` unchanged. The config's class
name stays in the key, and the port's config class is ``EngineConfig``
where the JAX package's is ``YCHGConfig`` (and the port's has no
``interpret`` field), so JAX and torch workers never share entries, even
through one cache or a shared serialized key space.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional, Tuple

import numpy as np

CacheKey = Tuple[bytes, tuple, str, str, Any, Any, str]


def make_key(mask: np.ndarray, backend: str, config: Hashable,
             mesh: Optional[Hashable] = None, *,
             op: str = "ychg") -> CacheKey:
    """Content-address a host mask under a resolved (backend, config) policy.

    ``mask`` must be C-contiguous (the service canonicalises on submit);
    ``config`` any hashable policy object (``YCHGConfig`` is frozen);
    ``mesh`` the engine's attached device mesh, if any — a meshed engine's
    results carry a different device layout than an unmeshed one, so the
    two must never serve each other's entries through a shared cache;
    ``op`` the operator (or ``"+"``-joined pipeline spec) the entry
    answers for — the same mask under a different op is a different key.
    """
    digest = hashlib.blake2b(mask.tobytes(), digest_size=16).digest()
    return (digest, mask.shape, str(mask.dtype), backend, config, mesh, op)


def _canon(obj: Any) -> bytes:
    """A process-stable byte rendering of one key component.

    Dataclass configs (``YCHGConfig``) render as class name + sorted
    ``field=repr(value)`` pairs — reprs of str/int/float/bool/None are
    deterministic across interpreters, unlike ``hash()``. Anything else
    falls back to ``repr`` (stable for the primitives that actually appear
    in keys; an attached device mesh has no stable rendering, which is why
    fleet workers run unmeshed engines).
    """
    if obj is None:
        return b"none"
    if isinstance(obj, bytes):
        return obj
    if isinstance(obj, str):
        return obj.encode()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = sorted(
            (f.name, repr(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
        return (type(obj).__name__ + ":" +
                ",".join(f"{n}={v}" for n, v in fields)).encode()
    return repr(obj).encode()


def serialize_key(key: CacheKey) -> bytes:
    """A canonical, PROCESS-STABLE byte string for a :func:`make_key` tuple.

    The in-process tuple key relies on per-process ``hash()`` (randomised
    by PYTHONHASHSEED), so it can never cross a process boundary; this
    rendering is what the fleet router consistent-hashes on and what
    sibling caches look each other's entries up by — identical
    (mask, backend, config, op) must produce identical bytes in every
    worker, across restarts (``tests/test_fleet.py`` pins this with a
    different-PYTHONHASHSEED subprocess). Components are length-prefixed
    so no two distinct keys can collide by concatenation, and the format
    is VERSIONED: v2 added the length-prefixed ``op`` component, and the
    bumped prefix means a v1 worker and a v2 worker in a mixed-version
    fleet can never alias each other's entries — every v2 key differs
    from every v1 key in its first component.
    """
    digest, shape, dtype, backend, config, mesh, op = key
    parts = (
        b"ychg-key-v2",
        _canon(op),
        digest,
        "x".join(str(int(s)) for s in shape).encode(),
        _canon(dtype),
        _canon(backend),
        _canon(config),
        _canon(mesh),
    )
    return b"".join(len(p).to_bytes(4, "big") + p for p in parts)


class ResultCache:
    """Thread-safe LRU over :func:`make_key` keys with hit/miss counters.

    ``capacity`` is an entry count; 0 disables the cache entirely (every
    ``get`` is a miss, ``put`` is a no-op) so the service can run cacheless
    without branching at every call site.

    ``index_serialized=True`` additionally indexes every entry by its
    :func:`serialize_key` bytes so a *sibling process* can look entries up
    over the RPC ``cache_probe`` verb (``probe_serialized``) — fleet
    workers run with it on; the single-process default stays off and pays
    nothing. ``peer_probe`` is the outbound half: the base class never
    peers (returns None); ``repro_torch.fleet.peering.PeeredResultCache``
    overrides it to ask siblings before the service pays compute.
    ``peer_hits``/``peer_misses`` count those outbound probes.
    """

    def __init__(self, capacity: int = 1024, *,
                 index_serialized: bool = False):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self.index_serialized = index_serialized
        self._entries: "OrderedDict[CacheKey, Any]" = OrderedDict()
        self._by_serialized: Dict[bytes, CacheKey] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.peer_hits = 0
        self.peer_misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def get(self, key: CacheKey) -> Optional[Any]:
        with self._lock:
            try:
                value = self._entries[key]
            except KeyError:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: CacheKey, value: Any) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            if self.index_serialized:
                self._by_serialized[serialize_key(key)] = key
            while len(self._entries) > self.capacity:
                evicted, _ = self._entries.popitem(last=False)
                if self.index_serialized:
                    self._by_serialized.pop(serialize_key(evicted), None)

    def probe_serialized(self, skey: bytes) -> Optional[Any]:
        """Inbound sibling lookup by serialized key; purely local — a probe
        never recurses into ``peer_probe`` and never counts toward the
        local hit/miss rate (it is the *sibling's* miss, not ours)."""
        with self._lock:
            key = self._by_serialized.get(skey)
            if key is None:
                return None
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
            return value

    def peer_probe(self, key: CacheKey) -> Optional[Any]:
        """Outbound sibling probe on a local miss. Base: no peers."""
        return None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_serialized.clear()
