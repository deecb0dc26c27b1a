"""Consistent-hash ring over worker slot names.

A copy of ``repro.fleet.hashring``: the same points, so the same node names
give the same placement in both packages.

The router places each request by its serialized cache key
(:func:`repro_torch.service.cache.serialize_key`) so identical masks always hit
the same worker — that worker's local cache and in-flight coalescing then
do fleet-wide what they already do per process. Two properties matter:

  * **stability** — points are blake2b digests of ``"{node}#{i}"``, no
    ``hash()``, no randomness: the same node names produce the same ring
    in every process and every run, and a restarted worker that keeps its
    slot name ("w1") keeps its keyspace;
  * **minimal movement** — with ``replicas`` virtual nodes per worker,
    removing one worker redistributes only its own arc among the
    survivors; everyone else's placement is untouched.

``node_for(key, up=...)`` walks clockwise past downed nodes, so failover
is deterministic too: a key's requests always fail over to the same
survivor, keeping the cache-locality story intact even mid-outage.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence


def _point(label: str) -> int:
    """A 64-bit ring position from a stable byte rendering of the label."""
    return int.from_bytes(
        hashlib.blake2b(label.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Immutable consistent-hash ring over a fixed set of node names."""

    def __init__(self, nodes: Sequence[str], replicas: int = 64):
        if not nodes:
            raise ValueError("HashRing needs at least one node")
        if len(set(nodes)) != len(nodes):
            raise ValueError(f"duplicate node names in {list(nodes)}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.nodes = tuple(nodes)
        self.replicas = replicas
        points: Dict[int, str] = {}
        for node in nodes:
            for i in range(replicas):
                points[_point(f"{node}#{i}")] = node
        self._points = sorted(points)
        self._owner = [points[p] for p in self._points]

    def preference(self, key: bytes) -> List[str]:
        """All nodes in failover order for ``key``: the owner first, then
        each distinct node as the clockwise walk reaches it."""
        start = bisect.bisect_right(
            self._points,
            int.from_bytes(
                hashlib.blake2b(key, digest_size=8).digest(), "big"))
        seen: List[str] = []
        n = len(self._points)
        for i in range(n):
            node = self._owner[(start + i) % n]
            if node not in seen:
                seen.append(node)
                if len(seen) == len(self.nodes):
                    break
        return seen

    def node_for(self, key: bytes,
                 up: Optional[Sequence[str]] = None) -> Optional[str]:
        """The owning node for ``key``, skipping nodes not in ``up``
        (None = all up). None when every candidate is down."""
        alive = set(self.nodes if up is None else up)
        for node in self.preference(key):
            if node in alive:
                return node
        return None
