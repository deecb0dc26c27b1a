"""`PeeredResultCache` — a ResultCache that asks its siblings before
computing.

The port's counterpart of ``repro.fleet.peering``. Fleet workers each hold
a private LRU; the router's consistent hashing makes those caches *mostly*
disjoint, but a worker restart (empty cache, same keyspace) or a failover
window (keys served by the wrong worker) leaves entries stranded on a
sibling. On a local miss this cache probes each configured peer's RPC
``cache_probe`` verb — a pure lookup on the far side, never a compute — and
adopts the first hit, so a repeat mask after a restart costs one loopback
round trip instead of a kernel run.

The probe is deliberately cheap and fail-soft: a fresh blocking socket
per probe (no connection state to manage across worker restarts), a short
timeout, and ANY transport or decode failure is just a miss — peering
must never make a worker less available than not peering. The reply
carries the stored entry layout ((1, W)/(1,) arrays, ``batched=False``),
which is re-hosted onto this worker's device with
``torch.from_numpy(...).to(device)`` so the adopted entry is
indistinguishable from one this worker computed: ``to_host()`` of either
is byte-identical.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.engine.ops import get_op, split_pipeline_key
from repro_torch.frontend import protocol
from repro_torch.service.cache import CacheKey, ResultCache, serialize_key

# one probe's whole budget (connect + request + reply): siblings are
# loopback neighbours, so anything slower than this is effectively down
# and compute is the better bet
DEFAULT_PROBE_TIMEOUT_S = 0.25


def _recv_exactly(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return buf


def probe_peer(host: str, port: int, skey: bytes, *,
               timeout: float = DEFAULT_PROBE_TIMEOUT_S,
               opname: str = "ychg") -> Optional[Dict[str, Any]]:
    """One blocking ``cache_probe`` round trip; the decoded hit frame, or
    None on miss/any failure. ``opname`` tells the sibling which op's
    field set to encode the stored entry with."""
    try:
        with socket.create_connection((host, port), timeout=timeout) as sock:
            sock.sendall(protocol.pack_frame(
                {"op": "cache_probe", "key": skey.hex(), "id": 0,
                 "opname": opname}))
            head = _recv_exactly(sock, 4)
            payload = _recv_exactly(sock, protocol.unpack_frame_header(head))
    except (ConnectionError, OSError, protocol.ProtocolError):
        return None
    try:
        frame = json.loads(payload)
    except ValueError:
        return None
    return frame if frame.get("hit") else None


class PeeredResultCache(ResultCache):
    """A ResultCache whose misses consult sibling workers over RPC.

    ``device`` is where an adopted entry's tensors are put: the device of
    the engine this cache serves (the worker passes its engine's).
    """

    def __init__(self, capacity: int = 1024, *, device: Any,
                 probe_timeout_s: float = DEFAULT_PROBE_TIMEOUT_S):
        # serialized index always on: siblings address us by serialized
        # key through the server's cache_probe verb
        super().__init__(capacity, index_serialized=True)
        self.device = torch.device(device)
        self.probe_timeout_s = probe_timeout_s
        self._peers: Tuple[Tuple[str, int], ...] = ()
        self._peers_lock = threading.Lock()

    def set_peers(self, peers: Sequence[Tuple[str, int]]) -> None:
        """Replace the sibling set ((host, rpc_port) pairs). Called at
        fleet bring-up and re-broadcast after any worker restart."""
        with self._peers_lock:
            self._peers = tuple((str(h), int(p)) for h, p in peers)

    @property
    def peers(self) -> Tuple[Tuple[str, int], ...]:
        with self._peers_lock:
            return self._peers

    def peer_probe(self, key: CacheKey) -> Optional[Any]:
        """Ask each sibling in turn; reconstruct the first hit as a
        stored-layout result on this cache's device. Any failure = miss."""
        peers = self.peers
        if not peers:
            return None
        skey = serialize_key(key)
        op_key = key[6]
        result_type = get_op(split_pipeline_key(op_key)[-1]).result_type
        for host, port in peers:
            frame = probe_peer(host, port, skey,
                               timeout=self.probe_timeout_s, opname=op_key)
            if frame is None:
                continue
            try:
                fields = {
                    f: torch.from_numpy(protocol.decode_array(
                        frame["result"][f])).to(self.device)
                    for f in protocol.result_fields(op_key)}
                result = result_type(**fields, batched=False)
            except (KeyError, TypeError, ValueError, protocol.ProtocolError):
                continue   # a garbled reply is a miss, not an outage
            self.peer_hits += 1
            return result
        self.peer_misses += 1
        return None
