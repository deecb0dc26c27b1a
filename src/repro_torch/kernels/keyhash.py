"""The service's content digest: BLAKE2b in its tree-hashing mode, on the
card or on the host, one definition.

A request's cache key holds a 16-byte digest of the mask's bytes as
submitted (whatever the dtype). The digest is BLAKE2b's own tree mode
(the BLAKE2 specification's parameter block): leaves of ``LEAF_BYTES``
bytes, fanout ``FANOUT``, every node's digest ``DIGEST_BYTES`` long, and
``depth`` the number of levels the byte length needs. Leaf ``i`` hashes
bytes ``[i * LEAF_BYTES, (i + 1) * LEAF_BYTES)`` at node_depth 0 and
node_offset ``i``; an inner node at node_depth ``d`` and node_offset ``j``
hashes the digests of children ``[j * FANOUT, (j + 1) * FANOUT)`` of the
level below, concatenated; the last node of each level sets last_node.
A length of at most ``LEAF_BYTES`` (empty included) is one leaf, which is
the root. An 8192² uint8 mask is 16,384 leaves, 128 inner nodes and the
root.

:func:`digest` is the one entry point: on a CUDA tensor it runs
``csrc/keyhash.cu`` (:func:`launch`: one thread a leaf, the inner levels
and the root in the same launch; the source states its design and its
bound) on the current stream, waits for that stream alone and returns the
16 bytes; on a host array or a CPU tensor it runs the plain version,
:func:`digest_host`: ``hashlib.blake2b`` node by node, over a view of the
array's buffer (no copy of it).
``LAUNCHES["keyhash"]`` counts kernel launches. The JAX package keys
requests with a plain blake2b on the host: no Pallas kernel is replaced.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LEAF_BYTES = 4096     # kLeafBytes in csrc/keyhash.cu
FANOUT = 128          # kFanout
DIGEST_BYTES = 16     # kDigestBytes
_HEAD_BYTES = 32      # kHeadBytes: the kernel's counter, then the root

# one compression of a 128-byte block: the instructions of one full block
# in the SASS of csrc/keyhash.cu for sm_90a (cuobjdump -sass; the leaf
# loop's path for a whole block: 784 LOP3, 582 IADD3, 576 SHF, 199 IMAD,
# 87 others), each an int32 issue slot. A G function is 22: each 64-bit
# add an IADD3 pair (three-operand where it can), each xor two LOP3, each
# rotation but by 32 two SHF
OPS_PER_BLOCK = 2228
BLOCK_BYTES = 128

LAUNCHES: Dict[str, int] = {"keyhash": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # data, bytes, scratch, scratch bytes, host digest, stream
    "keyhash": (_P, _I, _P, _I, _P, _P),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def levels(nbytes: int) -> List[int]:
    """The number of nodes in each level of the tree over ``nbytes``
    bytes, leaves first, the root (1) last; ``len(levels(n))`` is the
    tree's depth."""
    counts = [max(1, -(-nbytes // LEAF_BYTES))]
    while counts[-1] > 1:
        counts.append(-(-counts[-1] // FANOUT))
    return counts


def scratch_bytes(nbytes: int) -> int:
    """Device scratch the kernel needs for ``nbytes`` bytes: its counter,
    the root digest, and every other level's digests."""
    return _HEAD_BYTES + DIGEST_BYTES * sum(levels(nbytes)[:-1])


def work(nbytes: int) -> Tuple[int, int]:
    """(bytes, int32 operations) of the digest of ``nbytes`` bytes: the
    input read once and the 16-byte root written once; a compression a
    128-byte block of every node, leaves and inner nodes."""
    counts = levels(nbytes)
    blocks = max(1, -(-nbytes // BLOCK_BYTES)) + sum(
        -(-c * DIGEST_BYTES // BLOCK_BYTES) for c in counts[:-1])
    return nbytes + DIGEST_BYTES, OPS_PER_BLOCK * blocks


def _node(data, depth: int, offset: int, node_depth: int,
          last: bool) -> bytes:
    return hashlib.blake2b(
        data, digest_size=DIGEST_BYTES, fanout=FANOUT, depth=depth,
        leaf_size=LEAF_BYTES, node_offset=offset, node_depth=node_depth,
        inner_size=DIGEST_BYTES, last_node=last).digest()


def digest_host(a: np.ndarray) -> bytes:
    """The tree digest of a host array's bytes (C order), with hashlib."""
    buf = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    counts = levels(len(buf))
    depth = len(counts)
    level = [_node(buf[i * LEAF_BYTES:(i + 1) * LEAF_BYTES], depth, i, 0,
                   i + 1 == counts[0]) for i in range(counts[0])]
    for d, nodes in enumerate(counts[1:], start=1):
        level = [_node(b"".join(level[j * FANOUT:(j + 1) * FANOUT]), depth,
                       j, d, j + 1 == nodes) for j in range(nodes)]
    return level[0]


def digest(x) -> bytes:
    """The tree digest of ``x``'s bytes, in C order: the kernel on a CUDA
    tensor, the plain version on a host array or a CPU tensor. Any other
    device raises."""
    if isinstance(x, np.ndarray):
        return digest_host(x)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected an array or a tensor, got "
                        f"{type(x).__name__}")
    if x.device.type == "cpu":
        return digest_host(
            x.contiguous().reshape(-1).view(torch.uint8).numpy())
    return launch(x)


def launch(x: Tensor) -> bytes:
    """The ``keyhash`` kernel on a CUDA tensor, on the current stream,
    which it synchronises (and no other) to bring the 16 bytes back."""
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on "
                         f"{x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
        x = x.clone()
    n = x.numel() * x.element_size()
    scratch = torch.empty(scratch_bytes(n), dtype=torch.uint8,
                          device=x.device)
    out = np.empty(DIGEST_BYTES, np.uint8)
    lib = _build.load("keyhash", _SIGNATURES)
    err = _build.on_stream(x, lib.keyhash, x.data_ptr(), n,
                           scratch.data_ptr(), scratch.numel(),
                           out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"keyhash failed: CUDA error {err}")
    LAUNCHES["keyhash"] += 1
    return out.tobytes()
