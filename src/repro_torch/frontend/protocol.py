"""Wire format shared by the HTTP and RPC transports.

The port's own copy of ``repro.frontend.protocol`` (the port imports
nothing of the JAX package): the same codec, framing, field orders and
``MAX_FRAME_BYTES``, so a client of either package talks to a server of
the other byte for byte.

Everything on the wire is JSON; arrays travel as raw little-endian bytes
base64-encoded next to their shape and dtype, so a round trip is
**bit-identical** — ``launch.serve --frontend-smoke`` holds a client result to
byte equality with the in-process ``YCHGService.submit`` result, and this
encoding is what makes that a meaningful check (float-free, no repr
round-off, dtypes preserved).

Three layers live here, all transport-agnostic and numpy-only (no torch):

  * array codec — :func:`encode_array` / :func:`decode_array`;
  * result codec — :func:`encode_result` / :func:`decode_result`: the
    seven ``YCHGResult`` fields as encoded arrays (the host view a
    ``result.to_host()`` call produces);
  * framing — :func:`dumps_line` for NDJSON streaming over HTTP, and
    :func:`pack_frame` / :func:`read_frame` for the length-prefixed TCP
    RPC transport (4-byte big-endian payload length, then JSON).
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, Optional

import numpy as np

# yCHG result fields, in the engine's canonical order
RESULT_FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
                 "n_hyperedges", "n_transitions")

# Per-op result fields. yCHG keeps RESULT_FIELDS (its wire format is
# byte-for-byte what it was before the multi-op refactor); each new op
# lists its own ``to_host()`` keys in canonical order. A pipeline key
# ("denoise+ychg") answers with its terminal stage's fields.
OP_RESULT_FIELDS = {
    "ychg": RESULT_FIELDS,
    "ccl": ("labels", "n_components"),
    "denoise": ("image",),
}


def result_fields(op: str) -> tuple:
    """The wire fields for an op (or ``"+"``-joined pipeline) key."""
    terminal = op.rsplit("+", 1)[-1]
    try:
        return OP_RESULT_FIELDS[terminal]
    except KeyError:
        raise ProtocolError(
            f"unknown op {op!r} on the wire; known ops: "
            f"{sorted(OP_RESULT_FIELDS)}") from None

# one RPC frame's maximum payload: far above any bucket-ladder mask or
# result, far below anything that could balloon a peer's memory
MAX_FRAME_BYTES = 64 * 1024 * 1024

# Traffic-shaping contract (docs/traffic.md): one name per transport.
# HTTP requests carry these headers; RPC frames carry the matching
# optional fields "klass", "deadline_ms", "tenant". None of the three
# ever changes a payload, cache key, or routing key — a classed result
# is bit-identical to an unclassed one.
TRAFFIC_CLASS_HEADER = "X-YCHG-Class"
TRAFFIC_DEADLINE_HEADER = "X-YCHG-Deadline-Ms"
TRAFFIC_TENANT_HEADER = "X-YCHG-Tenant"


def decode_traffic(klass: Any = None, deadline_ms: Any = None,
                   tenant: Any = None) -> Dict[str, Any]:
    """Validate the three optional traffic-shaping fields off the wire.

    Accepts raw header strings or RPC frame JSON values; returns the
    ``Service.submit`` kwargs dict (``klass`` / ``deadline_ms`` /
    ``tenant``, absent fields as None). Malformed values raise
    :class:`ProtocolError` — a bad deadline is a 400-class client error,
    never a 500.
    """
    out: Dict[str, Any] = {"klass": None, "deadline_ms": None,
                           "tenant": None}
    if klass is not None:
        if not isinstance(klass, str) or not klass.strip():
            raise ProtocolError(f"malformed traffic class {klass!r}")
        out["klass"] = klass.strip()
    if deadline_ms is not None:
        try:
            out["deadline_ms"] = float(deadline_ms)
        except (TypeError, ValueError) as e:
            raise ProtocolError(
                f"malformed deadline_ms {deadline_ms!r}: {e}") from e
    if tenant is not None:
        if not isinstance(tenant, str) or not tenant.strip():
            raise ProtocolError(f"malformed tenant {tenant!r}")
        out["tenant"] = tenant.strip()
    return out


class ProtocolError(ValueError):
    """A malformed wire payload (bad JSON shape, dtype, length, frame)."""


# ------------------------------------------------------------ array codec


def encode_array(a: np.ndarray) -> Dict[str, Any]:
    """A numpy array as a JSON-safe dict: shape + dtype + base64 bytes."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        # NOT ascontiguousarray unconditionally: it silently promotes 0-d
        # arrays (the B=1 result scalars) to 1-d, breaking bit-identity
        a = np.ascontiguousarray(a)
    return {
        "shape": list(a.shape),
        "dtype": str(a.dtype),
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`encode_array`; extra keys (``id``) are ignored.

    Validates that the payload length matches shape x dtype, so a
    truncated or padded body fails loudly instead of reshaping garbage.
    Dims must be strictly positive: nothing on this wire carries empty
    arrays, and a shape like ``[-1, -8]`` has a positive *product* (its
    byte length can match), which would otherwise sail past the length
    check into a bare ``reshape`` ValueError outside the ProtocolError
    contract — the server would answer 500 for what is a bad request.
    """
    try:
        shape = tuple(int(s) for s in d["shape"])
        dtype = np.dtype(str(d["dtype"]))
        raw = base64.b64decode(d["b64"], validate=True)
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed array payload: {e}") from e
    if any(s <= 0 for s in shape):
        raise ProtocolError(f"array shape {list(shape)} has non-positive dims")
    expect = dtype.itemsize
    for s in shape:   # python ints: absurd dims can't overflow into a
        expect *= s   # wrong (or negative) int64 expectation
    if len(raw) != expect:
        raise ProtocolError(
            f"array payload is {len(raw)} bytes, shape {shape} dtype "
            f"{dtype} needs {expect}")
    return np.frombuffer(raw, dtype).reshape(shape).copy()


# ----------------------------------------------------------- result codec


def encode_result(result: Any, op: str = "ychg") -> Dict[str, Any]:
    """An op result pytree (or host dict of its fields) as encoded arrays.

    The default ``op="ychg"`` keeps every pre-multi-op call site and wire
    payload unchanged.
    """
    host = result if isinstance(result, dict) else result.to_host()
    return {f: encode_array(np.asarray(host[f])) for f in result_fields(op)}


def decode_result(d: Dict[str, Any],
                  op: str = "ychg") -> Dict[str, np.ndarray]:
    """Inverse of :func:`encode_result`: the ``to_host()``-shaped dict."""
    try:
        return {f: decode_array(d[f]) for f in result_fields(op)}
    except KeyError as e:
        raise ProtocolError(f"result payload missing field {e}") from e


# ---------------------------------------------------------------- framing


def dumps_line(obj: Any) -> bytes:
    """One NDJSON line: compact JSON + newline (the HTTP stream unit)."""
    return json.dumps(obj, separators=(",", ":")).encode() + b"\n"


def pack_frame(obj: Any) -> bytes:
    """One RPC frame: 4-byte big-endian payload length, then JSON."""
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame payload {len(payload)} bytes exceeds "
            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    return len(payload).to_bytes(4, "big") + payload


def unpack_frame_header(head: bytes) -> int:
    """Payload length from the 4-byte frame header, bounds-checked."""
    n = int.from_bytes(head, "big")
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame of {n} bytes exceeds MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    return n


async def read_frame(reader: Any) -> Optional[Any]:
    """Read one frame from an asyncio ``StreamReader``; None on clean EOF.

    EOF mid-frame (header or payload truncated) raises
    :class:`ProtocolError` — a peer vanishing between frames is normal,
    vanishing inside one is a broken transport.
    """
    import asyncio

    try:
        head = await reader.readexactly(4)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ProtocolError("EOF inside a frame header") from e
    n = unpack_frame_header(head)
    try:
        payload = await reader.readexactly(n)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError("EOF inside a frame payload") from e
    try:
        return json.loads(payload)
    except ValueError as e:
        raise ProtocolError(f"frame payload is not JSON: {e}") from e
