"""Clients for the yCHG front end: blocking HTTP + async RPC.

The port's counterpart of ``repro.frontend.client``; the wire is the same,
so either package's client drives either package's server.

`YCHGClient` is the stdlib-only blocking client: one persistent HTTP/1.1
connection (keep-alive, reconnect on failure), ``analyze`` for one mask,
and **streaming** ``analyze_batch`` — results are yielded as the server
completes them (NDJSON lines decoded incrementally off the chunked
response), not after the whole batch lands, so a consumer can overlap its
own work with the service's compute. A 429 on ``analyze`` raises
:class:`FrontendOverloaded` carrying the server's drain-rate-derived
``retry_after_s``; inside a batch stream, shed masks arrive as per-item
error lines while admitted masks keep streaming.

`AsyncRPCClient` speaks the length-prefixed TCP transport: many analyzes
in flight on one connection, responses demuxed by id in completion order.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import math
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.frontend import protocol
from repro_torch.obs import maybe_trace

# must match repro_torch.frontend.server.TRACE_HEADER (kept literal here so the
# client stays importable without the server module)
TRACE_HEADER = "X-YCHG-Trace"


def _traffic_headers(klass: Optional[str], deadline_ms: Optional[float],
                     tenant: Optional[str]) -> Dict[str, str]:
    """The traffic-shaping headers for one request (docs/traffic.md);
    absent kwargs send nothing, so an unshaped request is byte-for-byte
    the pre-traffic-classes wire request."""
    headers: Dict[str, str] = {}
    if klass is not None:
        headers[protocol.TRAFFIC_CLASS_HEADER] = str(klass)
    if deadline_ms is not None:
        headers[protocol.TRAFFIC_DEADLINE_HEADER] = repr(float(deadline_ms))
    if tenant is not None:
        headers[protocol.TRAFFIC_TENANT_HEADER] = str(tenant)
    return headers


def _put_traffic_fields(frame: Dict[str, Any], klass: Optional[str],
                        deadline_ms: Optional[float],
                        tenant: Optional[str]) -> None:
    """RPC-frame twin of :func:`_traffic_headers`: set only the fields
    given, so an unshaped frame is byte-for-byte the pre-traffic frame."""
    if klass is not None:
        frame["klass"] = str(klass)
    if deadline_ms is not None:
        frame["deadline_ms"] = float(deadline_ms)
    if tenant is not None:
        frame["tenant"] = str(tenant)


class FrontendError(RuntimeError):
    """A non-2xx response from the front end (with its HTTP status)."""

    def __init__(self, message: str, status: int = 500):
        super().__init__(message)
        self.status = status


class FrontendOverloaded(FrontendError):
    """HTTP 429: the service shed this request at an admission bound.

    ``retry_after_s`` is the server's estimate of how long the current
    backlog needs to drain (the ``Retry-After`` header, float precision
    from the JSON body when present).

    ``kind`` distinguishes what shed the request: ``"overload"`` (an
    admission bound), ``"deadline"`` (predicted delay past the request's
    ``deadline_ms``), or ``"quota"`` (tenant token bucket empty) — the
    body's ``kind`` field, defaulting to ``"overload"`` for older
    servers.
    """

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 kind: str = "overload"):
        super().__init__(message, status=429)
        self.retry_after_s = retry_after_s
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class BatchItem:
    """One completed line of a streamed batch: a result or an error."""

    id: Any
    result: Optional[Dict[str, np.ndarray]] = None
    error: Optional[str] = None
    status: int = 200
    retry_after_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.result is not None


def _retry_after_s(obj: Dict[str, Any], headers: Any,
                   default: float = 1.0) -> float:
    """Backoff seconds out of a 429: the body's float-precision
    ``retry_after_s`` when usable, else the ``Retry-After`` header, else
    ``default``. A malformed, empty, or absent value must degrade to the
    default — never raise out of the client (pre-fix, a bogus header made
    ``float()`` throw ``ValueError`` instead of ``FrontendOverloaded``)."""
    for value in (obj.get("retry_after_s"), headers.get("Retry-After")):
        try:
            retry = float(value)
        except (TypeError, ValueError):
            continue
        if math.isfinite(retry) and retry >= 0:
            return retry
    return default


def _decode_line(obj: Dict[str, Any]) -> BatchItem:
    if "result" in obj:
        return BatchItem(id=obj.get("id"),
                         result=protocol.decode_result(obj["result"]))
    return BatchItem(id=obj.get("id"), error=obj.get("error", "unknown"),
                     status=int(obj.get("status", 500)),
                     retry_after_s=obj.get("retry_after_s"))


class YCHGClient:
    """Blocking HTTP client over one keep-alive loopback connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8788, *,
                 timeout: float = 300.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None

    # ------------------------------------------------------------- plumbing

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "YCHGClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 ) -> http.client.HTTPResponse:
        """One request with a single transparent retry on a dropped
        keep-alive connection (the server or an idle timeout closed it)."""
        for attempt in (0, 1):
            conn = self._connection()
            try:
                hdrs = dict(headers or {})
                if body:
                    hdrs.setdefault("Content-Type", "application/json")
                conn.request(method, path, body=body, headers=hdrs)
                return conn.getresponse()
            except (http.client.HTTPException, ConnectionError, OSError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def wait_ready(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Poll /healthz until the server answers (connect retries), for
        callers racing a freshly launched server process."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self.health()
            except (FrontendError, ConnectionError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    # ------------------------------------------------------------- requests

    def health(self) -> Dict[str, Any]:
        resp = self._request("GET", "/healthz")
        body = resp.read()
        if resp.status != 200:
            raise FrontendError(body.decode(errors="replace"), resp.status)
        return json.loads(body)

    def metrics_text(self) -> str:
        resp = self._request("GET", "/metrics")
        body = resp.read()
        if resp.status != 200:
            raise FrontendError(body.decode(errors="replace"), resp.status)
        return body.decode()

    def debug_traces(self) -> Dict[str, Any]:
        """The server's flight recorder as parsed Chrome-trace JSON
        (``{"traceEvents": [...]}``), straight off ``GET /debug/traces``."""
        resp = self._request("GET", "/debug/traces")
        body = resp.read()
        if resp.status != 200:
            raise FrontendError(body.decode(errors="replace"), resp.status)
        return json.loads(body)

    def analyze(self, mask: np.ndarray, id: Any = None,
                trace_id: Optional[str] = None, *,
                op: Optional[str] = None, klass: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                tenant: Optional[str] = None) -> Dict[str, np.ndarray]:
        """One mask -> the ``to_host()``-shaped result dict (bit-identical
        to in-process ``service.submit(mask).result().to_host()``).

        ``op`` posts to ``/v1/{op}`` (``/v1/ccl``, ``/v1/denoise``, ...);
        the default keeps the historical ``/v1/analyze`` route and wire
        format. ``trace_id`` propagates over the ``X-YCHG-Trace`` header
        so the server's spans join the caller's trace; the client's own
        encode + wire spans land in this process's flight recorder under
        the same id. ``klass`` / ``deadline_ms`` / ``tenant`` ride the
        traffic-shaping headers (docs/traffic.md); a shed comes back as
        :class:`FrontendOverloaded` with ``kind`` naming the check that
        tripped."""
        path = "/v1/analyze" if op is None else f"/v1/{op}"
        return self._analyze_path(path, mask, id, trace_id,
                                  wire_op=op or "ychg",
                                  traffic=_traffic_headers(
                                      klass, deadline_ms, tenant))

    def pipeline(self, mask: np.ndarray, stages: Sequence[str],
                 id: Any = None, trace_id: Optional[str] = None, *,
                 klass: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None) -> Dict[str, np.ndarray]:
        """One mask through ``POST /v1/pipeline``; the terminal stage's
        ``to_host()``-shaped result dict."""
        stages = [str(s) for s in stages]
        if not stages:
            raise ValueError("pipeline needs at least one stage")
        return self._analyze_path("/v1/pipeline", mask, id, trace_id,
                                  wire_op=stages[-1], stages=stages,
                                  traffic=_traffic_headers(
                                      klass, deadline_ms, tenant))

    def _analyze_path(self, path: str, mask: np.ndarray, id: Any,
                      trace_id: Optional[str], *, wire_op: str,
                      stages: Optional[List[str]] = None,
                      traffic: Optional[Dict[str, str]] = None,
                      ) -> Dict[str, np.ndarray]:
        tr = maybe_trace(trace_id, process="client")
        try:
            t0 = time.monotonic()
            req = dict(protocol.encode_array(np.asarray(mask)))
            payload_obj: Dict[str, Any] = {"mask": req, "id": id}
            if stages is not None:
                payload_obj["stages"] = stages
            body = json.dumps(payload_obj).encode()
            t1 = time.monotonic()
            tr.add("client.encode", t0, t1, bytes=len(body))
            headers = dict(traffic) if traffic else {}
            if tr.enabled:
                headers[TRACE_HEADER] = tr.trace_id
            resp = self._request("POST", path, body, headers or None)
            payload = resp.read()
            tr.add("client.wire", t1, time.monotonic(),
                   status=resp.status)
            if resp.status == 429:
                try:
                    obj = json.loads(payload)
                except ValueError:
                    obj = {}
                raise FrontendOverloaded(
                    obj.get("error", "overloaded"),
                    retry_after_s=_retry_after_s(obj, resp.headers),
                    kind=obj.get("kind", "overload"))
            if resp.status != 200:
                raise FrontendError(payload.decode(errors="replace"),
                                    resp.status)
            return protocol.decode_result(json.loads(payload)["result"],
                                          wire_op)
        finally:
            tr.finish()

    def analyze_batch(self, masks: Sequence[np.ndarray],
                      ids: Optional[Iterable[Any]] = None,
                      trace_id: Optional[str] = None, *,
                      klass: Optional[str] = None,
                      deadline_ms: Optional[float] = None,
                      tenant: Optional[str] = None) -> Iterator[BatchItem]:
        """Submit a batch; yield :class:`BatchItem` per mask **in the
        server's completion order**, as the lines arrive off the wire."""
        id_list: List[Any] = (list(ids) if ids is not None
                              else list(range(len(masks))))
        if len(id_list) != len(masks):
            raise ValueError(
                f"{len(masks)} masks but {len(id_list)} ids")
        tr = maybe_trace(trace_id, process="client")
        try:
            t0 = time.monotonic()
            items = []
            for rid, m in zip(id_list, masks):
                d = dict(protocol.encode_array(np.asarray(m)))
                d["id"] = rid
                items.append(d)
            body = json.dumps({"masks": items}).encode()
            t1 = time.monotonic()
            tr.add("client.encode", t0, t1, bytes=len(body),
                   masks=len(items))
            headers = _traffic_headers(klass, deadline_ms, tenant)
            if tr.enabled:
                headers[TRACE_HEADER] = tr.trace_id
            resp = self._request("POST", "/v1/analyze_batch", body,
                                 headers or None)
            if resp.status != 200:
                payload = resp.read()
                raise FrontendError(payload.decode(errors="replace"),
                                    resp.status)
            # http.client decodes the chunked framing; readline() returns
            # one NDJSON line as soon as its chunk lands — the streaming
            while True:
                line = resp.readline()
                if not line:
                    break
                yield _decode_line(json.loads(line))
            tr.add("client.wire", t1, time.monotonic(), masks=len(items))
        finally:
            tr.finish()


class AsyncRPCClient:
    """Length-prefixed TCP RPC client: pipelined analyzes on one socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8789):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, "asyncio.Future[Dict[str, Any]]"] = {}
        self._next_id = 0
        self._demux: Optional[asyncio.Task] = None
        self._conn_exc: Optional[Exception] = None

    async def connect(self) -> "AsyncRPCClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        self._demux = asyncio.ensure_future(self._demux_loop())
        return self

    async def _demux_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                frame = await protocol.read_frame(self._reader)
                if frame is None:
                    break
                fut = self._pending.pop(frame.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(frame)
        except (protocol.ProtocolError, ConnectionError, OSError) as e:
            self._conn_exc = FrontendError(str(e) or type(e).__name__)
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(FrontendError(str(e)))
            self._pending.clear()
        finally:
            # once the demux is gone nothing can ever resolve a pending
            # future, so later call()s must fail fast instead of hanging
            if self._conn_exc is None:
                self._conn_exc = FrontendError("connection closed")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(FrontendError("connection closed"))
            self._pending.clear()

    async def call(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """One raw frame -> its response frame (id assigned here). The
        fleet router forwards pre-encoded analyze frames through this
        without re-encoding the mask, which is what keeps the router path
        trivially bit-identical."""
        assert self._writer is not None, "connect() first"
        if self._conn_exc is not None:
            raise self._conn_exc
        rid = self._next_id
        self._next_id += 1
        frame = dict(frame)
        frame["id"] = rid
        fut: "asyncio.Future[Dict[str, Any]]" = (
            asyncio.get_running_loop().create_future())
        self._pending[rid] = fut
        self._writer.write(protocol.pack_frame(frame))
        await self._writer.drain()
        return await fut

    _call = call   # pre-fleet internal name, kept for callers/tests

    async def analyze(self, mask: np.ndarray, *,
                      op: Optional[str] = None, klass: Optional[str] = None,
                      deadline_ms: Optional[float] = None,
                      tenant: Optional[str] = None) -> Dict[str, np.ndarray]:
        frame: Dict[str, Any] = {
            "op": "analyze", "mask": protocol.encode_array(np.asarray(mask))}
        if op is not None:
            frame["opname"] = op
        _put_traffic_fields(frame, klass, deadline_ms, tenant)
        resp = await self._call(frame)
        return self._unwrap(resp, op or "ychg")

    async def pipeline(self, mask: np.ndarray, stages: Sequence[str], *,
                       klass: Optional[str] = None,
                       deadline_ms: Optional[float] = None,
                       tenant: Optional[str] = None) -> Dict[str, np.ndarray]:
        stages = [str(s) for s in stages]
        frame: Dict[str, Any] = {
            "op": "pipeline", "stages": stages,
            "mask": protocol.encode_array(np.asarray(mask))}
        _put_traffic_fields(frame, klass, deadline_ms, tenant)
        resp = await self._call(frame)
        return self._unwrap(resp, stages[-1] if stages else "ychg")

    @staticmethod
    def _unwrap(resp: Dict[str, Any], wire_op: str) -> Dict[str, np.ndarray]:
        if "result" in resp:
            return protocol.decode_result(resp["result"], wire_op)
        status = int(resp.get("status", 500))
        if status == 429:
            raise FrontendOverloaded(resp.get("error", "overloaded"),
                                     retry_after_s=_retry_after_s(resp, {}),
                                     kind=resp.get("kind", "overload"))
        raise FrontendError(resp.get("error", "rpc error"), status)

    async def health(self) -> Dict[str, Any]:
        return await self._call({"op": "health"})

    async def aclose(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        if self._demux is not None:
            await asyncio.wait([self._demux], timeout=5)
            self._demux.cancel()
