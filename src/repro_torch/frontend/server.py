"""Asyncio HTTP/JSON (+ optional length-prefixed RPC) front end.

The port's counterpart of ``repro.frontend.server``, over
``repro_torch.service``. Two differences: a cache hit answered to a
sibling's ``cache_probe`` is copied to the host first (the port's cache
holds device tensors), and one RPC verb that raises answers a 500 frame
instead of closing its connection.

`FrontendServer` puts a network edge on
:class:`repro_torch.service.YCHGService`
without adding a second scheduler: every request is bridged onto the
threaded service with ``loop.run_in_executor`` + ``asyncio.wrap_future``,
so the service's own admission control is the only admission control —

  * ``overload_policy="block"`` parks the executor worker (never the event
    loop) until a slot frees: backpressure propagates to exactly the slow
    client, and once all workers are parked further requests queue in the
    executor — the whole edge slows to the service's pace;
  * ``overload_policy="shed"`` maps :class:`ServiceOverloaded` to HTTP 429
    with a ``Retry-After`` derived from the observed queue drain rate
    (completions/second over a rolling sample), so clients back off for
    roughly as long as the backlog needs to clear rather than a constant.

Endpoints (HTTP/1.1, keep-alive, loopback-friendly):

  ``GET  /healthz``           liveness + resolved backend + queue depth
  ``GET  /metrics``           ``ServiceMetrics`` in Prometheus text format
                              (per-bucket shed counters included)
  ``POST /v1/{op}``           one mask -> one JSON result for any
                              registered op (``/v1/ychg``, ``/v1/ccl``,
                              ``/v1/denoise``); an unknown op answers 404
                              JSON naming the registered ops
  ``POST /v1/analyze``        kept alias for ``/v1/ychg`` (the pre-multi-op
                              route, byte-identical responses)
  ``POST /v1/pipeline``       ``{"mask": ..., "stages": [op, ...]}`` -> the
                              terminal stage's result, computed
                              device-resident end to end
  ``POST /v1/analyze_batch``  masks -> chunked NDJSON, one line per result
                              **in completion order** (a slow mask never
                              blocks the lines behind it; shed masks get
                              per-line 429 errors while admitted ones
                              stream normally)

The RPC transport speaks :func:`protocol.pack_frame` frames over TCP with
the same completion-order discipline: many analyzes may be in flight per
connection and responses demux by ``id``. Fleet verbs ride the same
transport: ``cache_probe`` (sibling cache lookup by serialized key, local
only) and ``set_peers`` (point a worker's peered cache at its siblings).

``ServerThread`` runs the whole thing on a dedicated event-loop thread for
synchronous callers (tests, the CLI smoke, benchmarks).
"""

from __future__ import annotations

import asyncio
import functools
import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

from repro_torch.engine import registry
from repro_torch.engine.ops import op_names
from repro_torch.frontend import protocol
from repro_torch.obs import PromBuilder, maybe_trace, recorder
from repro_torch.service import ServiceOverloaded, YCHGService
from repro_torch.service.metrics import bucket_labels

# request-trace propagation header: a client (or the fleet router) sends
# its trace id here and this process's spans join that trace
TRACE_HEADER = "x-ychg-trace"

# traffic-shaping headers (docs/traffic.md), lowercased to match
# _parse_head's header normalisation; the canonical spellings live in
# repro_torch.frontend.protocol next to the matching RPC frame fields
CLASS_HEADER = protocol.TRAFFIC_CLASS_HEADER.lower()
DEADLINE_HEADER = protocol.TRAFFIC_DEADLINE_HEADER.lower()
TENANT_HEADER = protocol.TRAFFIC_TENANT_HEADER.lower()

# executor width: how many clients may sit inside service.submit at once
# (under "block" each parked worker IS one unit of propagated backpressure)
DEFAULT_SUBMIT_WORKERS = 32


class _DrainRate:
    """Rolling completions/second estimate for Retry-After.

    Samples (monotonic time, completed count) at most once per interval;
    the rate is measured across the window between the oldest kept sample
    and now, so one quiet poll cannot zero it out.
    """

    def __init__(self, interval_s: float = 0.25, keep: int = 8):
        self._interval = interval_s
        self._keep = keep
        self._samples: list[Tuple[float, int]] = []

    def observe(self, completed: int) -> None:
        now = time.monotonic()
        if self._samples and now - self._samples[-1][0] < self._interval:
            return
        self._samples.append((now, completed))
        del self._samples[: -self._keep]

    def rate(self) -> float:
        if len(self._samples) < 2:
            return 0.0
        (t0, c0), (t1, c1) = self._samples[0], self._samples[-1]
        if t1 <= t0:
            return 0.0
        return max(0.0, (c1 - c0) / (t1 - t0))

    def retry_after_s(self, queue_depth: int) -> float:
        """Seconds until the current backlog plausibly drains; 1.0 when no
        drain has been observed yet (cold server), clamped to [0.05, 30]."""
        r = self.rate()
        if r <= 0.0:
            return 1.0
        return min(30.0, max(0.05, (queue_depth + 1) / r))


class FrontendServer:
    """One HTTP (and optionally one RPC) listener over one service."""

    def __init__(self, service: YCHGService, *, host: str = "127.0.0.1",
                 port: int = 0, rpc_port: Optional[int] = None,
                 submit_workers: int = DEFAULT_SUBMIT_WORKERS):
        self.service = service
        self.host = host
        self._want_port = port
        self._want_rpc_port = rpc_port
        self._pool = ThreadPoolExecutor(
            max_workers=submit_workers, thread_name_prefix="ychg-frontend")
        self._drain = _DrainRate()
        self._http_server: Optional[asyncio.AbstractServer] = None
        self._rpc_server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self._http_server = await asyncio.start_server(
            self._handle_http, self.host, self._want_port)
        if self._want_rpc_port is not None:
            self._rpc_server = await asyncio.start_server(
                self._handle_rpc, self.host, self._want_rpc_port)

    @property
    def port(self) -> int:
        assert self._http_server is not None, "server not started"
        return self._http_server.sockets[0].getsockname()[1]

    @property
    def rpc_port(self) -> Optional[int]:
        if self._rpc_server is None:
            return None
        return self._rpc_server.sockets[0].getsockname()[1]

    async def aclose(self) -> None:
        for srv in (self._http_server, self._rpc_server):
            if srv is not None:
                srv.close()
                await srv.wait_closed()
        # close established connections too, so peers see EOF instead of a
        # half-open socket (the fleet router relies on that to reroute
        # promptly when a worker goes away)
        for writer in list(self._conns):
            try:
                writer.close()
            except Exception:
                pass
        self._pool.shutdown(wait=False)

    # ----------------------------------------------------- service bridging

    async def _submit(self, mask, trace=None, op=None, stages=None,
                      traffic=None) -> Any:
        """submit on the executor (a "block" park never blocks the loop),
        then await the service future on the loop. ``trace`` joins the
        service's stage spans to this request's trace (the frontend stays
        the finisher). ``op`` selects a single operator; ``stages`` an
        ordered pipeline (mutually exclusive with ``op``). ``traffic`` is
        the validated klass/deadline_ms/tenant kwargs dict from
        :func:`protocol.decode_traffic`."""
        loop = asyncio.get_running_loop()
        traffic = traffic or {}
        if stages is not None:
            fn = functools.partial(self.service.submit_pipeline, mask,
                                   stages, trace=trace, **traffic)
        else:
            fn = functools.partial(self.service.submit, mask, op=op,
                                   trace=trace, **traffic)
        cf = await loop.run_in_executor(self._pool, fn)
        return await asyncio.wrap_future(cf)

    def _overload_body(self, exc: Exception) -> Tuple[Dict[str, Any], float]:
        """429 body + Retry-After for any admission shed. Deadline and
        quota sheds carry their own exact retry_after_s (the scheduler
        computed it at the shed); plain overload falls back to the
        frontend's drain-rate estimate over the current backlog."""
        m = self.service.metrics()
        self._drain.observe(m.completed)
        retry = getattr(exc, "retry_after_s", None)
        if retry is None:
            retry = self._drain.retry_after_s(m.queue_depth)
        kind = {"DeadlineExceeded": "deadline",
                "TenantQuotaExceeded": "quota"}.get(
                    type(exc).__name__, "overload")
        return ({"error": str(exc), "status": 429, "kind": kind,
                 "retry_after_s": round(retry, 3)}, retry)

    # ------------------------------------------------------------- HTTP side

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    break   # clean close between requests
                method, target, headers = _parse_head(head)
                body = b""
                try:
                    n = int(headers.get("content-length", "0") or "0")
                except ValueError:
                    await _respond_json(writer, 400, {
                        "error": "malformed Content-Length"}, False)
                    break
                if n > protocol.MAX_FRAME_BYTES or n < 0:
                    # same bound as the RPC transport: reject before
                    # buffering, a Content-Length is just a claim
                    await _respond_json(writer, 413, {
                        "error": f"body of {n} bytes exceeds "
                                 f"{protocol.MAX_FRAME_BYTES}"}, False)
                    break
                if n:
                    body = await reader.readexactly(n)
                keep = headers.get("connection", "").lower() != "close"
                keep = await self._route(method, target, body, writer, keep,
                                         headers)
                if not keep:
                    break
        except (ConnectionError, asyncio.LimitOverrunError,
                asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method: str, target: str, body: bytes,
                     writer: asyncio.StreamWriter, keep: bool,
                     headers: Optional[Dict[str, str]] = None) -> bool:
        """Dispatch one request; returns whether to keep the connection."""
        h = headers or {}
        trace_id = h.get(TRACE_HEADER) or None
        try:
            # validated once per request: a malformed class/deadline/tenant
            # header is a 400 via the ProtocolError handler below, never
            # a silently-dropped field
            traffic = protocol.decode_traffic(
                klass=h.get(CLASS_HEADER),
                deadline_ms=h.get(DEADLINE_HEADER),
                tenant=h.get(TENANT_HEADER))
            if method == "GET" and target == "/healthz":
                m = self.service.metrics()
                await _respond_json(writer, 200, {
                    "status": "ok", "backend": m.backend,
                    "queue_depth": m.queue_depth}, keep)
            elif method == "GET" and target == "/metrics":
                await _respond(writer, 200, self._render_metrics().encode(),
                               "text/plain; version=0.0.4", keep)
            elif method == "GET" and target == "/debug/traces":
                # the flight recorder's ring as Chrome-trace JSON — load it
                # straight into Perfetto/chrome://tracing
                await _respond(writer, 200,
                               recorder().to_chrome_json().encode(),
                               "application/json", keep)
            elif method == "POST" and target == "/v1/analyze":
                # kept alias: the pre-multi-op route is exactly /v1/ychg
                await self._http_analyze(body, writer, keep, trace_id,
                                         traffic=traffic)
            elif method == "POST" and target == "/v1/analyze_batch":
                await self._http_analyze_batch(body, writer, trace_id,
                                               traffic=traffic)
                keep = False   # chunked stream ends the exchange
            elif method == "POST" and target == "/v1/pipeline":
                await self._http_pipeline(body, writer, keep, trace_id,
                                          traffic=traffic)
            elif method == "POST" and target.startswith("/v1/"):
                opname = target[len("/v1/"):]
                if opname in op_names():
                    await self._http_analyze(body, writer, keep, trace_id,
                                             op=opname, traffic=traffic)
                else:
                    await _respond_json(writer, 404, {
                        "error": f"unknown op {opname!r}",
                        "ops": list(op_names())}, keep)
            else:
                await _respond_json(writer, 404, {
                    "error": f"no route for {method} {target}"}, keep)
        except protocol.ProtocolError as e:
            await _respond_json(writer, 400, {"error": str(e)}, keep)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            await _respond_json(writer, 400, {"error": f"bad request: {e}"},
                                keep)
        except ConnectionError:
            raise   # the client is gone; nothing left to answer
        except Exception as e:
            # a failing submit (service closing, backend error) must come
            # back as a 500, not a dropped connection the client retries
            await _respond_json(writer, 500, {"error": str(e)}, keep)
        return keep

    async def _http_analyze(self, body: bytes, writer: asyncio.StreamWriter,
                            keep: bool, trace_id: Optional[str] = None,
                            op: Optional[str] = None,
                            traffic: Optional[Dict[str, Any]] = None) -> None:
        tr = maybe_trace(trace_id, process="frontend")
        try:
            t0 = time.monotonic()
            payload = json.loads(body)
            mask = protocol.decode_array(payload["mask"])
            tr.add("frontend.parse", t0, time.monotonic(),
                   bytes=len(body))
            try:
                result = await self._submit(mask, tr, op=op, traffic=traffic)
            except ServiceOverloaded as e:
                out, retry = self._overload_body(e)
                await _respond_json(
                    writer, 429, out, keep,
                    extra=[("Retry-After", str(max(1, math.ceil(retry))))])
                return
            await _respond_json(
                writer, 200,
                {"id": payload.get("id"),
                 "result": protocol.encode_result(
                     result, op or self.service.engine.op)},
                keep)
        finally:
            # the frontend created this trace (possibly adopting the
            # client's id), so the frontend finishes it — on every path
            tr.finish()

    async def _http_pipeline(self, body: bytes, writer: asyncio.StreamWriter,
                             keep: bool,
                             trace_id: Optional[str] = None,
                             traffic: Optional[Dict[str, Any]] = None) -> None:
        """One mask through an ordered op chain; answers with the terminal
        stage's result fields. Spec errors (unknown op, terminal op mid-
        chain, empty stage list) come back 400 via the route's ValueError
        handler."""
        tr = maybe_trace(trace_id, process="frontend")
        try:
            t0 = time.monotonic()
            payload = json.loads(body)
            stages = payload.get("stages")
            if (not isinstance(stages, list) or
                    not all(isinstance(s, str) for s in stages)):
                raise protocol.ProtocolError(
                    "'stages' must be a list of op names")
            mask = protocol.decode_array(payload["mask"])
            tr.add("frontend.parse", t0, time.monotonic(), bytes=len(body))
            try:
                result = await self._submit(mask, tr, stages=stages,
                                            traffic=traffic)
            except ServiceOverloaded as e:
                out, retry = self._overload_body(e)
                await _respond_json(
                    writer, 429, out, keep,
                    extra=[("Retry-After", str(max(1, math.ceil(retry))))])
                return
            await _respond_json(
                writer, 200,
                {"id": payload.get("id"),
                 "result": protocol.encode_result(result, stages[-1])},
                keep)
        finally:
            tr.finish()

    async def _http_analyze_batch(self, body: bytes,
                                  writer: asyncio.StreamWriter,
                                  trace_id: Optional[str] = None,
                                  traffic: Optional[Dict[str, Any]] = None,
                                  ) -> None:
        """Chunked NDJSON, one line per mask in COMPLETION order."""
        tr = maybe_trace(trace_id, process="frontend")
        t0 = time.monotonic()
        payload = json.loads(body)
        items = payload["masks"]
        if not isinstance(items, list):
            raise protocol.ProtocolError("'masks' must be a list")
        tr.add("frontend.parse", t0, time.monotonic(), bytes=len(body),
               masks=len(items))

        async def run_one(i: int, item: Dict[str, Any]) -> Dict[str, Any]:
            rid = item.get("id", i)
            try:
                mask = protocol.decode_array(item)
                result = await self._submit(mask, tr, traffic=traffic)
            except ServiceOverloaded as e:
                out, _ = self._overload_body(e)
                out["id"] = rid
                return out
            except protocol.ProtocolError as e:
                return {"id": rid, "error": str(e), "status": 400}
            except Exception as e:   # a failed request must not kill the stream
                return {"id": rid, "error": str(e), "status": 500}
            return {"id": rid, "result": protocol.encode_result(result)}

        writer.write(_head(200, "application/x-ndjson", keep=False,
                           chunked=True))
        tasks = [asyncio.ensure_future(run_one(i, it))
                 for i, it in enumerate(items)]
        try:
            for fut in asyncio.as_completed(tasks):
                line = protocol.dumps_line(await fut)
                writer.write(_chunk(line))
                await writer.drain()   # slow client -> backpressure here
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            for t in tasks:
                t.cancel()
            tr.finish()

    def _render_metrics(self) -> str:
        """ServiceMetrics in Prometheus text exposition format."""
        m = self.service.metrics()
        self._drain.observe(m.completed)
        b = PromBuilder()
        b.counter("ychg_submitted_total", m.submitted,
                  "requests accepted by submit()")
        b.counter("ychg_completed_total", m.completed,
                  "futures fulfilled (cache hits + computed)")
        b.counter("ychg_completed_from_cache_total", m.completed_from_cache,
                  "completions served straight from the result cache")
        b.counter("ychg_cache_hits_total", m.cache_hits,
                  "result-cache lookups that hit")
        b.counter("ychg_cache_misses_total", m.cache_misses,
                  "result-cache lookups that missed")
        b.counter("ychg_coalesced_total", m.coalesced,
                  "duplicate in-flight requests joined to a leader")
        b.counter("ychg_batches_total", m.batches,
                  "bucket stacks dispatched to the engine")
        b.counter("ychg_shed_total", m.shed,
                  "submits rejected with ServiceOverloaded")
        b.counter("ychg_blocked_total", m.blocked,
                  "submits that waited at the admission gate")
        b.counter("ychg_cache_peer_hits_total", m.peer_hits,
                  "local misses served by a sibling's cache")
        b.counter("ychg_cache_peer_misses_total", m.peer_misses,
                  "outbound peer probes no sibling could answer")
        b.counter("ychg_keys_on_device_total", m.keys_on_device,
                  "cache probes whose content digest was taken on the card")
        b.counter("ychg_keys_on_host_total", m.keys_on_host,
                  "cache probes whose content digest was taken on the host")
        b.counter("ychg_key_copies_pinned_total", m.key_copies_pinned,
                  "copies onto the card for a key staged through "
                  "page-locked memory")
        b.counter("ychg_key_copies_pageable_total", m.key_copies_pageable,
                  "copies onto the card for a key that fell back to "
                  "pageable memory")
        b.header("ychg_shed_bucket_total", "counter",
                 "sheds attributed to the rejected request's bucket")
        for bucket, count in m.shed_by_bucket:
            b.sample("ychg_shed_bucket_total", bucket_labels(bucket), count)
        # traffic-shaping attribution (docs/traffic.md): every shed lands
        # in the class counter; quota sheds additionally name the tenant
        b.counter("ychg_shed_deadline_total", m.shed_deadline,
                  "submits shed because the predicted delay exceeded "
                  "their deadline")
        b.counter("ychg_shed_quota_total", m.shed_quota,
                  "submits shed by a tenant token bucket")
        b.header("ychg_shed_class_total", "counter",
                 "sheds attributed to the rejected request's traffic class")
        for klass, count in m.shed_by_class:
            b.sample("ychg_shed_class_total", (("class", klass),), count)
        b.header("ychg_shed_tenant_total", "counter",
                 "quota sheds attributed to the over-quota tenant")
        for tenant, count in m.shed_by_tenant:
            b.sample("ychg_shed_tenant_total", (("tenant", tenant),), count)
        b.gauge("ychg_queue_depth", m.queue_depth,
                "requests waiting + pending-in-bucket")
        b.gauge("ychg_hit_rate", m.hit_rate, "cache hit rate")
        b.gauge("ychg_p50_latency_ms", m.p50_latency_ms,
                "median request latency from the histogram, compute only")
        b.gauge("ychg_p95_latency_ms", m.p95_latency_ms,
                "p95 request latency from the histogram, compute only")
        b.gauge("ychg_mpx_per_s", m.mpx_per_s,
                "real request pixels served per active second")
        b.gauge("ychg_pad_fraction", m.pad_fraction,
                "dispatched pixels that were padding")
        b.gauge("ychg_compiled_shapes", m.n_compiled_shapes,
                "distinct dispatched batch shapes")
        b.gauge("ychg_drain_rate_rps", round(self._drain.rate(), 3),
                "observed completion rate feeding Retry-After")
        b.gauge("ychg_backend_info", 1,
                "resolved engine backend as a label",
                labels=(("backend", m.backend),))
        # scene/bulk workload progress (repro_torch.scene), attached via
        # service.attach_scene_progress(); all zero when none is running
        b.gauge("ychg_scene_tiles_done", m.scene_tiles_done,
                "scene tiles stitched so far")
        b.gauge("ychg_scene_tiles_total", m.scene_tiles_total,
                "scene tiles expected")
        b.counter("ychg_scene_resumes_total", m.scene_resumes,
                  "checkpoint restores across the scene job")
        b.gauge("ychg_scene_stitch_seconds", round(m.scene_stitch_time_s, 6),
                "host-side seam/stitch time accumulated")
        # fixed-boundary histograms: end-to-end latency per request bucket,
        # per-stage timing, and the engine's synchronous dispatch cost —
        # the boundaries are module constants, so a fleet rollup may sum
        # these series across workers exactly
        b.histogram("ychg_request_latency_seconds", m.latency_hists,
                    "submit -> result ready, compute completions only")
        b.histogram("ychg_stage_seconds", m.stage_hists,
                    "per-stage request timing (docs/observability.md)")
        b.histogram(
            "ychg_engine_dispatch_seconds",
            [((("op", op), ("backend", name)), snap)
             for (op, name), snap in
             sorted(registry.dispatch_seconds().items())],
            "synchronous engine dispatch cost per (op, backend)")
        return b.render()

    # -------------------------------------------------------------- RPC side

    def _cache_probe(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Sibling cache lookup by serialized key (hex). Purely local:
        answers out of this worker's cache index or says miss — it never
        computes and never probes onward, so fleet probes cannot cascade.
        The hit carries the STORED entry layout ((1, W)/(1,) arrays, not
        ``to_host()``'s squeezed view) so the prober can reconstruct a
        device-resident result indistinguishable from its own cache's."""
        rid = frame.get("id")
        try:
            skey = bytes.fromhex(frame["key"])
            fields = protocol.result_fields(
                str(frame.get("opname", "ychg")))
        except (KeyError, TypeError, ValueError,
                protocol.ProtocolError) as e:
            return {"id": rid, "error": f"bad cache_probe frame: {e}",
                    "status": 400}
        entry = self.service.cache.probe_serialized(skey)
        if entry is None:
            return {"id": rid, "hit": False}
        # the stored fields live on the engine's device: copy each to the
        # host (np.asarray of a CUDA tensor raises)
        return {"id": rid, "hit": True, "result": {
            f: protocol.encode_array(getattr(entry, f).cpu().numpy())
            for f in fields}}

    def _set_peers(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Point this worker's cache at its siblings ([host, rpc_port]
        pairs). ``ok: false`` when the cache cannot peer (plain
        ResultCache) — the router treats that as a worker without the
        feature, not an error."""
        rid = frame.get("id")
        set_peers = getattr(self.service.cache, "set_peers", None)
        if set_peers is None:
            return {"id": rid, "ok": False}
        try:
            peers = [(str(h), int(p)) for h, p in frame.get("peers", [])]
        except (TypeError, ValueError) as e:
            return {"id": rid, "error": f"bad set_peers payload: {e}",
                    "status": 400, "ok": False}
        set_peers(peers)
        return {"id": rid, "ok": True}

    def _rpc_verb(self, op: str, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Answer one of the synchronous RPC verbs."""
        if op == "health":
            m = self.service.metrics()
            return {"id": frame.get("id"), "status": "ok",
                    "backend": m.backend, "queue_depth": m.queue_depth}
        if op == "cache_probe":
            return self._cache_probe(frame)
        return self._set_peers(frame)

    async def _handle_rpc(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """Frame loop: many analyzes in flight, responses in completion
        order, demuxed by id on the client side."""
        self._conns.add(writer)
        wlock = asyncio.Lock()
        tasks: set = set()

        async def send(obj: Dict[str, Any]) -> None:
            async with wlock:
                writer.write(protocol.pack_frame(obj))
                await writer.drain()

        async def run_analyze(frame: Dict[str, Any]) -> None:
            rid = frame.get("id")
            # the RPC frame's "trace" field is the fleet's propagation
            # seam: a router puts its trace id here and this worker's
            # spans join the router's trace. "opname" selects the
            # operator (the frame key "op" is already the RPC verb);
            # "stages" instead runs an ordered pipeline.
            tr = maybe_trace(frame.get("trace") or None, process="worker")
            try:
                t0 = time.monotonic()
                opname = frame.get("opname")
                stages = frame.get("stages")
                if opname is not None and opname not in op_names():
                    await send({"id": rid,
                                "error": f"unknown op {opname!r}",
                                "ops": list(op_names()), "status": 404})
                    return
                # the frame fields mirror the HTTP headers one to one
                # (protocol.decode_traffic is the shared validator)
                traffic = protocol.decode_traffic(
                    klass=frame.get("klass"),
                    deadline_ms=frame.get("deadline_ms"),
                    tenant=frame.get("tenant"))
                mask = protocol.decode_array(frame["mask"])
                tr.add("frontend.parse", t0, time.monotonic())
                if stages is not None:
                    result = await self._submit(mask, tr, stages=stages,
                                                traffic=traffic)
                    wire_op = str(stages[-1])
                else:
                    result = await self._submit(mask, tr, op=opname,
                                                traffic=traffic)
                    wire_op = opname or self.service.engine.op
            except ServiceOverloaded as e:
                out, _ = self._overload_body(e)
                out["id"] = rid
                await send(out)
                return
            except (protocol.ProtocolError, KeyError, ValueError) as e:
                await send({"id": rid, "error": str(e), "status": 400})
                return
            except Exception as e:
                await send({"id": rid, "error": str(e), "status": 500})
                return
            finally:
                tr.finish()
            await send({"id": rid,
                        "result": protocol.encode_result(result, wire_op)})

        try:
            while True:
                try:
                    frame = await protocol.read_frame(reader)
                except protocol.ProtocolError as e:
                    await send({"error": str(e), "status": 400})
                    break
                if frame is None:
                    break
                op = frame.get("op")
                if op in ("analyze", "pipeline"):
                    # "pipeline" is "analyze" with a required stages list;
                    # both demux by id and share the in-flight discipline
                    if op == "pipeline" and not frame.get("stages"):
                        await send({"id": frame.get("id"),
                                    "error": "pipeline needs a non-empty "
                                             "'stages' list", "status": 400})
                        continue
                    t = asyncio.ensure_future(run_analyze(frame))
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
                elif op in ("health", "cache_probe", "set_peers"):
                    try:
                        out = self._rpc_verb(op, frame)
                    except Exception as e:
                        # one verb's failure answers its own frame; the
                        # connection and its other calls stay up
                        out = {"id": frame.get("id"), "error": str(e),
                               "status": 500}
                    await send(out)
                else:
                    await send({"id": frame.get("id"),
                                "error": f"unknown op {op!r}", "status": 400})
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
        except (ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(writer)
            for t in tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


# ------------------------------------------------------------ HTTP plumbing


def _parse_head(head: bytes) -> Tuple[str, str, Dict[str, str]]:
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, _version = lines[0].split(" ", 2)
    except ValueError:
        raise protocol.ProtocolError(f"bad request line {lines[0]!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    return method, target, headers


_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           413: "Payload Too Large", 429: "Too Many Requests",
           500: "Internal Server Error"}


def _head(status: int, content_type: str, *, keep: bool,
          chunked: bool = False, length: Optional[int] = None,
          extra: Optional[list] = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_STATUS.get(status, 'Status')}",
             f"Content-Type: {content_type}",
             f"Connection: {'keep-alive' if keep else 'close'}"]
    if chunked:
        lines.append("Transfer-Encoding: chunked")
    else:
        lines.append(f"Content-Length: {length or 0}")
    for name, value in (extra or []):
        lines.append(f"{name}: {value}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _chunk(data: bytes) -> bytes:
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


async def _respond(writer: asyncio.StreamWriter, status: int, body: bytes,
                   content_type: str, keep: bool,
                   extra: Optional[list] = None) -> None:
    writer.write(_head(status, content_type, keep=keep, length=len(body),
                       extra=extra) + body)
    await writer.drain()


async def _respond_json(writer: asyncio.StreamWriter, status: int,
                        obj: Any, keep: bool,
                        extra: Optional[list] = None) -> None:
    await _respond(writer, status, json.dumps(obj).encode(),
                   "application/json", keep, extra)


# -------------------------------------------------------- sync entry point


class ServerThread:
    """A `FrontendServer` on its own event-loop thread, for sync callers.

    ::

        with ServerThread(service) as srv:
            client = YCHGClient("127.0.0.1", srv.port)
            ...

    Startup errors (port in use, bad host) re-raise in the constructor;
    ``close()`` stops the loop and joins the thread.
    """

    def __init__(self, service: YCHGService, *, host: str = "127.0.0.1",
                 port: int = 0, rpc_port: Optional[int] = None,
                 start_timeout: float = 30.0, **kw: Any):
        self._server = FrontendServer(service, host=host, port=port,
                                      rpc_port=rpc_port, **kw)
        self._ready = threading.Event()
        self._stop: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._exc: Optional[BaseException] = None
        self.port: Optional[int] = None
        self.rpc_port: Optional[int] = None
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._main()),
            name="ychg-frontend-server", daemon=True)
        self._thread.start()
        if not self._ready.wait(start_timeout):
            raise RuntimeError("frontend server failed to start in time")
        if self._exc is not None:
            raise self._exc

    async def _main(self) -> None:
        try:
            await self._server.start()
            self.port = self._server.port
            self.rpc_port = self._server.rpc_port
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
        except BaseException as e:
            self._exc = e
            self._ready.set()
            return
        self._ready.set()
        await self._stop.wait()
        await self._server.aclose()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop and join; idempotent — fleet tests kill a worker
        mid-test and the teardown sweep closes everything again."""
        if self._loop is not None and self._stop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:   # loop already closed
                pass
        self._thread.join(timeout)

    def __enter__(self) -> "ServerThread":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
