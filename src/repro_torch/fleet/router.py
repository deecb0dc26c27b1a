"""`FleetRouter` — one HTTP front end over N worker processes.

The port's counterpart of ``repro.fleet.router``, with one deliberate
divergence: a worker that answers ``"service is closed"`` (a draining
service) is treated like a transport failure, marked down and walked
past, where the JAX router returns that 500 to the client (see
:meth:`FleetRouter._forward`). The supervisor keeps each worker's stderr
in a temporary file and quotes its tail when a worker never handshakes.

The router owns no engine: it consistent-hashes each request's
process-stable serialized cache key onto a worker slot
(:mod:`repro_torch.fleet.hashring`) and forwards the client's *original encoded
mask payload* through the worker's framed RPC untouched — no re-encode on
either hop, which is what keeps the router path trivially bit-identical
to in-process ``YCHGService.submit`` (``launch.serve --fleet-smoke`` holds
it to byte equality). Same mask -> same worker, so the fleet coalesces and
caches exactly like one big process.

Admission reuses the service's own DRR :class:`~repro_torch.service.
scheduler.Scheduler` verbatim — per-``(side, dtype)`` bucket bounds, block/shed
policy, deficit-round-robin fairness — with "dispatch" meaning "schedule
the forward coroutines on the router loop" instead of "run a kernel", so
one hot resolution floods its own allowance while minority traffic keeps
flowing, one layer above where the same policy already protects each
worker.

Failure handling is deterministic: a dead worker's keys fail over to the
next node on the ring walk (always the same survivor), the health loop
notices and — when a :class:`FleetSupervisor` is attached — restarts the
worker under its old slot name, so it resumes its old keyspace with an
empty cache and the peered-cache probe refills it from the survivor.

``GET /metrics`` rolls every worker's Prometheus page plus the router's
own counters into one page: worker ``*_total`` series are summed
(labelled series summed per label set) and each worker contributes a
``ychg_fleet_worker_up`` gauge.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.engine.ops import op_names
from repro_torch.fleet.hashring import HashRing
from repro_torch.fleet.worker import parse_ready_line
from repro_torch.frontend import protocol
from repro_torch.frontend.client import AsyncRPCClient, FrontendError
from repro_torch.frontend.server import (
    CLASS_HEADER,
    DEADLINE_HEADER,
    TENANT_HEADER,
    TRACE_HEADER,
    _chunk,
    _DrainRate,
    _head,
    _parse_head,
    _respond,
    _respond_json,
)
from repro_torch.obs import (
    NULL_TRACE,
    PromBuilder,
    base_family,
    maybe_trace,
    parse_prom_text,
    recorder,
)
from repro_torch.service.batching import pick_bucket_side
from repro_torch.service.cache import make_key, serialize_key
from repro_torch.service.scheduler import (
    Scheduler,
    SchedulerConfig,
    ServiceOverloaded,
)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router policy knobs.

    bucket_sides/max_batch/max_delay_ms/queue depths/overload_policy feed
    the router-side DRR admission scheduler (same semantics as
    ``ServiceConfig``); ``max_delay_ms`` defaults to 0 because batching-
    for-the-device is the workers' job — the router's scheduler exists for
    admission and fairness, not latency trading. ``inflight_slices``
    bounds outstanding forwarded slices; ``forward_timeout_s`` is one
    forward's whole budget (generous: a worker's first flush compiles);
    ``health_interval_s`` paces the liveness loop; ``replicas`` is the
    ring's virtual-node count.
    """

    bucket_sides: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    max_batch: int = 8
    max_delay_ms: float = 0.0
    inflight_slices: int = 16
    max_queue_depth: Optional[int] = None
    bucket_queue_depth: Optional[int] = None
    overload_policy: str = "block"
    forward_timeout_s: float = 300.0
    health_interval_s: float = 1.0
    replicas: int = 64
    # traffic classes + tenant quotas (docs/traffic.md): the router is
    # the fleet's admission edge, so quota and deadline sheds happen HERE,
    # before any worker sees a byte of the request
    classes: Tuple[str, ...] = ("interactive", "standard", "batch")
    default_class: str = "standard"
    tenant_rate: float = 0.0
    tenant_burst: float = 0.0

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            max_batch=self.max_batch,
            max_delay_ms=self.max_delay_ms,
            inflight_jobs=self.inflight_slices,
            max_queue_depth=self.max_queue_depth,
            bucket_queue_depth=self.bucket_queue_depth,
            overload_policy=self.overload_policy,
            sub_batches=True,
            fair=True,
            classes=self.classes,
            default_class=self.default_class,
            tenant_rate=self.tenant_rate,
            tenant_burst=self.tenant_burst,
        )


@dataclasses.dataclass
class WorkerLink:
    """One worker slot: a STABLE name plus wherever it currently listens.

    The name ("w0", "w1", ...) is the ring identity; host/ports may change
    across restarts without moving any keys."""

    name: str
    host: str
    rpc_port: int
    http_port: int
    process: Optional[subprocess.Popen] = None
    up: bool = True


@dataclasses.dataclass
class _RouterRequest:
    """One admitted request riding the scheduler: the original encoded
    mask payload (forwarded untouched), its routing key, and the future
    the HTTP handler awaits for the worker's response frame."""

    payload: Dict[str, Any]
    skey: bytes
    bucket: Tuple[str, int, str]
    t_submit: float
    future: Future
    op_key: str = "ychg"
    stages: Optional[List[str]] = None
    served_by: Optional[str] = None
    trace: Any = NULL_TRACE   # the HTTP handler's trace; spans join it
    # traffic-shaping fields the scheduler reads at admission; never part
    # of skey/bucket/payload, so a classed forward stays bit-identical
    klass: Optional[str] = None
    deadline_ms: Optional[float] = None
    tenant: Optional[str] = None


def _is_closing(frame: Dict[str, Any]) -> bool:
    """True for a worker's answer that its service is draining (the port's
    ``Service`` raises ``RuntimeError("service is closed")`` once closed,
    and the worker's RPC loop answers it as a 500)."""
    return (frame.get("status") == 500
            and frame.get("error") == "service is closed")


def routing_key(mask: np.ndarray, op: str = "ychg") -> bytes:
    """The placement key for a mask: the serialized cache key with the
    policy components pinned to fleet constants. All workers run one
    policy, so backend/config would be the same bytes in every key —
    placement only ever depends on (content, shape, dtype, op), exactly
    the components :func:`serialize_key` renders process-stably. The op
    qualifies the key so the same mask under two ops lands wherever its
    cache entry would live (entries are namespaced per op)."""
    return serialize_key(
        make_key(np.ascontiguousarray(mask), "fleet", None, op=op))


class FleetRouter:
    """Route requests over worker links; serve one HTTP front end."""

    def __init__(self, links: Sequence[WorkerLink],
                 config: RouterConfig = RouterConfig(), *,
                 host: str = "127.0.0.1", port: int = 0,
                 supervisor: Optional["FleetSupervisor"] = None):
        if not links:
            raise ValueError("FleetRouter needs at least one worker link")
        self.config = config
        self.host = host
        self._want_port = port
        self._links: Dict[str, WorkerLink] = {l.name: l for l in links}
        self._ring = HashRing([l.name for l in links], config.replicas)
        self._supervisor = supervisor
        self._clients: Dict[str, AsyncRPCClient] = {}
        self._restarting: set = set()
        self._pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="ychg-router")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._http_server: Optional[asyncio.AbstractServer] = None
        self._health_task: Optional[asyncio.Task] = None
        # loop-thread-only counters (every mutation runs on the loop)
        self.routed_total = 0
        self.rerouted_total = 0
        self.unroutable_total = 0
        self.completed_total = 0
        # completion-rate estimator feeding the router's own 429
        # Retry-After (same rolling-window class the frontend uses);
        # observed and read on the loop thread only
        self._drain = _DrainRate()
        self._scheduler = Scheduler(
            config.scheduler_config(),
            dispatch=self._dispatch,
            complete=self._complete,
            fail=self._fail,
        )

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._http_server = await asyncio.start_server(
            self._handle_http, self.host, self._want_port)
        await self.broadcast_peers()
        self._health_task = asyncio.ensure_future(self._health_loop())

    @property
    def port(self) -> int:
        assert self._http_server is not None, "router not started"
        return self._http_server.sockets[0].getsockname()[1]

    async def aclose(self) -> None:
        """Drain-on-shutdown: stop accepting, let admitted forwards
        finish, then drop worker connections."""
        if self._health_task is not None:
            self._health_task.cancel()
        if self._http_server is not None:
            self._http_server.close()
            await self._http_server.wait_closed()
        # scheduler.close drains: every admitted forward completes or fails
        await asyncio.get_running_loop().run_in_executor(
            self._pool, self._scheduler.close)
        for client in list(self._clients.values()):
            try:
                await client.aclose()
            except (ConnectionError, OSError):
                pass
        self._clients.clear()
        self._pool.shutdown(wait=False)

    # -------------------------------------------------- scheduler callbacks

    def _dispatch(self, bucket, requests: List[_RouterRequest],
                  batch_size: int) -> List[Future]:
        """"Dispatch" a slice = start its forwards on the router loop;
        the list of concurrent futures is the job handle."""
        assert self._loop is not None, "router not started"
        return [asyncio.run_coroutine_threadsafe(self._forward(r), self._loop)
                for r in requests]

    def _complete(self, handle: List[Future],
                  requests: List[_RouterRequest]) -> None:
        """Retire a slice: block (scheduler thread) until each forward
        lands, then fan frames/errors out to the handlers' futures."""
        deadline = time.monotonic() + self.config.forward_timeout_s
        for fut, req in zip(handle, requests):
            try:
                frame = fut.result(
                    timeout=max(0.1, deadline - time.monotonic()))
            except Exception as e:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)
                continue
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(frame)

    def _fail(self, requests: List[_RouterRequest], exc: Exception) -> None:
        for req in requests:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)

    # ------------------------------------------------------------ forwarding

    def _alive(self) -> List[str]:
        return [name for name, l in self._links.items() if l.up]

    async def _client(self, name: str) -> AsyncRPCClient:
        client = self._clients.get(name)
        if client is None:
            link = self._links[name]
            client = AsyncRPCClient(link.host, link.rpc_port)
            await client.connect()
            self._clients[name] = client
        return client

    def _drop_client(self, name: str) -> None:
        client = self._clients.pop(name, None)
        if client is not None and client._writer is not None:
            client._writer.close()

    async def _forward(self, req: _RouterRequest) -> Dict[str, Any]:
        """Forward one request to its ring owner, walking the preference
        order past downed/failing workers. A worker that ANSWERS (even
        with an error status) ends the walk — only transport failures
        reroute, so a deterministic 4xx/5xx never retries elsewhere. One
        answer counts as a transport failure: a draining worker's 500
        ``"service is closed"`` says nothing about the request, only
        that the worker is going away, so the walk goes on past it (the
        JAX router returns it to the client)."""
        t0 = time.monotonic()
        call_frame: Dict[str, Any] = {"op": "analyze", "mask": req.payload}
        if req.stages is not None:
            call_frame["op"] = "pipeline"
            call_frame["stages"] = req.stages
        elif req.op_key != "ychg":
            call_frame["opname"] = req.op_key
        if req.trace.enabled:
            # the RPC frame field mirroring the HTTP X-YCHG-Trace header:
            # the worker's spans join this router-side trace id
            call_frame["trace"] = req.trace.trace_id
        # the class rides to the worker so its own scheduler honours the
        # priority; deadline/tenant do NOT — both were already enforced at
        # this edge, and re-charging a tenant token per hop would double-
        # bill the quota
        if req.klass is not None:
            call_frame["klass"] = req.klass
        last_exc: Optional[Exception] = None
        first = True
        for name in self._ring.preference(req.skey):
            link = self._links[name]
            if not link.up:
                first = False
                continue
            try:
                client = await self._client(name)
                frame = await asyncio.wait_for(
                    client.call(call_frame),
                    timeout=self.config.forward_timeout_s)
                if _is_closing(frame):
                    raise FrontendError(f"worker {name}: {frame['error']}",
                                        status=503)
            except Exception as e:
                last_exc = e
                self._mark_down(name)
                first = False
                continue
            self.routed_total += 1
            if not first:
                self.rerouted_total += 1
            req.served_by = name
            req.trace.add("router.forward", t0, time.monotonic(),
                          worker=name, rerouted=not first)
            return frame
        self.unroutable_total += 1
        req.trace.add("router.forward", t0, time.monotonic(),
                      outcome="unroutable")
        raise FrontendError(
            f"no live worker could serve this request "
            f"(last error: {last_exc})", status=503)

    def _mark_down(self, name: str) -> None:
        link = self._links[name]
        if link.up:
            link.up = False
        self._drop_client(name)

    # ---------------------------------------------------- health + restarts

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.health_interval_s)
            try:
                await self.check_workers()
            except asyncio.CancelledError:
                raise
            except Exception:
                pass   # the health loop must outlive any one bad cycle

    async def check_workers(self) -> Dict[str, bool]:
        """One liveness pass: ping every link's RPC health; mark, and
        (with a supervisor) restart, the dead ones."""
        status: Dict[str, bool] = {}
        for name, link in list(self._links.items()):
            alive = False
            if not (link.process is not None
                    and link.process.poll() is not None):
                try:
                    client = await self._client(name)
                    await asyncio.wait_for(client.health(), timeout=5.0)
                    alive = True
                except Exception:
                    alive = False
            if alive:
                link.up = True
            else:
                self._mark_down(name)
                if self._supervisor is not None:
                    await self._restart(name)
                    alive = self._links[name].up
            status[name] = alive
        return status

    async def _restart(self, name: str) -> None:
        """Respawn one worker slot (same name -> same keyspace) off-loop,
        then reconnect and re-broadcast the peer set."""
        if name in self._restarting:
            return
        self._restarting.add(name)
        try:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                self._pool, self._supervisor.restart, name)
            self._drop_client(name)
            self._links[name].up = True
            await self.broadcast_peers()
        except Exception:
            self._links[name].up = False
        finally:
            self._restarting.discard(name)

    async def broadcast_peers(self) -> None:
        """Tell every worker where its siblings' RPC ports are (each
        worker's peer set excludes itself)."""
        for name, link in self._links.items():
            if not link.up:
                continue
            peers = [[l.host, l.rpc_port]
                     for n, l in self._links.items() if n != name]
            try:
                client = await self._client(name)
                await asyncio.wait_for(
                    client.call({"op": "set_peers", "peers": peers}),
                    timeout=5.0)
            except Exception:
                self._mark_down(name)

    # ------------------------------------------------------------- HTTP side

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    break
                method, target, headers = _parse_head(head)
                try:
                    n = int(headers.get("content-length", "0") or "0")
                except ValueError:
                    await _respond_json(writer, 400, {
                        "error": "malformed Content-Length"}, False)
                    break
                if n > protocol.MAX_FRAME_BYTES or n < 0:
                    await _respond_json(writer, 413, {
                        "error": f"body of {n} bytes exceeds "
                                 f"{protocol.MAX_FRAME_BYTES}"}, False)
                    break
                body = await reader.readexactly(n) if n else b""
                keep = headers.get("connection", "").lower() != "close"
                keep = await self._route(method, target, body, writer, keep,
                                         headers)
                if not keep:
                    break
        except (ConnectionError, asyncio.LimitOverrunError,
                asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method: str, target: str, body: bytes,
                     writer: asyncio.StreamWriter, keep: bool,
                     headers: Optional[Dict[str, str]] = None) -> bool:
        h = headers or {}
        trace_id = h.get(TRACE_HEADER) or None
        try:
            # decoded inside the try: a malformed class/deadline/tenant is
            # a 400 at the fleet edge, same as at the single-process edge
            traffic = protocol.decode_traffic(
                klass=h.get(CLASS_HEADER), deadline_ms=h.get(DEADLINE_HEADER),
                tenant=h.get(TENANT_HEADER))
            if method == "GET" and target == "/healthz":
                await _respond_json(writer, 200, {
                    "status": "ok",
                    "workers": {n: l.up for n, l in self._links.items()},
                    "queue_depth": self._scheduler.backlog()}, keep)
            elif method == "GET" and target == "/metrics":
                page = await self._rollup_metrics()
                await _respond(writer, 200, page.encode(),
                               "text/plain; version=0.0.4", keep)
            elif method == "GET" and target == "/debug/traces":
                # router-side flight recorder only; worker rings are
                # served by each worker's own /debug/traces
                await _respond(writer, 200,
                               recorder().to_chrome_json().encode(),
                               "application/json", keep)
            elif method == "POST" and target == "/v1/analyze":
                # historical alias for /v1/ychg
                await self._http_analyze(body, writer, keep, trace_id,
                                         traffic=traffic)
            elif method == "POST" and target == "/v1/analyze_batch":
                await self._http_analyze_batch(body, writer, trace_id,
                                               traffic=traffic)
                keep = False
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
            raise
        except Exception as e:
            await _respond_json(writer, 500, {"error": str(e)}, keep)
        return keep

    async def _submit(self, item: Dict[str, Any],
                      trace: Any = None, op: Optional[str] = None,
                      stages: Optional[List[str]] = None,
                      traffic: Optional[Dict[str, Any]] = None,
                      ) -> Dict[str, Any]:
        """Admit one encoded mask through the DRR scheduler and await the
        worker's response frame. decode_array validates the payload and
        yields shape/dtype for the bucket + routing key; the DECODED mask
        goes no further — the worker gets the client's original bytes.
        ``traffic`` (klass/deadline_ms/tenant) rides the request into the
        scheduler, where quota and deadline admission run BEFORE any
        worker is touched."""
        tr = trace if trace is not None else NULL_TRACE
        traffic = traffic or {}
        mask = protocol.decode_array(item["mask"])
        side = pick_bucket_side(mask.shape, self.config.bucket_sides)
        op_key = "+".join(stages) if stages else (op or "ychg")
        req = _RouterRequest(
            payload=item["mask"], skey=routing_key(mask, op_key),
            bucket=(op_key, side, str(mask.dtype)),
            t_submit=time.monotonic(), future=Future(),
            op_key=op_key, stages=stages, trace=tr,
            klass=traffic.get("klass"),
            deadline_ms=traffic.get("deadline_ms"),
            tenant=traffic.get("tenant"))
        loop = asyncio.get_running_loop()
        # submit on the executor: a "block" park must not stall the loop
        t_gate = time.monotonic()
        await loop.run_in_executor(
            self._pool, self._scheduler.submit, req)
        tr.add("router.admission", t_gate, time.monotonic())
        frame = await asyncio.wrap_future(req.future)
        self.completed_total += 1
        self._drain.observe(self.completed_total)
        return frame

    def _retry_hint_s(self) -> float:
        """Measured Retry-After for a router-side shed: the observed
        completion rate over the current backlog (1.0 s only while cold —
        no completions observed yet)."""
        self._drain.observe(self.completed_total)
        return self._drain.retry_after_s(self._scheduler.backlog())

    def _shed_response(self, e: ServiceOverloaded) -> Dict[str, Any]:
        """The 429 body for a router-side shed. Quota/deadline sheds carry
        their own exact Retry-After on the exception; a plain overload
        shed falls back to the drain-rate estimate. ``kind`` names the
        check that tripped, same contract as the single-process edge."""
        retry = getattr(e, "retry_after_s", None)
        if retry is None:
            retry = self._retry_hint_s()
        kind = {"DeadlineExceeded": "deadline",
                "TenantQuotaExceeded": "quota"}.get(
                    type(e).__name__, "overload")
        return {"error": str(e), "status": 429, "kind": kind,
                "retry_after_s": round(retry, 3)}

    def _frame_to_response(self, frame: Dict[str, Any],
                           rid: Any) -> Tuple[int, Dict[str, Any]]:
        """A worker response frame -> (status, body), ids rewritten to the
        client's (the frame's id is the worker-connection-local RPC id)."""
        if "result" in frame:
            return 200, {"id": rid, "result": frame["result"]}
        out = {k: v for k, v in frame.items() if k != "id"}
        out["id"] = rid
        out.setdefault("error", "worker error")
        return int(frame.get("status", 500)), out

    async def _http_analyze(self, body: bytes, writer: asyncio.StreamWriter,
                            keep: bool,
                            trace_id: Optional[str] = None,
                            op: Optional[str] = None,
                            stages: Optional[List[str]] = None,
                            traffic: Optional[Dict[str, Any]] = None) -> None:
        tr = maybe_trace(trace_id, process="router")
        try:
            payload = json.loads(body)
            rid = payload.get("id")
            try:
                frame = await self._submit(payload, tr, op=op, stages=stages,
                                           traffic=traffic)
            except ServiceOverloaded as e:
                out = self._shed_response(e)
                retry = out["retry_after_s"]
                await _respond_json(
                    writer, 429, out, keep,
                    extra=[("Retry-After", str(max(1, math.ceil(retry))))])
                return
            except FrontendError as e:
                await _respond_json(writer, e.status, {
                    "error": str(e), "status": e.status}, keep)
                return
            status, out = self._frame_to_response(frame, rid)
            extra = None
            if status == 429 and out.get("retry_after_s") is not None:
                extra = [("Retry-After",
                          str(max(1,
                                  math.ceil(float(out["retry_after_s"])))))]
            await _respond_json(writer, status, out, keep, extra=extra)
        finally:
            tr.finish()

    async def _http_pipeline(self, body: bytes, writer: asyncio.StreamWriter,
                             keep: bool,
                             trace_id: Optional[str] = None,
                             traffic: Optional[Dict[str, Any]] = None) -> None:
        """``POST /v1/pipeline`` — validate the stage list here (cheap,
        deterministic), then forward as a pipeline RPC frame to the mask's
        ring owner; the worker runs the compound request device-resident."""
        payload = json.loads(body)
        stages = payload.get("stages")
        if (not isinstance(stages, list) or not stages
                or not all(isinstance(s, str) for s in stages)):
            raise protocol.ProtocolError(
                "'stages' must be a non-empty list of op names")
        await self._http_analyze(body, writer, keep, trace_id,
                                 stages=[str(s) for s in stages],
                                 traffic=traffic)

    async def _http_analyze_batch(self, body: bytes,
                                  writer: asyncio.StreamWriter,
                                  trace_id: Optional[str] = None,
                                  traffic: Optional[Dict[str, Any]] = None,
                                  ) -> None:
        """Chunked NDJSON in COMPLETION order, same contract as the
        single-process front end."""
        tr = maybe_trace(trace_id, process="router")
        payload = json.loads(body)
        items = payload["masks"]
        if not isinstance(items, list):
            raise protocol.ProtocolError("'masks' must be a list")

        async def run_one(i: int, item: Dict[str, Any]) -> Dict[str, Any]:
            rid = item.get("id", i)
            try:
                frame = await self._submit({"mask": item}, tr,
                                           traffic=traffic)
            except ServiceOverloaded as e:
                return dict(self._shed_response(e), id=rid)
            except protocol.ProtocolError as e:
                return {"id": rid, "error": str(e), "status": 400}
            except FrontendError as e:
                return {"id": rid, "error": str(e), "status": e.status}
            except Exception as e:
                return {"id": rid, "error": str(e), "status": 500}
            status, out = self._frame_to_response(frame, rid)
            return out

        writer.write(_head(200, "application/x-ndjson", keep=False,
                           chunked=True))
        tasks = [asyncio.ensure_future(run_one(i, it))
                 for i, it in enumerate(items)]
        try:
            for fut in asyncio.as_completed(tasks):
                writer.write(_chunk(protocol.dumps_line(await fut)))
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            for t in tasks:
                t.cancel()
            tr.finish()

    # -------------------------------------------------------- metrics rollup

    def _fetch_worker_metrics(self, link: WorkerLink) -> Optional[str]:
        try:
            conn = http.client.HTTPConnection(
                link.host, link.http_port, timeout=5.0)
            try:
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return resp.read().decode()
            finally:
                conn.close()
        except (ConnectionError, OSError, http.client.HTTPException):
            return None

    async def _rollup_metrics(self) -> str:
        """One Prometheus page for the whole fleet: worker ``*_total``
        counters AND histogram families summed per label set (exact,
        because every process shares the fixed bucket boundaries of
        :mod:`repro_torch.obs.histogram` — ``_bucket``/``_sum``/``_count`` are
        all plain summable counters), per-worker up gauges, router
        counters."""
        loop = asyncio.get_running_loop()
        pages: Dict[str, Optional[str]] = {}
        for name, link in self._links.items():
            pages[name] = (await loop.run_in_executor(
                self._pool, self._fetch_worker_metrics, link)
                if link.up else None)
        totals: Dict[Tuple[str, Tuple], float] = {}
        order: List[Tuple[str, Tuple]] = []
        types: Dict[str, str] = {}
        for text in pages.values():
            if text is None:
                continue
            try:
                page = parse_prom_text(text)
            except ValueError:
                continue   # one malformed worker must not kill the page
            types.update(page.types)
            for s in page.samples:
                fam = base_family(s.name)
                is_hist = page.types.get(fam) == "histogram"
                if not (s.name.endswith("_total") or is_hist):
                    continue
                key = (s.name, s.labels)
                if key not in totals:
                    order.append(key)
                    totals[key] = 0.0
                totals[key] += s.value
        # group summed series by family (first-seen order) so TYPE lines
        # come out once per family, with histogram families declared as
        # histograms rather than counters
        fam_order: List[str] = []
        fam_series: Dict[str, List[Tuple[str, Tuple]]] = {}
        for name, labels in order:
            fam = base_family(name)
            if types.get(fam) != "histogram":
                fam = name
            if fam not in fam_series:
                fam_order.append(fam)
                fam_series[fam] = []
            fam_series[fam].append((name, labels))
        b = PromBuilder()
        b.raw("# HELP ychg_* fleet rollup: worker *_total and histogram "
              "series summed across workers + router-side ychg_fleet_* "
              "series")
        for fam in fam_order:
            b.header(fam,
                     "histogram" if types.get(fam) == "histogram"
                     else "counter")
            for name, labels in fam_series[fam]:
                b.sample(name, labels, totals[(name, labels)])
        b.header("ychg_fleet_worker_up", "gauge",
                 "1 when the worker answered the last metrics scrape")
        for name, link in self._links.items():
            b.sample("ychg_fleet_worker_up", (("worker", name),),
                     1 if link.up and pages.get(name) is not None else 0)
        b.counter("ychg_fleet_routed_total", self.routed_total,
                  "requests forwarded to a worker")
        b.counter("ychg_fleet_rerouted_total", self.rerouted_total,
                  "forwards that failed over past their ring owner")
        b.counter("ychg_fleet_unroutable_total", self.unroutable_total,
                  "requests no live worker could serve")
        b.counter("ychg_fleet_completed_total", self.completed_total,
                  "requests answered through the router")
        b.counter("ychg_fleet_shed_deadline_total",
                  self._scheduler.shed_deadline,
                  "requests shed at the router edge: deadline unmeetable")
        b.counter("ychg_fleet_shed_quota_total", self._scheduler.shed_quota,
                  "requests shed at the router edge: tenant over quota")
        shed_by_class = self._scheduler.shed_by_class
        if shed_by_class:
            b.header("ychg_fleet_shed_class_total", "counter",
                     "router-edge sheds by traffic class")
            for klass, n in sorted(shed_by_class.items()):
                b.sample("ychg_fleet_shed_class_total",
                         (("class", klass),), n)
        shed_by_tenant = self._scheduler.shed_by_tenant
        if shed_by_tenant:
            b.header("ychg_fleet_shed_tenant_total", "counter",
                     "router-edge sheds by tenant")
            for tenant, n in sorted(shed_by_tenant.items()):
                b.sample("ychg_fleet_shed_tenant_total",
                         (("tenant", tenant),), n)
        b.gauge("ychg_fleet_queue_depth", self._scheduler.backlog(),
                "router-side admitted-but-unforwarded requests")
        b.gauge("ychg_fleet_drain_rate_rps", round(self._drain.rate(), 3),
                "observed router completion rate feeding Retry-After")
        return b.render()


# ------------------------------------------------------------- supervision


class FleetSupervisor:
    """Spawn and respawn worker processes under stable slot names.

    Workers bind ephemeral ports and hand them back through the one-line
    ``WORKER READY`` handshake on stdout; a restart keeps the slot name
    (ring placement) and updates the link's ports in place, so the
    router's tables never go stale. Each worker's stderr goes to a
    temporary file (kept until the worker is replaced or stopped), whose
    tail the error quotes when a worker dies before its handshake. A
    worker finds ``repro_torch`` through ``PYTHONPATH`` unless the package
    is installed: a caller running from a checkout sets it first
    (``launch.serve.export_pythonpath``). ``spawn_seconds`` holds each
    slot's latest spawn-to-handshake time."""

    def __init__(self, n: int, *, host: str = "127.0.0.1",
                 worker_args: Sequence[str] = (),
                 start_timeout_s: float = 180.0):
        if n < 1:
            raise ValueError(f"fleet size must be >= 1, got {n}")
        self.host = host
        self.worker_args = list(worker_args)
        self.start_timeout_s = start_timeout_s
        self.links: List[WorkerLink] = [
            WorkerLink(name=f"w{i}", host=host, rpc_port=0, http_port=0,
                       up=False)
            for i in range(n)]
        self._by_name = {l.name: l for l in self.links}
        self._stderr: Dict[str, Any] = {}
        self.spawn_seconds: Dict[str, float] = {}

    def start(self) -> List[WorkerLink]:
        for link in self.links:
            self._spawn(link)
        return self.links

    def _spawn(self, link: WorkerLink) -> None:
        t0 = time.monotonic()
        self._close_stderr(link.name)
        err = tempfile.TemporaryFile(mode="w+")
        self._stderr[link.name] = err
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.fleet.worker",
             "--host", self.host, "--port", "0", "--rpc-port", "0",
             *self.worker_args],
            stdout=subprocess.PIPE, stderr=err, text=True)
        deadline = time.monotonic() + self.start_timeout_s
        ports = None
        assert proc.stdout is not None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break   # worker died before handshaking
            ports = parse_ready_line(line)
            if ports is not None:
                break
        if ports is None:
            proc.kill()
            code = proc.wait(timeout=10)
            err.seek(0)
            tail = err.read()[-4000:]
            raise RuntimeError(
                f"worker {link.name} never printed its READY handshake "
                f"(exit code {code}); its stderr ends:\n{tail}")
        link.rpc_port, link.http_port = ports
        link.process = proc
        link.up = True
        self.spawn_seconds[link.name] = time.monotonic() - t0

    def _close_stderr(self, name: str) -> None:
        err = self._stderr.pop(name, None)
        if err is not None:
            err.close()

    def restart(self, name: str) -> WorkerLink:
        """Kill (if needed) and respawn one slot; blocks through the new
        worker's handshake. Safe to call from an executor thread."""
        link = self._by_name[name]
        self._stop_one(link)
        self._spawn(link)
        return link

    def _stop_one(self, link: WorkerLink, timeout: float = 10.0) -> None:
        proc = link.process
        link.up = False
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=timeout)

    def stop(self) -> None:
        for link in self.links:
            self._stop_one(link)
            self._close_stderr(link.name)


# -------------------------------------------------------- sync entry point


class RouterThread:
    """A `FleetRouter` on its own event-loop thread, for sync callers
    (mirrors ``repro_torch.frontend.server.ServerThread``)."""

    def __init__(self, router: FleetRouter, *, start_timeout: float = 60.0):
        self._router = router
        self._ready = threading.Event()
        self._stop: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._exc: Optional[BaseException] = None
        self.port: Optional[int] = None
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._main()),
            name="ychg-fleet-router", daemon=True)
        self._thread.start()
        if not self._ready.wait(start_timeout):
            raise RuntimeError("fleet router failed to start in time")
        if self._exc is not None:
            raise self._exc

    async def _main(self) -> None:
        try:
            await self._router.start()
            self.port = self._router.port
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
        except BaseException as e:
            self._exc = e
            self._ready.set()
            return
        self._ready.set()
        await self._stop.wait()
        await self._router.aclose()

    def close(self, timeout: float = 60.0) -> None:
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout)

    def __enter__(self) -> "RouterThread":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
