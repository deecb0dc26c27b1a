"""The port's HTTP/RPC front end, over loopback, against the JAX package's.

Both packages speak one wire: the JAX ``YCHGClient`` drives the port's
``ServerThread`` and the port's client drives the JAX server, and a
request answered by either server carries the same result payload, byte
for byte (the base64 of the raw arrays), for ychg, ccl, denoise and the
``denoise+ychg`` pipeline, one mask at a time and streamed in a batch.
Also the transport's contract: 413 above ``MAX_FRAME_BYTES``, 404 naming
the ops, 429 with ``Retry-After`` at a full queue, ``/metrics`` that
parses and ties out, the RPC transport. The port's engine runs on the CPU
here (``device="cpu"``).
"""

import asyncio
import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import Engine as JEngine  # noqa: E402
from repro.frontend import AsyncRPCClient as JRPCClient  # noqa: E402
from repro.frontend import ServerThread as JServerThread  # noqa: E402
from repro.frontend import YCHGClient as JClient  # noqa: E402
from repro.frontend import protocol as jprotocol  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import YCHGService as JService  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.frontend import (  # noqa: E402
    AsyncRPCClient,
    FrontendError,
    FrontendOverloaded,
    ServerThread,
    YCHGClient,
    protocol,
)
from repro_torch.launch.serve import (  # noqa: E402
    check_metrics_page,
    main as serve_main,
    overload_over_wire,
)
from repro_torch.service import ServiceConfig, YCHGService  # noqa: E402

SIDE = 48
CASES = [("/v1/ychg", "mask", None), ("/v1/analyze", "mask", None),
         ("/v1/ccl", "mask", None), ("/v1/denoise", "noisy", None),
         ("/v1/pipeline", "noisy", ["denoise", "ychg"])]


def _mask(seed, side=SIDE):
    return (np.random.default_rng(seed).random((side, side)) < 0.5).astype(
        np.uint8)


def _noisy(seed, side=SIDE):
    rng = np.random.default_rng(seed)
    x = rng.random((side, side)).astype(np.float32)
    x[rng.random((side, side)) < 0.05] = np.float32(4.0)
    return x


INPUTS = {"mask": _mask(1), "noisy": _noisy(2)}


@pytest.fixture(scope="module")
def servers():
    """One server of each package, each over its own CPU service."""
    port_svc = YCHGService(Engine(device="cpu"),
                           ServiceConfig(bucket_sides=(64,), max_batch=4))
    jax_svc = JService(JEngine(), JServiceConfig(bucket_sides=(64,),
                                                 max_batch=4))
    port_srv = ServerThread(port_svc, rpc_port=0)
    jax_srv = JServerThread(jax_svc, rpc_port=0)
    yield {"port": port_srv, "jax": jax_srv, "port_svc": port_svc}
    for srv in (port_srv, jax_srv):
        srv.close()
    port_svc.close()
    jax_svc.close()


def _post(port, path, obj, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(obj).encode(),
                     headers=dict(headers or {},
                                  **{"Content-Type": "application/json"}))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _request(path, kind, stages):
    obj = {"mask": protocol.encode_array(INPUTS[kind]), "id": 7}
    if stages is not None:
        obj["stages"] = stages
    return obj


def assert_host_equal(got, want):
    assert set(got) == set(want)
    for f in want:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape
        assert got[f].tobytes() == want[f].tobytes(), f


# ----------------------------------------------------- across the packages


@pytest.mark.parametrize("path,kind,stages", CASES)
def test_result_payloads_are_byte_identical(servers, path, kind, stages):
    """The same request to both servers: the same ``result`` JSON."""
    answers = []
    for name in ("port", "jax"):
        status, _, body = _post(servers[name].port, path,
                                _request(path, kind, stages))
        assert status == 200, body[:300]
        answers.append(json.loads(body))
    assert answers[0] == answers[1]
    assert answers[0]["id"] == 7


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_clients_drive_the_other_package(servers, client_pkg, server_pkg):
    client_cls = JClient if client_pkg == "jax" else YCHGClient
    other = "jax" if server_pkg == "port" else "port"
    with client_cls("127.0.0.1", servers[server_pkg].port) as c, \
            client_cls("127.0.0.1", servers[other].port) as ref:
        for op in (None, "ccl"):
            assert_host_equal(c.analyze(INPUTS["mask"], op=op),
                              ref.analyze(INPUTS["mask"], op=op))
        assert_host_equal(c.analyze(INPUTS["noisy"], op="denoise"),
                          ref.analyze(INPUTS["noisy"], op="denoise"))
        assert_host_equal(c.pipeline(INPUTS["noisy"], ["denoise", "ychg"]),
                          ref.pipeline(INPUTS["noisy"], ["denoise", "ychg"]))
        masks = [_mask(s, side) for s, side in ((3, 40), (4, 48), (5, 64))]
        got = {it.id: it for it in c.analyze_batch(masks)}
        want = {it.id: it for it in ref.analyze_batch(masks)}
        assert sorted(got) == sorted(want) == [0, 1, 2]
        for i in got:
            assert got[i].ok and want[i].ok
            assert_host_equal(got[i].result, want[i].result)


def test_served_result_equals_in_process_submit(servers):
    masks = [_mask(s) for s in range(10, 14)]
    with YCHGClient("127.0.0.1", servers["port"].port) as c:
        items = {it.id: it for it in c.analyze_batch(masks)}
    for i, m in enumerate(masks):
        want = servers["port_svc"].submit(m).result(timeout=120).to_host()
        assert_host_equal(items[i].result, want)


def test_rpc_transport_across_packages(servers):
    """Pipelined RPC analyzes from either package's async client to the
    port's server equal the JAX server's answers."""
    async def run(client_cls, port):
        c = await client_cls("127.0.0.1", port).connect()
        try:
            return await asyncio.gather(
                c.analyze(INPUTS["mask"]),
                c.analyze(INPUTS["mask"], op="ccl"),
                c.pipeline(INPUTS["noisy"], ["denoise", "ychg"]),
                c.health())
        finally:
            await c.aclose()

    want = asyncio.run(run(JRPCClient, servers["jax"].rpc_port))
    for cls in (AsyncRPCClient, JRPCClient):
        got = asyncio.run(run(cls, servers["port"].rpc_port))
        for g, w in zip(got[:3], want[:3]):
            assert_host_equal(g, w)
        assert got[3]["backend"] == "torch" and got[3]["status"] == "ok"


def test_protocol_is_the_reference_copy():
    assert protocol.MAX_FRAME_BYTES == jprotocol.MAX_FRAME_BYTES == 1 << 26
    assert protocol.OP_RESULT_FIELDS == jprotocol.OP_RESULT_FIELDS
    assert protocol.RESULT_FIELDS == jprotocol.RESULT_FIELDS
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert protocol.encode_array(a) == jprotocol.encode_array(a)
    assert protocol.pack_frame({"x": 1}) == jprotocol.pack_frame({"x": 1})


# ------------------------------------------------------- transport contract


def test_body_above_the_frame_limit_is_413(servers):
    conn = http.client.HTTPConnection("127.0.0.1", servers["port"].port,
                                      timeout=60)
    try:
        conn.putrequest("POST", "/v1/ychg")
        conn.putheader("Content-Length", str(protocol.MAX_FRAME_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert str(protocol.MAX_FRAME_BYTES) in json.loads(resp.read())[
            "error"]
    finally:
        conn.close()


def test_unknown_op_is_404_naming_the_ops(servers):
    status, _, body = _post(servers["port"].port, "/v1/warp",
                            _request("/v1/warp", "mask", None))
    assert status == 404
    assert json.loads(body) == {"error": "unknown op 'warp'",
                                "ops": ["ccl", "denoise", "ychg"]}
    with YCHGClient("127.0.0.1", servers["port"].port) as c:
        with pytest.raises(FrontendError) as e:
            c.analyze(INPUTS["mask"], op="warp")
        assert e.value.status == 404


def test_full_queue_answers_429_with_retry_after():
    engine = Engine(device="cpu")
    config = ServiceConfig(bucket_sides=(64,), max_batch=4,
                           max_delay_ms=10_000.0, max_queue_depth=1,
                           overload_policy="shed")
    with YCHGService(engine, config) as svc, ServerThread(svc) as srv:
        holder = svc.submit(_mask(20))
        status, headers, body = _post(srv.port, "/v1/ychg",
                                      {"mask": protocol.encode_array(
                                          _mask(21))})
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        assert json.loads(body)["kind"] == "overload"
        with YCHGClient("127.0.0.1", srv.port) as c:
            with pytest.raises(FrontendOverloaded) as e:
                c.analyze(_mask(22))
            assert e.value.retry_after_s > 0
    holder.result(timeout=120)
    assert overload_over_wire(engine, ServiceConfig(bucket_sides=(64,)),
                              _mask(23), _mask(24)) > 0


def test_metrics_parse_and_tie_out(servers):
    with YCHGClient("127.0.0.1", servers["port"].port) as c:
        c.analyze(_mask(30))
        text = c.metrics_text()
        health = c.health()
        traces = c.debug_traces()
    assert check_metrics_page(text) > 0
    assert "ychg_scene_tiles_done 0" in text
    assert 'ychg_backend_info{backend="torch"} 1' in text
    assert health == {"status": "ok", "backend": "torch",
                      "queue_depth": health["queue_depth"]}
    assert "traceEvents" in traces


def test_rpc_set_peers_is_refused_without_a_fleet(servers):
    async def run():
        c = await AsyncRPCClient("127.0.0.1",
                                 servers["port"].rpc_port).connect()
        try:
            return await c.call({"op": "set_peers", "peers": []})
        finally:
            await c.aclose()

    assert asyncio.run(run())["ok"] is False


def test_serve_frontend_smoke_on_the_cpu(capsys):
    serve_main(["--workload", "ychg", "--res", "32", "--batch", "3",
                "--frontend-smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bit-identical to in-process submit on cpu" in out
    assert "overload answered 429" in out


def test_default_server_engine_needs_cuda(monkeypatch):
    """Without ``--device cpu`` the front end's engine wants the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--listen", "127.0.0.1:0"])
