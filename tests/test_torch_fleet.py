"""The port's fleet (``repro_torch.fleet``) against ``tests/test_fleet.py``
and against the JAX package's fleet.

Same policy as ``tests/test_fleet.py``: loopback only, every port
ephemeral, no wall-clock assertions (gates and bounded polls pin the
interleavings), and the bit-identity bar applies through the router path.
"Workers" are in-process service + ServerThread pairs on ``device="cpu"``,
except in the two subprocess tests (a worker process handshaking and
serving, and one refusing to start without a CUDA device) and the
cross-process key-stability test.

The first fourteen tests are twins of ``tests/test_fleet.py``'s, in its
order. The reroute twin passes here: the port's router walks past a
draining worker's 500 ``"service is closed"`` where the JAX router returns
it (a deliberate divergence). Then the packages against each other: ring
placement, routing keys, and the wire bodies of the port's router over
port workers against the JAX router over JAX workers. Last, the front
end's answer to a sibling's ``cache_probe`` on entries that live on a
device, and an RPC verb that raises.
"""

import hashlib
import http.client
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import Engine as JEngine  # noqa: E402
from repro.fleet import FleetRouter as JFleetRouter  # noqa: E402
from repro.fleet import HashRing as JHashRing  # noqa: E402
from repro.fleet import PeeredResultCache as JPeeredResultCache  # noqa: E402
from repro.fleet import RouterConfig as JRouterConfig  # noqa: E402
from repro.fleet import RouterThread as JRouterThread  # noqa: E402
from repro.fleet import WorkerLink as JWorkerLink  # noqa: E402
from repro.fleet.router import routing_key as jrouting_key  # noqa: E402
from repro.frontend import ServerThread as JServerThread  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import YCHGService as JService  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, YCHGResult  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetRouter,
    FleetSupervisor,
    HashRing,
    PeeredResultCache,
    RouterConfig,
    RouterThread,
    WorkerLink,
)
from repro_torch.fleet.peering import probe_peer  # noqa: E402
from repro_torch.fleet.router import routing_key  # noqa: E402
from repro_torch.frontend import (  # noqa: E402
    FrontendOverloaded,
    ServerThread,
    YCHGClient,
    protocol,
)
from repro_torch.kernels import keyhash  # noqa: E402
from repro_torch.service import ServiceConfig, YCHGService  # noqa: E402
from repro_torch.service.cache import make_key, serialize_key  # noqa: E402
from repro_torch.sharding import make_batch_mesh  # noqa: E402

TIMEOUT = 300.0
ROOT = Path(__file__).resolve().parents[1]


def _mask(shape, seed=0, density=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.uint8)


def _assert_host_equal(got, want):
    assert set(got) == set(want)
    for field in want:
        a, b = np.asarray(want[field]), np.asarray(got[field])
        assert a.shape == b.shape, field
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field


def _cpu_engine():
    return Engine(device="cpu")


class _GatedEngine(Engine):
    """Holds every dispatch at the analyze_batch door until released."""

    def __init__(self):
        super().__init__(device="cpu")
        self.entered = threading.Event()
        self.resume = threading.Event()

    def analyze_batch(self, stack, **kw):
        result = super().analyze_batch(stack, **kw)
        self.entered.set()
        assert self.resume.wait(TIMEOUT), "engine gate never released"
        return result


# ------------------------------------------------------------ hash ring


def test_ring_is_deterministic_and_balanced():
    nodes = ["w0", "w1", "w2", "w3"]
    ring_a, ring_b = HashRing(nodes), HashRing(nodes)
    keys = [serialize_key(make_key(_mask((16, 16), seed=s), "cpu", None))
            for s in range(200)]
    owners = [ring_a.node_for(k) for k in keys]
    assert owners == [ring_b.node_for(k) for k in keys]
    counts = {n: owners.count(n) for n in nodes}
    assert all(counts[n] > 0 for n in nodes), counts


def test_ring_removal_moves_only_the_dead_nodes_keys():
    nodes = ["w0", "w1", "w2", "w3"]
    ring = HashRing(nodes)
    keys = [serialize_key(make_key(_mask((16, 16), seed=s), "cpu", None))
            for s in range(200)]
    before = {k: ring.node_for(k) for k in keys}
    up = [n for n in nodes if n != "w1"]
    for k, owner in before.items():
        after = ring.node_for(k, up=up)
        if owner != "w1":
            assert after == owner
        else:
            assert after in up
    for k in keys[:20]:
        assert ring.node_for(k, up=up) == [
            n for n in ring.preference(k) if n in up][0]


def test_ring_all_down_and_bad_construction():
    ring = HashRing(["w0", "w1"])
    assert ring.node_for(b"anything", up=[]) is None
    with pytest.raises(ValueError):
        HashRing([])
    with pytest.raises(ValueError):
        HashRing(["w0", "w0"])


# ------------------------------------------------------- key serialization


def test_serialize_key_distinguishes_every_component():
    mask = _mask((4, 8), seed=1)
    cfg = EngineConfig()
    base = serialize_key(make_key(mask, "cpu", cfg))
    reshaped = np.ascontiguousarray(mask.reshape(8, 4))
    assert serialize_key(make_key(reshaped, "cpu", cfg)) != base
    assert serialize_key(make_key(mask.view(np.int8), "cpu", cfg)) != base
    assert serialize_key(make_key(mask, "ref", cfg)) != base
    cfg2 = EngineConfig(block_w=cfg.block_w * 2)
    assert serialize_key(make_key(mask, "cpu", cfg2)) != base
    assert serialize_key(
        make_key(_mask((4, 8), seed=2), "cpu", cfg)) != base
    assert serialize_key(make_key(mask, "cpu", cfg, op="ccl")) != base
    # the mesh component: a meshed engine's entries never alias
    mesh = make_batch_mesh(devices=["cpu"])
    assert serialize_key(make_key(mask, "cpu", cfg, mesh)) != base
    assert serialize_key(make_key(mask, "cpu", EngineConfig())) == base


def test_serialize_key_is_versioned_and_op_prefixed():
    mask = _mask((4, 8), seed=1)
    cfg = EngineConfig()
    for op in ("ychg", "ccl", "denoise", "denoise+ychg"):
        skey = serialize_key(make_key(mask, "cpu", cfg, op=op))
        assert skey.startswith(
            len(b"ychg-key-v3").to_bytes(4, "big") + b"ychg-key-v3")
        off = 4 + len(b"ychg-key-v3")
        n = int.from_bytes(skey[off:off + 4], "big")
        assert skey[off + 4:off + 4 + n] == op.encode()


_CHILD_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.engine import EngineConfig
    from repro_torch.service.cache import make_key, serialize_key
    from repro_torch.sharding import make_batch_mesh
    rng = np.random.default_rng(7)
    mask = (rng.random((32, 48)) < 0.5).astype(np.uint8)
    mesh = make_batch_mesh(devices=["cpu", "cpu"])
    for op in ("ychg", "ccl", "denoise+ychg"):
        key = make_key(mask, "cpu", EngineConfig(), op=op)
        sys.stdout.write(serialize_key(key).hex() + "\\n")
    key = make_key(mask, "fused", EngineConfig(), mesh)
    sys.stdout.write(serialize_key(key).hex() + "\\n")
""")


def test_serialized_key_is_stable_across_processes():
    """The serialized key (a meshed engine's too: ``BatchMesh`` renders
    the same everywhere) is byte-identical under different hash seeds."""
    rng = np.random.default_rng(7)
    mask = (rng.random((32, 48)) < 0.5).astype(np.uint8)
    mesh = make_batch_mesh(devices=["cpu", "cpu"])
    want = "".join(
        serialize_key(make_key(mask, "cpu", EngineConfig(), op=op)).hex()
        + "\n" for op in ("ychg", "ccl", "denoise+ychg"))
    want += serialize_key(make_key(mask, "fused", EngineConfig(),
                                   mesh)).hex() + "\n"
    assert len(set(want.split())) == 4
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=seed,
                   PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-c", _CHILD_SCRIPT], env=env,
            capture_output=True, text=True, timeout=TIMEOUT)
        assert out.returncode == 0, out.stderr
        assert out.stdout == want, (
            f"serialized key drifted under PYTHONHASHSEED={seed}")


# ------------------------------------------------------------- peering


def _service_key(svc, mask):
    return make_key(np.ascontiguousarray(mask), svc.engine.resolve_backend(),
                    svc.engine.config, svc.engine.mesh)


def test_peer_probe_adopts_siblings_entry_without_recompute():
    mask = _mask((24, 24), seed=30)
    cfg = ServiceConfig(bucket_sides=(32,), max_batch=2, max_delay_ms=1.0)
    cache_a = PeeredResultCache(64, device="cpu")
    svc_a = YCHGService(_cpu_engine(), cfg, cache=cache_a)
    with svc_a, ServerThread(svc_a, rpc_port=0) as srv_a:
        want = svc_a.submit(mask).result(timeout=TIMEOUT).to_host()
        cache_b = PeeredResultCache(64, device="cpu")
        cache_b.set_peers([("127.0.0.1", srv_a.rpc_port)])
        svc_b = YCHGService(_cpu_engine(), cfg, cache=cache_b)
        with svc_b:
            got = svc_b.submit(mask).result(timeout=TIMEOUT)
            m = svc_b.metrics()
    assert isinstance(got, YCHGResult) and got.runs.device.type == "cpu"
    _assert_host_equal(got.to_host(), want)
    assert cache_b.peer_hits == 1
    assert m.peer_hits == 1
    assert m.batches == 0
    assert m.completed == 1
    assert cache_b.get(_service_key(svc_b, mask)) is not None


def test_peer_probe_miss_and_dead_peer_fall_back_to_compute():
    mask = _mask((24, 24), seed=31)
    cfg = ServiceConfig(bucket_sides=(32,), max_batch=2, max_delay_ms=1.0)
    empty_cache = PeeredResultCache(64, device="cpu")
    svc_empty = YCHGService(_cpu_engine(), cfg, cache=empty_cache)
    with svc_empty, ServerThread(svc_empty, rpc_port=0) as srv_empty:
        s = socket.create_server(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
        s.close()
        cache = PeeredResultCache(64, device="cpu", probe_timeout_s=0.1)
        cache.set_peers([("127.0.0.1", dead_port),
                         ("127.0.0.1", srv_empty.rpc_port)])
        svc = YCHGService(_cpu_engine(), cfg, cache=cache)
        with svc:
            out = svc.submit(mask).result(timeout=TIMEOUT)
            m = svc.metrics()
    assert out.to_host()["runs"].shape == (24,)
    assert cache.peer_hits == 0
    assert cache.peer_misses == 1
    assert m.peer_misses == 1
    assert m.batches == 1


def test_cache_probe_rpc_verb_is_local_only():
    mask = _mask((16, 16), seed=32)
    cfg = ServiceConfig(bucket_sides=(16,), max_batch=1, max_delay_ms=1.0)
    cache = PeeredResultCache(64, device="cpu")
    svc = YCHGService(_cpu_engine(), cfg, cache=cache)
    with svc, ServerThread(svc, rpc_port=0) as srv:
        skey = serialize_key(_service_key(svc, mask))
        assert probe_peer("127.0.0.1", srv.rpc_port, skey,
                          timeout=5.0) is None
        assert svc.metrics().batches == 0
        svc.submit(mask).result(timeout=TIMEOUT)
        frame = probe_peer("127.0.0.1", srv.rpc_port, skey, timeout=5.0)
        assert frame is not None and frame["hit"]
        runs = protocol.decode_array(frame["result"]["runs"])
        assert runs.shape == (1, 16)


# ------------------------------------------------------------- the router


def _two_worker_fleet(cfg=None, engines=None):
    cfg = cfg or ServiceConfig(
        bucket_sides=(32,), max_batch=4, max_delay_ms=1.0)
    links, closers = [], []
    for i in range(2):
        engine = engines[i] if engines else _cpu_engine()
        cache = PeeredResultCache(64, device="cpu")
        svc = YCHGService(engine, cfg, cache=cache)
        srv = ServerThread(svc, rpc_port=0)
        links.append(WorkerLink(name=f"w{i}", host="127.0.0.1",
                                rpc_port=srv.rpc_port, http_port=srv.port))
        closers.append((svc, srv))
    return links, closers


def _close_fleet(closers):
    for svc, srv in closers:
        srv.close()
        svc.close()


def test_router_path_is_bit_identical_and_uses_both_workers():
    masks = [_mask((28, 28), seed=40 + i) for i in range(8)]
    links, closers = _two_worker_fleet()
    try:
        cfg = ServiceConfig(bucket_sides=(32,), max_batch=4,
                            max_delay_ms=1.0)
        with YCHGService(_cpu_engine(), cfg) as ref:
            want = [ref.submit(m).result(timeout=TIMEOUT).to_host()
                    for m in masks]
        router = FleetRouter(links, RouterConfig(bucket_sides=(32,),
                                                 max_batch=4))
        with RouterThread(router) as rt, \
                YCHGClient("127.0.0.1", rt.port) as client:
            _assert_host_equal(client.analyze(masks[0]), want[0])
            items = {it.id: it for it in client.analyze_batch(masks)}
            for i, want_res in enumerate(want):
                assert items[i].ok, items[i].error
                _assert_host_equal(items[i].result, want_res)
            assert client.health()["workers"] == {"w0": True, "w1": True}
        ring = HashRing(["w0", "w1"])
        owners = {ring.node_for(routing_key(m)) for m in masks}
        assert owners == {"w0", "w1"}, (
            "seed set no longer exercises both workers; pick new seeds")
    finally:
        _close_fleet(closers)


def test_router_reroutes_to_survivor_when_a_worker_dies():
    """The twin of the JAX test the JAX router fails: closing w1's server
    and service answers the in-flight connection's next call with a 500
    ``"service is closed"``, which the port's router walks past."""
    masks = [_mask((28, 28), seed=50 + i) for i in range(9)]
    links, closers = _two_worker_fleet()
    try:
        ring = HashRing(["w0", "w1"])
        victim_mask = next(m for m in masks
                           if ring.node_for(routing_key(m)) == "w1")
        cfg = ServiceConfig(bucket_sides=(32,), max_batch=4,
                            max_delay_ms=1.0)
        with YCHGService(_cpu_engine(), cfg) as ref:
            want = ref.submit(victim_mask).result(timeout=TIMEOUT).to_host()
        router = FleetRouter(links, RouterConfig(bucket_sides=(32,),
                                                 max_batch=4))
        with RouterThread(router) as rt, \
                YCHGClient("127.0.0.1", rt.port) as client:
            _assert_host_equal(client.analyze(victim_mask), want)
            svc1, srv1 = closers[1]
            srv1.close()
            svc1.close()
            _assert_host_equal(client.analyze(victim_mask), want)
            metrics = client.metrics_text()
            assert "ychg_fleet_rerouted_total 1" in metrics
            assert 'ychg_fleet_worker_up{worker="w1"} 0' in metrics
            assert 'ychg_fleet_worker_up{worker="w0"} 1' in metrics
            assert client.health()["workers"] == {"w0": True, "w1": False}
    finally:
        _close_fleet(closers)


def _park_holder(engines, client, holder_mask, box):
    t = threading.Thread(
        target=lambda: box.update(out=client.analyze(holder_mask)),
        daemon=True)
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while not any(e.entered.is_set() for e in engines):
        assert time.monotonic() < deadline, "holder never arrived"
        time.sleep(0.005)
    return t


def test_router_admission_sheds_429_when_workers_are_saturated():
    engines = [_GatedEngine(), _GatedEngine()]
    links, closers = _two_worker_fleet(engines=engines)
    holder = {}
    try:
        router = FleetRouter(links, RouterConfig(
            bucket_sides=(32,), max_batch=4, max_queue_depth=1,
            overload_policy="shed"))
        with RouterThread(router) as rt, \
                YCHGClient("127.0.0.1", rt.port) as client:
            t = _park_holder(engines, client, _mask((28, 28), seed=60),
                             holder)
            with YCHGClient("127.0.0.1", rt.port) as shed_client:
                with pytest.raises(FrontendOverloaded) as exc_info:
                    shed_client.analyze(_mask((28, 28), seed=61))
            assert exc_info.value.status == 429
            assert exc_info.value.retry_after_s > 0
            for e in engines:
                e.resume.set()
            t.join(TIMEOUT)
            assert not t.is_alive()
            assert "runs" in holder.get("out", {})
    finally:
        for e in engines:
            e.resume.set()
        _close_fleet(closers)


def test_router_429_retry_after_reflects_measured_drain_rate():
    engines = [_GatedEngine(), _GatedEngine()]
    links, closers = _two_worker_fleet(engines=engines)
    holder = {}
    try:
        router = FleetRouter(links, RouterConfig(
            bucket_sides=(32,), max_batch=4, max_queue_depth=1,
            overload_policy="shed"))
        with RouterThread(router) as rt, \
                YCHGClient("127.0.0.1", rt.port) as client:
            t = _park_holder(engines, client, _mask((28, 28), seed=62),
                             holder)
            now = time.monotonic()
            router._drain._interval = 1e9
            router._drain._samples = [(now - 1.0, 0), (now, 10)]
            with YCHGClient("127.0.0.1", rt.port) as shed_client:
                with pytest.raises(FrontendOverloaded) as exc_info:
                    shed_client.analyze(_mask((28, 28), seed=63))
            assert exc_info.value.status == 429
            assert exc_info.value.retry_after_s == pytest.approx(
                0.1, abs=0.001)
            for e in engines:
                e.resume.set()
            t.join(TIMEOUT)
            assert not t.is_alive()
            assert "runs" in holder.get("out", {})
    finally:
        for e in engines:
            e.resume.set()
        _close_fleet(closers)


def test_rollup_sums_worker_histograms_exactly():
    from repro_torch.obs import base_family, parse_prom_text

    masks = [_mask((28, 28), seed=70 + i) for i in range(6)]
    links, closers = _two_worker_fleet()
    n_requests = len(masks) + 2
    try:
        router = FleetRouter(links, RouterConfig(bucket_sides=(32,),
                                                 max_batch=4))
        with RouterThread(router) as rt, \
                YCHGClient("127.0.0.1", rt.port) as client:
            items = {it.id: it for it in client.analyze_batch(masks)}
            assert all(it.ok for it in items.values())
            client.analyze(_mask((28, 28), seed=80), op="ccl")
            client.analyze(_mask((28, 28), seed=81), op="ccl")
            worker_pages = []
            for link in links:
                with YCHGClient("127.0.0.1", link.http_port) as wc:
                    worker_pages.append(parse_prom_text(wc.metrics_text()))
            page = parse_prom_text(client.metrics_text())
        fam = "ychg_request_latency_seconds"
        assert page.types.get(fam) == "histogram"

        def hist_series(p):
            return {(s.name, s.labels): s.value for s in p.samples
                    if base_family(s.name) == fam}

        want = {}
        for wp in worker_pages:
            for key, v in hist_series(wp).items():
                want[key] = want.get(key, 0.0) + v
        got = hist_series(page)
        assert want, "workers exported no latency histogram series"
        for key, v in want.items():
            assert got.get(key) == v, key
        inf = sum(v for (n, labels), v in got.items()
                  if n.endswith("_bucket") and dict(labels)["le"] == "+Inf")
        counts = sum(v for (n, _), v in got.items()
                     if n.endswith("_count"))
        assert inf == counts == n_requests
        ops_seen = {dict(labels).get("op") for (n, labels) in got
                    if n.endswith("_count")}
        assert {"ychg", "ccl"} <= ops_seen
        assert page.get("ychg_completed_total") == n_requests
    finally:
        _close_fleet(closers)


# ----------------------------------------------------- across the packages


def test_ring_preference_equals_jax():
    """Same node names, same ring: every key's failover order is the JAX
    ring's."""
    for nodes in (["w0", "w1"], ["w0", "w1", "w2", "w3"], ["a", "bb", "c"]):
        ring, jring = HashRing(nodes), JHashRing(nodes)
        for s in range(100):
            key = serialize_key(make_key(_mask((8, 8), seed=s), "fleet",
                                         None))
            assert ring.preference(key) == jring.preference(key)


DTYPES = [np.uint8, np.bool_, np.int32, np.float32]
OPS = ["ychg", "ccl", "denoise", "denoise+ychg"]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("op", OPS)
def test_routing_key_equals_jax(dtype, op):
    """The port's routing key is the JAX one component for component, but
    for the version (v3: the digest is BLAKE2b's tree mode) and the
    digest itself, which is the tree digest of the same bytes where the
    JAX package takes a plain blake2b."""
    mask = _mask((13, 21), seed=90).astype(dtype)
    got = _key_parts(routing_key(mask, op))
    want = _key_parts(jrouting_key(mask, op))
    assert (got[0], want[0]) == (b"ychg-key-v3", b"ychg-key-v2")
    assert want[2] == hashlib.blake2b(mask.tobytes(), digest_size=16).digest()
    assert got[2] == keyhash.digest_host(mask)
    assert got[1] == want[1] and got[3:] == want[3:]


def _key_parts(skey: bytes) -> list:
    """A serialized key's length-prefixed components, in order."""
    parts, off = [], 0
    while off < len(skey):
        n = int.from_bytes(skey[off:off + 4], "big")
        parts.append(skey[off + 4:off + 4 + n])
        off += 4 + n
    return parts


WIRE_SIDE = 48


def _noisy(seed, side=WIRE_SIDE):
    rng = np.random.default_rng(seed)
    x = rng.random((side, side)).astype(np.float32)
    x[rng.random((side, side)) < 0.05] = np.float32(4.0)
    return x


WIRE_CASES = {
    "/v1/analyze": {"mask": protocol.encode_array(
        _mask((WIRE_SIDE, WIRE_SIDE), seed=100)), "id": 3},
    "/v1/ccl": {"mask": protocol.encode_array(
        _mask((WIRE_SIDE, WIRE_SIDE), seed=101)), "id": 4},
    "/v1/denoise": {"mask": protocol.encode_array(_noisy(102)), "id": 5},
    "/v1/pipeline": {"mask": protocol.encode_array(_noisy(103)), "id": 6,
                     "stages": ["denoise", "ychg"]},
    "/v1/analyze_batch": {"masks": [
        dict(protocol.encode_array(_mask((WIRE_SIDE - i, WIRE_SIDE),
                                         seed=110 + i)), id=i)
        for i in range(6)]},
}


@pytest.fixture(scope="module")
def fleets():
    """Two-worker fleets of each package behind its own router."""
    scfg = dict(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    rcfg = dict(bucket_sides=(64,), max_batch=4)
    closers, routers = [], {}
    port_links, jax_links = [], []
    for i in range(2):
        svc = YCHGService(_cpu_engine(), ServiceConfig(**scfg),
                          cache=PeeredResultCache(64, device="cpu"))
        srv = ServerThread(svc, rpc_port=0)
        port_links.append(WorkerLink(f"w{i}", "127.0.0.1", srv.rpc_port,
                                     srv.port))
        jsvc = JService(JEngine(), JServiceConfig(**scfg),
                        cache=JPeeredResultCache(64))
        jsrv = JServerThread(jsvc, rpc_port=0)
        jax_links.append(JWorkerLink(f"w{i}", "127.0.0.1", jsrv.rpc_port,
                                     jsrv.port))
        closers += [(svc, srv), (jsvc, jsrv)]
    routers["port"] = RouterThread(FleetRouter(port_links,
                                               RouterConfig(**rcfg)))
    routers["jax"] = JRouterThread(JFleetRouter(jax_links,
                                                JRouterConfig(**rcfg)))
    yield routers
    for rt in routers.values():
        rt.close()
    _close_fleet(closers)


def _post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(obj).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("path", list(WIRE_CASES))
def test_router_wire_bodies_equal_jax(fleets, path):
    """The same request body to the port's router over port workers and to
    the JAX router over JAX workers: the same response bytes (the batch's
    NDJSON lines compared by id, since they arrive in completion order)."""
    bodies = {}
    for name, rt in fleets.items():
        status, body = _post(rt.port, path, WIRE_CASES[path])
        assert status == 200, (name, body[:300])
        bodies[name] = body
    if path == "/v1/analyze_batch":
        lines = {name: sorted(body.splitlines(),
                              key=lambda ln: json.loads(ln)["id"])
                 for name, body in bodies.items()}
        assert len(lines["port"]) == len(WIRE_CASES[path]["masks"])
        assert all("result" in json.loads(ln) for ln in lines["port"])
        assert lines["port"] == lines["jax"]
    else:
        assert "result" in json.loads(bodies["port"])
        assert bodies["port"] == bodies["jax"]


# ------------------------------------------------------ worker processes


def test_supervisor_spawns_a_cpu_worker_that_serves(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    mask = _mask((28, 28), seed=120)
    with YCHGService(_cpu_engine(), ServiceConfig(bucket_sides=(32,))) as ref:
        want = ref.submit(mask).result(timeout=TIMEOUT).to_host()
    sup = FleetSupervisor(1, worker_args=["--device", "cpu",
                                          "--buckets", "32"])
    try:
        links = sup.start()
        assert links[0].up and links[0].process.poll() is None
        assert sup.spawn_seconds["w0"] > 0
        router = FleetRouter(links, RouterConfig(bucket_sides=(32,)),
                             supervisor=sup)
        with RouterThread(router) as rt, \
                YCHGClient("127.0.0.1", rt.port) as client:
            _assert_host_equal(client.analyze(mask), want)
            assert client.health()["workers"] == {"w0": True}
    finally:
        sup.stop()
    assert links[0].process.poll() is not None


def test_worker_without_device_refuses_a_host_without_cuda(monkeypatch):
    """No CPU fallback: a worker not told ``--device cpu`` wants the card,
    exits non-zero where there is none, and the supervisor's error quotes
    the worker's stderr."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    sup = FleetSupervisor(1, worker_args=["--buckets", "32"])
    try:
        with pytest.raises(RuntimeError) as exc_info:
            sup.start()
    finally:
        sup.stop()
    msg = str(exc_info.value)
    assert "never printed its READY handshake" in msg
    assert "exit code 1" in msg
    assert "no CUDA device" in msg


# ------------------------------------------- the front end's fleet verbs


class _DeviceTensor:
    """Stands in for a CUDA tensor: ``np.asarray`` of it raises, as of a
    tensor on the card; only ``.cpu()`` reaches the values."""

    def __init__(self, t):
        self._t = t

    def cpu(self):
        return self._t

    def __array__(self, *a, **k):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")


def _rpc(sock, frame):
    sock.sendall(protocol.pack_frame(frame))
    head = b""
    while len(head) < 4:
        head += sock.recv(4 - len(head))
    n = protocol.unpack_frame_header(head)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed the connection"
        buf += chunk
    return json.loads(buf)


def test_cache_probe_answers_device_entries_with_host_arrays():
    """A cached entry whose fields live on a device is copied to the host
    for a sibling: the stored (1, W)/(1,) layout and dtypes, over the
    wire."""
    mask = _mask((16, 20), seed=130)
    cache = PeeredResultCache(64, device="cpu")
    svc = YCHGService(_cpu_engine(),
                      ServiceConfig(bucket_sides=(32,), max_batch=1),
                      cache=cache)
    with svc, ServerThread(svc, rpc_port=0) as srv:
        stored = svc.submit(mask).result(timeout=TIMEOUT)
        key = _service_key(svc, mask)
        fields = ("runs", "cut_vertices", "transitions", "births", "deaths",
                  "n_hyperedges", "n_transitions")
        cache.put(key, YCHGResult(
            *(_DeviceTensor(getattr(stored, f)) for f in fields),
            batched=False))
        frame = probe_peer("127.0.0.1", srv.rpc_port, serialize_key(key),
                           timeout=5.0)
    assert frame is not None and frame["hit"]
    for f in fields:
        got = protocol.decode_array(frame["result"][f])
        want = getattr(stored, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        assert got.shape[0] == 1, f
        assert np.array_equal(got, want), f


def test_rpc_verb_that_raises_answers_500_and_keeps_the_connection():
    cache = PeeredResultCache(64, device="cpu")
    svc = YCHGService(_cpu_engine(), ServiceConfig(bucket_sides=(32,)),
                      cache=cache)

    def broken(skey):
        raise RuntimeError("probe failed")

    cache.probe_serialized = broken
    with svc, ServerThread(svc, rpc_port=0) as srv, \
            socket.create_connection(("127.0.0.1", srv.rpc_port),
                                     timeout=30) as sock:
        out = _rpc(sock, {"op": "cache_probe", "key": "00", "id": 1})
        assert out == {"id": 1, "error": "probe failed", "status": 500}
        assert _rpc(sock, {"op": "health", "id": 2})["status"] == "ok"
        mask = _mask((20, 20), seed=131)
        out = _rpc(sock, {"op": "analyze", "id": 3,
                          "mask": protocol.encode_array(mask)})
        want = svc.submit(mask).result(timeout=TIMEOUT).to_host()
        _assert_host_equal(protocol.decode_result(out["result"], "ychg"),
                           want)
