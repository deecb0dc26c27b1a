"""The service's content digest (``kernels.keyhash``) and the service keyed
on the card.

On the CPU: the host digest against a tree built here node by node from
``hashlib.blake2b`` calls, the wrapper's plain version against it, the
key's sensitivity to one byte, the device pad against the host pad, and
the service's card path rehearsed on a CPU engine (``Engine.puts_on_card``
patched, the kernel's plain version standing in, the CUDA stream calls
stubbed). Tests marked ``card``
hold the kernel and the service's card path on a CUDA card and skip
elsewhere; run them there with ``python -m pytest --noconftest -q
tests/test_torch_keyhash.py`` (this file imports no JAX).
"""

import contextlib
import gc
import hashlib
import threading
import time
import weakref
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import Engine  # noqa: E402
from repro_torch.engine import engine as engine_mod  # noqa: E402
from repro_torch.kernels import keyhash  # noqa: E402
from repro_torch.service import (  # noqa: E402
    ServiceConfig,
    ServiceOverloaded,
    YCHGService,
    make_key,
    pad_stack,
)
from repro_torch.service.batching import pad_stack_device  # noqa: E402

TIMEOUT = 300.0
LEAF, FANOUT = 4096, 128
LENGTHS = [0, 1, 4095, 4096, 4097, 128 * 4096, 128 * 4096 + 1]
FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
          "n_hyperedges", "n_transitions")


def tree_digest(data: bytes) -> bytes:
    """BLAKE2b's tree mode as the BLAKE2 specification builds it, node by
    node: 4 KiB leaves, fanout 128, 16-byte digests, depth the levels the
    length needs, the last node of each level flagged."""
    counts = [max(1, -(-len(data) // LEAF))]
    while counts[-1] > 1:
        counts.append(-(-counts[-1] // FANOUT))
    depth = len(counts)

    def node(chunk, offset, node_depth, last):
        return hashlib.blake2b(
            chunk, digest_size=16, fanout=FANOUT, depth=depth,
            leaf_size=LEAF, node_offset=offset, node_depth=node_depth,
            inner_size=16, last_node=last).digest()

    level = [node(data[i * LEAF:(i + 1) * LEAF], i, 0, i == counts[0] - 1)
             for i in range(counts[0])]
    for d in range(1, depth):
        level = [node(b"".join(level[j * FANOUT:(j + 1) * FANOUT]), j, d,
                      j == counts[d] - 1) for j in range(counts[d])]
    (root,) = level
    return root


def _bytes(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _mask(shape, seed=0, dtype=np.uint8, density=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(dtype)


RAGGED = [_mask((17, 23), 1), _mask((64, 64), 2), _mask((33, 40), 3),
          _mask((5, 60), 4), _mask((1, 1), 5), np.zeros((30, 30), np.uint8),
          np.ones((16, 48), np.uint8), _mask((64, 1), 6)]


def _assert_same(got, want):
    g, w = got.to_host(), want.to_host()
    for f in FIELDS:
        assert g[f].dtype == w[f].dtype, f
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)


# ----------------------------------------------------------------- the CPU


@pytest.mark.parametrize("n", LENGTHS)
def test_host_digest_is_blake2b_tree_mode(n):
    a = _bytes(n, seed=n)
    assert keyhash.digest_host(a) == tree_digest(a.tobytes())
    assert len(keyhash.levels(n)) == (1 if n <= LEAF else
                                      2 if n <= LEAF * FANOUT else 3)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int64])
def test_host_digest_of_masks_is_over_their_bytes(dtype):
    """A mask's digest is over its bytes as submitted, whatever the dtype
    (int64 before any narrowing), and the key holds it."""
    m = _mask((37, 53), seed=3, dtype=dtype) * 3
    assert keyhash.digest_host(m) == tree_digest(m.tobytes())
    assert make_key(m, "torch", None)[0] == tree_digest(m.tobytes())


def test_host_digest_of_the_serving_mask():
    """8192^2 uint8: 16,384 leaves, 128 inner nodes, the root."""
    m = _mask((8192, 8192), seed=7)
    assert keyhash.levels(m.size) == [16384, 128, 1]
    assert keyhash.digest_host(m) == tree_digest(m.tobytes())


@pytest.mark.parametrize("where", ["first", "last"])
def test_one_byte_flipped_changes_the_key(where):
    m = _mask((100, 100), seed=8)   # 10,000 bytes: three leaves
    flipped = m.copy()
    flipped.reshape(-1)[0 if where == "first" else -1] ^= 1
    assert make_key(flipped, "torch", None) != make_key(m, "torch", None)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool, torch.float32,
                                   torch.int64, torch.bfloat16])
def test_cpu_wrapper_is_the_host_digest(dtype):
    x = torch.from_numpy(_mask((70, 90), seed=9)).to(dtype)
    n0 = keyhash.LAUNCHES["keyhash"]
    got = keyhash.digest(x)
    assert keyhash.LAUNCHES["keyhash"] == n0   # the plain version
    raw = x.contiguous().view(torch.uint8).numpy().tobytes()
    assert got == tree_digest(raw)
    # a non-contiguous view digests its elements in C order
    assert keyhash.digest(x.t()) == tree_digest(
        x.t().contiguous().view(torch.uint8).numpy().tobytes())
    if dtype is not torch.bfloat16:   # numpy has no bfloat16
        assert keyhash.digest(x.numpy()) == got   # a host array alike


def test_wrapper_refuses_what_is_neither_array_nor_tensor():
    with pytest.raises(TypeError, match="array or a tensor"):
        keyhash.digest(b"\x00" * 16)


def test_kernel_path_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        keyhash.launch(torch.zeros(4, dtype=torch.uint8))


@pytest.mark.parametrize("n", LENGTHS + [8192 * 8192])
def test_scratch_holds_every_level_but_the_root(n):
    counts = keyhash.levels(n)
    assert counts[-1] == 1
    assert keyhash.scratch_bytes(n) == 32 + 16 * (sum(counts) - 1)


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.float32, np.int64,
                                   np.uint64, np.float16])
def test_device_pad_is_the_host_pad(dtype):
    """Byte for byte, the ragged edges, empty masks and blank trailing
    images included."""
    shapes = [(3, 5), (7, 7), (0, 4), (7, 0), (1, 7), (7, 1)]
    masks = [(np.random.default_rng(i).random(s) * 5).astype(dtype)
             for i, s in enumerate(shapes)]
    want = pad_stack(masks, 7, 8, np.dtype(dtype))
    got = pad_stack_device([torch.from_numpy(m) for m in masks], 7, 8)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  want.view(np.uint8))


# a request waits in its bucket until max_batch requests fill it (or the
# service closes): a window of a minute holds leaders in flight
HELD = dict(max_batch=4, max_delay_ms=60_000.0)


def _keyed_path_checks(svc, engine, masks, plain_engine):
    """Every answer equal to the plain engine's, every key ``make_key``'s
    on the host, a duplicate coalesced onto its leader in flight (waiting
    for its batch of ``HELD`` to fill), a repeat a hit, every probe counted
    where the service keyed it."""
    futs = [svc.submit(masks[0])]
    dup = svc.submit(masks[0].copy())
    futs += [svc.submit(m) for m in masks[1:]]   # the batches fill and go
    got = [f.result(timeout=TIMEOUT) for f in futs]
    assert dup.result(timeout=TIMEOUT) is got[0]
    again = svc.submit(masks[1]).result(timeout=TIMEOUT)
    assert again is got[1]
    metrics = svc.metrics()
    backend = engine.resolve_backend()
    for m, g in zip(masks, got):
        _assert_same(g, plain_engine.analyze(m))
        key = make_key(m, backend, engine.config, op="ychg")
        assert svc.cache.get(key) is g
    return metrics


BACKLOG = dict(max_batch=8, max_delay_ms=60_000.0, cache_entries=0,
               max_queue_depth=2, overload_policy="block")


def _backlog(svc, masks, measure):
    """Two of ``masks`` admitted and pending (a batch of 8, a window of a
    minute), the other two submitted by producers parked at the gate of
    ``max_queue_depth=2``; ``measure()`` runs while all four wait, then the
    service closes (the admitted two are computed, the parked producers
    raise) and every answer is awaited. Returns what ``measure`` gave."""
    admitted = [svc.submit(m) for m in masks[:2]]
    outcomes = []

    def produce(m):
        try:
            outcomes.append(svc.submit(m))
        except Exception as e:   # the service closed under it
            outcomes.append(e)

    producers = [threading.Thread(target=produce, args=(m,))
                 for m in masks[2:]]
    for t in producers:
        t.start()
    deadline = time.monotonic() + TIMEOUT
    while svc.metrics().blocked < len(producers):
        assert time.monotonic() < deadline, "the producers never blocked"
        time.sleep(0.01)
    held = measure()
    svc.close()
    for t in producers:
        t.join(TIMEOUT)
    for f in admitted + [o for o in outcomes if isinstance(o, Future)]:
        f.result(timeout=TIMEOUT)
    return held


@pytest.fixture
def card_path_on_cpu(monkeypatch):
    """The service's card path on a CPU engine, through what
    ``Engine.put`` calls: the engine's predicate says yes, the CUDA stream
    calls do nothing, the copy's page-locked slots are plain host memory
    (on a machine with a card too), and the kernel's plain version stands
    in, counted."""
    calls = []
    plain = keyhash.digest

    def digest(x):
        if isinstance(x, torch.Tensor):   # the copy, not a host array
            calls.append(x.shape)
        return plain(x)

    monkeypatch.setattr(Engine, "puts_on_card", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(engine_mod, "pinned_buffer",
                        lambda n: torch.empty(n, dtype=torch.uint8))
    monkeypatch.setattr(keyhash, "digest", digest)
    return calls


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int64])
def test_card_path_rehearsed_on_cpu(card_path_on_cpu, dtype):
    """The service's card branch (the copy kept on the request, the pad
    from device tensors) gives the host branch's answers and keys."""
    eng = Engine(device="cpu")
    masks = [(m * 3).astype(dtype) for m in RAGGED]
    cfg = ServiceConfig(bucket_sides=(64,), **HELD)
    with YCHGService(eng, cfg) as svc:
        m = _keyed_path_checks(svc, eng, masks, Engine(device="cpu"))
    n = len(masks) + 2
    assert len(card_path_on_cpu) == n
    assert (m.keys_on_device, m.keys_on_host) == (n, 0)
    assert (m.key_copies_pinned, m.key_copies_pageable) == (n, 0)
    assert m.coalesced == 1 and m.cache_hits == 1


class _FailingEngine(Engine):
    """Raises in analyze_batch until ``fail`` is cleared."""

    fail = True

    def analyze_batch(self, stack, **kw):
        if self.fail:
            raise RuntimeError("engine down")
        return super().analyze_batch(stack, **kw)


def test_card_path_failed_flush_drains_before_letting_go(card_path_on_cpu,
                                                         monkeypatch):
    """A flush that raises fails its requests, waits for the dispatcher's
    stream before letting their device copies go, and the service serves
    the next request."""
    drains = []

    class Stream:
        def synchronize(self):
            drains.append("synchronize")

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    eng = _FailingEngine(device="cpu")
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    with YCHGService(eng, cfg) as svc:
        with pytest.raises(RuntimeError, match="engine down"):
            svc.submit(RAGGED[0]).result(timeout=TIMEOUT)
        assert drains == ["synchronize"]
        eng.fail = False
        got = svc.submit(RAGGED[1]).result(timeout=TIMEOUT)
    _assert_same(got, Engine(device="cpu").analyze(RAGGED[1]))
    assert drains == ["synchronize"]


def test_card_path_shed_request_keeps_no_copy(card_path_on_cpu,
                                              monkeypatch):
    """A shed request's device copy is let go before the exception leaves
    submit, so a caller that keeps the exception (and with it the frame
    of submit in its traceback) keeps no copy alive."""
    copies = []
    counted = keyhash.digest

    def digest(x):
        if isinstance(x, torch.Tensor):
            copies.append(weakref.ref(x))
        return counted(x)

    monkeypatch.setattr(keyhash, "digest", digest)
    eng = Engine(device="cpu")
    cfg = ServiceConfig(bucket_sides=(64,), max_queue_depth=1,
                        overload_policy="shed", **HELD)
    shed = []
    with YCHGService(eng, cfg) as svc:
        first = svc.submit(RAGGED[0])   # waits in its batch until close
        for m in RAGGED[1:4]:
            with pytest.raises(ServiceOverloaded) as e:
                svc.submit(m)
            shed.append(e.value)
    first.result(timeout=TIMEOUT)
    assert len(copies) == 4 and all(ref() is None for ref in copies[1:])


def test_card_path_backlog_holds_one_copy_a_request(card_path_on_cpu,
                                                   monkeypatch):
    """Each request holds its device copy from submit on: the admitted ones
    and the producers parked at the admission gate alike, so the gate's
    depth and the producers bound the copies a backlog holds; closing lets
    every one go."""
    copies = []
    counted = keyhash.digest

    def digest(x):
        if isinstance(x, torch.Tensor):
            copies.append(weakref.ref(x))
        return counted(x)

    monkeypatch.setattr(keyhash, "digest", digest)
    svc = YCHGService(Engine(device="cpu"),
                      ServiceConfig(bucket_sides=(64,), **BACKLOG))
    masks = [_mask((64, 64), seed=40 + i) for i in range(4)]
    held = _backlog(svc, masks,
                    lambda: sum(ref() is not None for ref in copies))
    del svc
    gc.collect()
    assert len(copies) == 4 and held == 4
    assert all(ref() is None for ref in copies)


def test_cpu_engine_keys_on_the_host(tracing):
    """A CPU engine keys every probe on the host, says so on the
    ``cache.key_hash`` span, and exports both counts on ``/metrics``."""
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.obs import parse_prom_text

    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    tr = tracing.Trace()
    with YCHGService(Engine(device="cpu"), cfg) as svc, \
            ServerThread(svc) as srv, \
            YCHGClient("127.0.0.1", srv.port) as client:
        svc.submit(RAGGED[0], trace=tr).result(timeout=TIMEOUT)
        for m in RAGGED[:3]:
            svc.analyze(m, timeout=TIMEOUT)
        m = svc.metrics()
        page = {s.name: s.value
                for s in parse_prom_text(client.metrics_text()).samples}
    assert (m.keys_on_device, m.keys_on_host) == (0, 4)
    assert page["ychg_keys_on_device_total"] == 0
    assert page["ychg_keys_on_host_total"] == 4
    (meta,) = [meta for name, _, _, meta in tr.spans()
               if name == "cache.key_hash"]
    assert meta["where"] == "host"


@pytest.fixture
def tracing():
    """Tracing on for the test, whatever it was before."""
    from repro_torch import obs

    was = obs.tracing_enabled()
    obs.configure(enabled=True)
    yield obs
    obs.configure(enabled=was)


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    """The CUDA device, where one is visible; skips the test elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible; this test runs on the card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("n", LENGTHS + [128 * 128 * 4096 + 5])
def test_kernel_is_the_host_digest_at_every_length(card, n):
    a = _bytes(n, seed=n)
    x = torch.from_numpy(a).to(card)
    n0 = keyhash.LAUNCHES["keyhash"]
    assert keyhash.digest(x) == keyhash.digest_host(a)
    assert keyhash.LAUNCHES["keyhash"] == n0 + 1


@pytest.mark.card
@pytest.mark.parametrize("side", [1024, 2048, 4096, 8192])
def test_kernel_is_the_host_digest_at_each_bucket_side(card, side):
    m = _mask((side, side), seed=side)
    assert keyhash.digest(torch.from_numpy(m).to(card)) == \
        keyhash.digest_host(m)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_kernel_is_the_host_digest_of_wide_masks(card, dtype):
    m = (np.random.default_rng(11).random((1500, 1700)) * 2**40).astype(dtype)
    assert keyhash.digest(torch.from_numpy(m).to(card)) == \
        keyhash.digest_host(m)
    # a view off 16 bytes is copied to an aligned block first
    x = torch.from_numpy(_bytes(9000, seed=1)).to(card)[3:]
    assert keyhash.digest(x) == tree_digest(x.cpu().numpy().tobytes())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.float32, np.int64])
def test_cuda_service_keys_on_the_card(card, dtype):
    eng = Engine(device=card)
    masks = [(m * 3).astype(dtype) for m in RAGGED]
    cfg = ServiceConfig(bucket_sides=(64,), **HELD)
    n0 = keyhash.LAUNCHES["keyhash"]
    with YCHGService(eng, cfg) as svc:
        m = _keyed_path_checks(svc, eng, masks, Engine(device=card))
    n = len(masks) + 2
    assert keyhash.LAUNCHES["keyhash"] == n0 + n
    assert (m.keys_on_device, m.keys_on_host) == (n, 0)
    assert (m.key_copies_pinned, m.key_copies_pageable) == (n, 0)
    assert m.coalesced == 1 and m.cache_hits == 1


@pytest.mark.card
def test_cuda_service_under_concurrent_submits(card):
    """Eight threads, each on its own stream, 8192^2 masks and ragged ones
    in two buckets: every answer the engine's own."""
    eng = Engine(device=card)
    cfg = ServiceConfig(bucket_sides=(1024, 8192), max_batch=8)
    masks = [_mask((8192, 8192), seed=s) for s in range(4)] + [
        _mask((700 + s, 1000 - s), seed=s) for s in range(12)]
    results = [None] * len(masks)

    def client(i):
        for j in range(i, len(masks), 8):
            results[j] = svc.submit(masks[j]).result(timeout=TIMEOUT)

    with YCHGService(eng, cfg) as svc:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        m = svc.metrics()
    for mask, r in zip(masks, results):
        _assert_same(r, eng.analyze(mask))
    assert m.keys_on_device == len(masks) and m.keys_on_host == 0


@pytest.mark.card
def test_cuda_pipeline_pads_on_the_card(card):
    masks = [(m * 2.5).astype(np.float32) for m in RAGGED[:4]]
    eng = Engine(device=card)
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    with YCHGService(eng, cfg) as svc:
        got = [svc.submit_pipeline(m, ["denoise", "ychg"]) for m in masks]
        got = [f.result(timeout=TIMEOUT) for f in got]
    for m, g in zip(masks, got):
        den = eng.analyze(m, op="denoise").image[0]
        _assert_same(g, eng.analyze(den))


@pytest.mark.card
def test_cuda_service_failed_flush_then_serves(card):
    eng = _FailingEngine(device=card)
    cfg = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)
    with YCHGService(eng, cfg) as svc:
        with pytest.raises(RuntimeError, match="engine down"):
            svc.submit(RAGGED[0]).result(timeout=TIMEOUT)
        eng.fail = False
        got = svc.submit(RAGGED[1]).result(timeout=TIMEOUT)
    _assert_same(got, Engine(device=card).analyze(RAGGED[1]))


@pytest.mark.card
def test_cuda_service_lets_its_copies_go(card):
    """Once a service has closed, every device copy it made is freed,
    those of shed requests too while their exceptions are kept: nothing
    is left for the allocator, or the garbage collector, to free later."""
    cfg = ServiceConfig(bucket_sides=(64,), cache_entries=0,
                        max_queue_depth=1, overload_policy="shed", **HELD)

    def serve(masks, shed):
        # the kept exceptions' tracebacks keep this frame: its answer goes
        with YCHGService(Engine(device=card), cfg) as svc:
            first = svc.submit(masks[0])   # waits in its batch until close
            for m in masks[1:]:
                with pytest.raises(ServiceOverloaded) as e:
                    svc.submit(m)
                shed.append(e.value)
        first.result(timeout=TIMEOUT)
        del first

    serve(RAGGED[:1], [])   # the kernels' builds and the lazy allocations
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    shed = []
    serve(RAGGED, shed)
    gc.collect()
    torch.cuda.synchronize()
    assert len(shed) == len(RAGGED) - 1
    assert torch.cuda.memory_allocated(card) == before


@pytest.mark.card
def test_cuda_backlog_holds_one_device_copy_a_request(card):
    """On a CUDA engine the device memory a backlog takes is a mask's copy
    for each request admitted and not yet computed and for each producer
    parked at the admission gate (``overload_policy="block"``):
    ``max_queue_depth`` and the producers bound it. Closing lets it go."""
    side = 512
    masks = [_mask((side, side), seed=40 + i) for i in range(4)]
    warm = ServiceConfig(bucket_sides=(side,), max_batch=8, max_delay_ms=1.0,
                         cache_entries=0)
    with YCHGService(Engine(device=card), warm) as svc:
        svc.submit(masks[0]).result(timeout=TIMEOUT)   # builds, warm-up
    del svc
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)

    def held():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(card) - before

    svc = YCHGService(Engine(device=card),
                      ServiceConfig(bucket_sides=(side,), **BACKLOG))
    got = _backlog(svc, masks, held)
    del svc
    gc.collect()
    torch.cuda.synchronize()
    assert got == 4 * side * side
    assert torch.cuda.memory_allocated(card) == before
