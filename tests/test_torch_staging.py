"""The staged copy onto the card (``engine.PinnedStager``), ``Engine.put``
and the service's submit copy through it.

On the CPU: the chunk plan, the stager on CPU tensors (its page-locked
slot stood in for), an array not in the machine's byte order refused as
``host_tensor`` refuses it, ``Engine.put`` on CPU and meshed engines and
its card branch rehearsed on a CPU engine (the engine's one predicate,
``puts_on_card``, patched), the service through that branch, the fallback
to a pageable copy, a CPU engine's service, which keys on the host and
stages nothing (``pinned=0``, ``copy="none"``), and the ingest's narrowing
of 64-bit integers before its copy.
Tests marked ``card`` hold the staged copy to ``host_tensor(a).to(device)`` bit for bit
and the service under concurrent submitters that reuse their buffers, on a
CUDA card, and skip elsewhere; run them there with ``python -m pytest
--noconftest -q tests/test_torch_staging.py`` (this file imports no JAX).
"""

import contextlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import Engine  # noqa: E402
from repro_torch.engine import engine as engine_mod  # noqa: E402
from repro_torch.engine.engine import (  # noqa: E402
    STAGE_CHUNK_BYTES,
    PinnedStager,
    chunk_plan,
    host_tensor,
)
from repro_torch.kernels import keyhash  # noqa: E402
from repro_torch.service import (  # noqa: E402
    ServiceConfig,
    YCHGService,
    make_key,
)
from repro_torch.sharding import make_batch_mesh  # noqa: E402

TIMEOUT = 300.0
FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
          "n_hyperedges", "n_transitions")
DTYPES = [np.bool_, np.uint8, np.float32, np.int64]
C = STAGE_CHUNK_BYTES


def _mask(shape, seed=0, dtype=np.uint8, density=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(dtype)


def _valued(shape, dtype, seed):
    """Values that use every byte of the dtype (bool: 0 and 1)."""
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    raw = rng.integers(0, 256, int(np.prod(shape)) * np.dtype(dtype).itemsize,
                       dtype=np.uint8)
    return raw.view(dtype).reshape(shape)


def _same_tensor(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.device == want.device
    g = got.reshape(-1).view(torch.uint8).cpu()
    w = want.reshape(-1).view(torch.uint8).cpu()
    assert torch.equal(g, w)


def _assert_same(got, want):
    g, w = got.to_host(), want.to_host()
    for f in FIELDS:
        assert g[f].dtype == w[f].dtype, f
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)


def _stager(monkeypatch, chunk):
    """A stager whose pieces are ``chunk`` bytes."""
    monkeypatch.setattr(engine_mod, "STAGE_CHUNK_BYTES", chunk)
    return PinnedStager()


RAGGED = [_mask((17, 23), 1), _mask((64, 64), 2), _mask((33, 40), 3),
          _mask((5, 60), 4), _mask((1, 1), 5), np.zeros((30, 30), np.uint8)]


# ----------------------------------------------------------------- the CPU


@pytest.mark.parametrize("n", [0, 1, C - 1, C, C + 1, 3 * C + 5])
def test_chunk_plan_covers_every_byte_once(n):
    plan = chunk_plan(n, C)
    assert len(plan) == -(-n // C)
    # in order, each piece starting where the last stopped: every byte once
    stops = [0]
    for i, j in plan:
        assert i == stops[-1] and 0 < j - i <= C
        stops.append(j)
    assert stops[-1] == n
    if n and n <= C:
        assert plan == [(0, n)]   # no larger than a chunk: one piece


@pytest.mark.parametrize("chunk", [7, 64])
def test_chunk_plan_at_small_chunks(chunk):
    for n in range(0, 4 * chunk + 2):
        plan = chunk_plan(n, chunk)
        covered = np.zeros(n, np.int64)
        for i, j in plan:
            assert 0 < j - i <= chunk
            covered[i:j] += 1
        assert (covered == 1).all() and len(plan) == -(-n // chunk)


@pytest.fixture
def staged_on_cpu(monkeypatch):
    """The stager's slot plain host memory (on a machine with a card
    too)."""
    monkeypatch.setattr(engine_mod, "pinned_buffer",
                        lambda n: torch.empty(n, dtype=torch.uint8))


@pytest.fixture
def put_on_card_on_cpu(staged_on_cpu, monkeypatch):
    """``Engine.put``'s card branch on a CPU engine: the engine's predicate
    says yes and the branch's CUDA stream calls do nothing, so the copy
    runs through the stager onto CPU tensors."""
    monkeypatch.setattr(Engine, "puts_on_card", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,chunk", [
    ((0, 7), 64), ((1, 1), 64), ((33, 40), 64), ((33, 40), 5),
    ((64, 64), 4096), ((64, 64), 1 << 20)])
def test_stager_gives_the_plain_copy_on_cpu(staged_on_cpu, monkeypatch,
                                            dtype, shape, chunk):
    a = _valued(shape, dtype, seed=sum(shape))
    stager = _stager(monkeypatch, chunk)
    got = stager.to_device(a, "cpu")
    _same_tensor(got, host_tensor(a).to("cpu"))
    # the slot holds the first piece: the whole data, at most a chunk
    held = None if stager._slot is None else stager._slot.numel()
    assert held == (min(a.nbytes, chunk) or None)


def test_plain_staged_copy_goes_through_the_slots(staged_on_cpu,
                                                  monkeypatch):
    """Each piece lands in the slot before it reaches the copy: the slot
    ends holding the last piece, over the tail of the one before."""
    src = np.arange(23, dtype=np.uint8)
    stager = _stager(monkeypatch, 5)
    got = stager.to_device(src, "cpu")
    assert torch.equal(got, torch.from_numpy(src))
    assert stager._slot.tolist() == [20, 21, 22, 18, 19]


@pytest.mark.parametrize("dtype", [">f4", ">i8", ">i4"])
def test_foreign_byte_order_is_refused_like_the_host_path(staged_on_cpu,
                                                          monkeypatch,
                                                          dtype):
    """An array not in the machine's byte order: the byte copy would give
    swapped values, so the stager refuses it as ``host_tensor`` (torch)
    does, before it copies anything."""
    a = np.arange(12, dtype=dtype).reshape(3, 4)
    with pytest.raises(ValueError, match="byte order"):
        host_tensor(a)
    stager = _stager(monkeypatch, 16)
    with pytest.raises(ValueError, match="byte order"):
        stager.to_device(a, "cpu")
    assert stager._slot is None
    # in the machine's order, the same values copy
    native = a.astype(a.dtype.newbyteorder("="))
    _same_tensor(stager.to_device(native, "cpu"),
                 host_tensor(native).to("cpu"))


def test_stager_slots_hold_the_largest_piece(staged_on_cpu, monkeypatch):
    """The slot is made at the first piece put in it and grows to the
    largest piece since, never past a chunk."""
    stager = _stager(monkeypatch, 100)

    def size():
        return None if stager._slot is None else stager._slot.numel()

    stager.reserve(0)
    assert size() is None
    stager.reserve(30)
    assert size() == 30
    stager.reserve(130)
    assert size() == 100
    stager.reserve(10)
    assert size() == 100
    stager.reserve(1000)
    assert size() == 100


def test_stager_copies_views_and_read_only_arrays(staged_on_cpu,
                                                  monkeypatch):
    base = _valued((40, 50), np.float32, seed=3)
    view = base[::2, 3:]                  # not C-contiguous
    ro = base.copy()
    ro.flags.writeable = False
    stager = _stager(monkeypatch, 96)
    for a in (view, ro):
        _same_tensor(stager.to_device(a, "cpu"), host_tensor(a).to("cpu"))


def _trace_meta(tracing, name):
    return [meta for n, _, _, meta in tracing.spans() if n == name]


@pytest.fixture
def tracing():
    """Tracing on for the test, whatever it was before."""
    from repro_torch import obs

    was = obs.tracing_enabled()
    obs.configure(enabled=True)
    yield obs
    obs.configure(enabled=was)


CFG = ServiceConfig(bucket_sides=(64,), max_batch=4, max_delay_ms=1.0)


def _serve(svc, engine, masks, tr):
    got = [svc.submit(m, trace=tr).result(timeout=TIMEOUT) for m in masks]
    backend = engine.resolve_backend()
    for m, g in zip(masks, got):
        _assert_same(g, Engine(device="cpu").analyze(m))
        key = make_key(m, backend, engine.config, op="ychg",
                       digest=keyhash.digest_host(m))
        assert svc.cache.get(key) is g
    return svc.metrics()


def test_cpu_engine_keys_as_before_and_stages_nothing(tracing):
    """A CPU engine keys on the host, its keys the host digest's; it makes
    no copy onto a card, so its ``cache.key_copy`` spans say ``pinned=0``
    and ``copy="none"``, and no copy is counted."""
    eng = Engine(device="cpu")
    tr = tracing.Trace()
    with YCHGService(eng, CFG) as svc:
        m = _serve(svc, eng, RAGGED, tr)
    metas = _trace_meta(tr, "cache.key_copy")
    assert len(metas) == len(RAGGED)
    assert [meta["pinned"] for meta in metas] == [0] * len(RAGGED)
    assert [meta["copy"] for meta in metas] == ["none"] * len(RAGGED)
    assert (m.keys_on_device, m.keys_on_host) == (0, len(RAGGED))
    assert (m.key_copies_pinned, m.key_copies_pageable) == (0, 0)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int64])
def test_card_branch_stages_its_copy_on_cpu(put_on_card_on_cpu, tracing,
                                            dtype):
    """The service's card branch, rehearsed on CPU tensors: every copy
    staged (``pinned=1``, counted), the answers and keys the host's."""
    eng = Engine(device="cpu")
    masks = [(m * 3).astype(dtype) for m in RAGGED]
    tr = tracing.Trace()
    with YCHGService(eng, CFG) as svc:
        m = _serve(svc, eng, masks, tr)
    metas = _trace_meta(tr, "cache.key_copy")
    assert [meta["pinned"] for meta in metas] == [1] * len(masks)
    assert [meta["copy"] for meta in metas] == ["staged"] * len(masks)
    assert (m.keys_on_device, m.keys_on_host) == (len(masks), 0)
    assert (m.key_copies_pinned, m.key_copies_pageable) == (len(masks), 0)


def test_card_branch_falls_back_when_pinning_fails_on_cpu(
        put_on_card_on_cpu, tracing, monkeypatch):
    """Where page-locked slots cannot be had, each request takes the
    pageable copy, says so (``pinned=0``) and is counted; the thread's
    next submit tries again, and stages once the slots can be had."""
    def refuse(n):
        raise RuntimeError("no page-locked memory")

    monkeypatch.setattr(engine_mod, "pinned_buffer", refuse)
    eng = Engine(device="cpu")
    tr = tracing.Trace()
    with YCHGService(eng, CFG) as svc:
        m = _serve(svc, eng, RAGGED[:3], tr)
        assert (m.key_copies_pinned, m.key_copies_pageable) == (0, 3)
        monkeypatch.setattr(engine_mod, "pinned_buffer",
                            lambda n: torch.empty(n, dtype=torch.uint8))
        m = _serve(svc, eng, RAGGED[3:], tr)
    metas = _trace_meta(tr, "cache.key_copy")
    assert [meta["pinned"] for meta in metas] \
        == [0, 0, 0] + [1] * (len(RAGGED) - 3)
    assert [meta["copy"] for meta in metas] \
        == ["pageable"] * 3 + ["staged"] * (len(RAGGED) - 3)
    assert (m.key_copies_pinned, m.key_copies_pageable) == (
        len(RAGGED) - 3, 3)
    assert m.keys_on_device == len(RAGGED)


def _engines():
    """A CPU engine, and a meshed CUDA engine (built without a card): the
    two kinds whose ``put`` keeps the mask on the host."""
    return [Engine(device="cpu"),
            Engine(device="cuda:0",
                   mesh=make_batch_mesh(devices=["cuda:0", "cuda:1"]))]


def test_put_on_the_card_only_without_a_mesh():
    assert [e.puts_on_card for e in _engines()] == [False, False]
    assert Engine(device="cuda").puts_on_card


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", [0, 1])
def test_put_keeps_the_mask_on_the_host_off_the_card(dtype, which):
    """On CPU and meshed engines: a CPU tensor of the mask, ``copy``
    ``"none"``, the digest ``digest_host``'s."""
    a = _valued((33, 40), dtype, seed=which)
    x, digest, copy = _engines()[which].put(a)
    _same_tensor(x, host_tensor(a))
    assert copy == "none"
    assert digest == keyhash.digest_host(a)


def test_put_shares_a_writable_array_and_copies_a_read_only_one():
    a = _valued((40, 50), np.uint8, seed=4)
    x = Engine(device="cpu").put(a).tensor
    assert np.shares_memory(x.numpy(), a)
    ro = a.copy()
    ro.flags.writeable = False
    y = Engine(device="cpu").put(ro).tensor
    assert not np.shares_memory(y.numpy(), ro)
    assert np.array_equal(y.numpy(), ro)


@pytest.mark.parametrize("dtype", DTYPES)
def test_put_card_branch_stages_and_digests_on_cpu(put_on_card_on_cpu,
                                                   dtype):
    """Rehearsed on a CPU engine: a copy of the mask (not the caller's
    memory), staged, and the host's digest."""
    a = _valued((33, 40), dtype, seed=5)
    x, digest, copy = Engine(device="cpu").put(a)
    _same_tensor(x, host_tensor(a))
    assert not np.shares_memory(x.numpy(), a)
    assert copy == "staged"
    assert digest == keyhash.digest_host(a)


@pytest.mark.parametrize("card", [False, True])
def test_put_fires_copy_then_digest(request, card):
    if card:
        request.getfixturevalue("put_on_card_on_cpu")
    stages = []
    Engine(device="cpu").put(RAGGED[1],
                             on_stage=lambda *s: stages.append(s))
    (c, c0, c1), (d, d0, d1) = stages
    assert (c, d) == ("copy", "digest")
    assert c0 <= c1 == d0 <= d1


def test_ingest_narrows_64_bit_integers_before_the_copy(monkeypatch):
    """A CPU int64 tensor reaches the engine's device as int32: the copy
    moves the narrowed bytes, as it does for host data."""
    moved = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        out = to(self, *args, **kwargs)
        if out.device != self.device:
            moved.append(self.dtype)
        return out

    monkeypatch.setattr(torch.Tensor, "to", spy)
    eng = Engine(device="meta")
    wide = torch.tensor([[1, 2**32, 2**40 + 1]], dtype=torch.int64)
    for imgs in (wide, wide.numpy()):
        x = eng._ingest(imgs)
        assert x.device.type == "meta" and x.dtype == torch.int32
    assert moved == [torch.int32, torch.int32]
    # on the CPU, the low 32 bits
    got = Engine(device="cpu")._ingest(wide)
    assert got.dtype == torch.int32 and got.tolist() == [[1, 0, 1]]


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    """The CUDA device, where one is visible; skips the test elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible; this test runs on the card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("side", [1024, 2048, 4096, 8192])
def test_staged_copy_is_the_pageable_copy(card, dtype, side):
    a = _valued((side, side), dtype, seed=side)
    stream = torch.cuda.Stream(card)
    with torch.cuda.stream(stream):
        got = PinnedStager().to_device(a, card)
    _same_tensor(got, host_tensor(a).to(card))


@pytest.mark.card
def test_foreign_byte_order_is_refused_on_the_card(card):
    a = np.arange(4096, dtype=">f4").reshape(64, 64)
    with pytest.raises(ValueError, match="byte order"):
        host_tensor(a).to(card)
    with pytest.raises(ValueError, match="byte order"):
        PinnedStager().to_device(a, card)


@pytest.mark.card
@pytest.mark.parametrize("chunk", [C, 1 << 20])
@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_copy_of_empty_and_strided_masks(card, monkeypatch, dtype,
                                                chunk):
    stager = _stager(monkeypatch, chunk)
    base = _valued((3000, 2900), dtype, seed=7)
    for a in (base[:0], base[:, :0], base[::3, 5:], base.T,
              base[:1, :1], base[: chunk // base.itemsize // 2900 + 1]):
        got = stager.to_device(a, card)
        _same_tensor(got, host_tensor(a).to(card))


@pytest.mark.card
def test_callers_overwrite_their_buffers_as_submit_returns(card, tracing):
    """Eight threads submit at once, each from one buffer that it
    overwrites as soon as ``submit`` returns: every answer is the one of
    the mask the buffer held at the submit, every copy staged."""
    eng = Engine(device=card)
    cfg = ServiceConfig(bucket_sides=(1024, 8192), max_batch=8,
                        cache_entries=0)
    masks = [_mask((8192, 8192), seed=s) for s in range(8)] + [
        _mask((700 + s, 1000 - s), seed=s) for s in range(16)]
    futures = [None] * len(masks)
    tr = tracing.Trace()
    errors = []

    def client(i):
        try:
            bufs = {}
            for j in range(i, len(masks), 8):
                buf = bufs.setdefault(masks[j].shape,
                                      np.empty_like(masks[j]))
                np.copyto(buf, masks[j])
                futures[j] = svc.submit(buf, trace=tr)
                buf[...] = 1 - buf       # the caller's next use, at once
        except BaseException as e:
            errors.append(e)

    with YCHGService(eng, cfg) as svc:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        got = [f.result(timeout=TIMEOUT) for f in futures]
        m = svc.metrics()
    for mask, r in zip(masks, got):
        _assert_same(r, eng.analyze(mask))
    assert (m.key_copies_pinned, m.key_copies_pageable) == (len(masks), 0)
    assert all(meta["pinned"] == 1
               for meta in _trace_meta(tr, "cache.key_copy"))


@pytest.mark.card
def test_failed_pinning_falls_back_to_the_pageable_copy(card, tracing,
                                                        monkeypatch):
    def refuse(n):
        raise RuntimeError("no page-locked memory")

    monkeypatch.setattr(engine_mod, "pinned_buffer", refuse)
    eng = Engine(device=card)
    tr = tracing.Trace()
    masks = [_mask((1024, 1024), seed=s) for s in range(3)]
    cfg = ServiceConfig(bucket_sides=(1024,), max_batch=4, max_delay_ms=1.0)
    with YCHGService(eng, cfg) as svc:
        got = [svc.submit(m, trace=tr).result(timeout=TIMEOUT)
               for m in masks]
        m = svc.metrics()
    for mask, r in zip(masks, got):
        _assert_same(r, eng.analyze(mask))
    assert (m.key_copies_pinned, m.key_copies_pageable) == (0, 3)
    assert [meta["pinned"] for meta in _trace_meta(tr, "cache.key_copy")] \
        == [0, 0, 0]
