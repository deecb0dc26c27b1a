"""A NumPy model of how the packed kernels (``csrc/ychg_packed.cu`` over the
scan of ``csrc/ychg_scan.cuh``) compute ``packed_colscan`` and
``packed_analyze`` (the kernels themselves run only on the card), held to
the plain versions and to the JAX package's Pallas kernels in interpret
mode.

The model follows the kernel step by step: four packed bytes in one
little-endian 32-bit word (a narrower vector zero-extended), the rising
bits of each byte from the word and the word one packed row above, counted
in the word's byte lanes by three SWAR steps; the vector width chosen from
the base address and the pitch; tiles of ``lanes`` vectors; ``threads /
lanes`` row segments, each entered with the packed word above it (0 at
the top); byte lanes wrapping at 256 and flushed every ``chunk`` packed
rows into 16-bit lanes, which wrap at 65536 and are flushed every
``pair_chunks`` chunks; the halo column and step 2 of the fused kernel.
It runs at the constants the sources declare and at small ones.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ychg_packed as jax_packed  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ychg_packed as kp  # noqa: E402

CSRC = Path(kp.__file__).resolve().parent / "csrc"


def _constants(name):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", (CSRC / name).read_text())}


SCAN = _constants("ychg_scan.cuh")
PACKED = _constants("ychg_packed.cu")
H100_SMS = 132
# tests/test_torch_packed.py's SHAPES
SHAPES = [(1, 1), (7, 5), (16, 128), (33, 200), (128, 384), (257, 131),
          (5, 1024), (1, 77), (40, 1), (13, 129)]
FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
          "n_hyperedges", "n_transitions")


def _mask(shape, seed, p=0.45):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


def _packed(shape, seed):
    return kp.pack_rows(torch.from_numpy(_mask(shape, seed))).numpy()


def model_rising_lanes(w, above):
    """Runs that start in each byte of the uint32 words ``w``, counted in
    the word's byte lanes, given the words one packed row above."""
    w = np.asarray(w, np.uint32)
    above = np.asarray(above, np.uint32)
    prev = ((w << 1) & np.uint32(0xFEFEFEFE)) | (
        (above >> 7) & np.uint32(0x01010101))
    r = w & ~prev
    y = (r | (r >> 1)) & np.uint32(0x55555555)
    z = (y + (y >> 2)) & np.uint32(0x33333333)
    return (z + (z >> 4)) & np.uint32(0x0F0F0F0F)


def model_vec_bytes(addr, w):
    """The widest vector (16 down to 1 byte) dividing both the base address
    and the pitch of a packed row, as ``vec_bytes`` picks it."""
    a = addr | w
    v = SCAN["kMaxVecBytes"]
    while v > 1 and a % v:
        v >>= 1
    return v


def model_choose_packed_tiles(nvec, sms):
    """``choose_packed_lanes``: kPackedThreads a block, the widest tile
    whose blocks reach two a SM, else the narrowest."""
    lanes = SCAN["kMaxLanes"]
    while lanes > SCAN["kMinLanes"] and -(-nvec // lanes) < 2 * sms:
        lanes >>= 1
    return lanes, PACKED["kPackedThreads"]


def _words(packed, vec):
    """(Hp, nvec, words) little-endian uint32 words of each vector."""
    hp, w = packed.shape
    v = packed.reshape(hp, w // vec, vec)
    if vec < 4:
        v = np.concatenate([v, np.zeros((hp, w // vec, 4 - vec), np.uint8)],
                           2)
    return np.ascontiguousarray(v).view("<u4")


def _columns(pair, vec):
    """The per-column counts of 16-bit lanes ``pair`` (..., 2 * words):
    pair[2i] holds columns 4i and 4i + 2, pair[2i + 1] 4i + 1 and 4i + 3."""
    cols = []
    for e in range(vec):
        p = pair[..., 2 * (e // 4) + (e & 1)]
        cols.append((p >> 16) if e & 2 else (p & 0xFFFF))
    return np.stack(cols, -1).astype(np.int64)


def _segment_runs(words, r0, rows, chunk, pair_chunks, vec):
    """Per-column counts (nvec, vec) of one segment, as the kernel keeps
    them: byte lanes a chunk, then 16-bit lanes spilled every pair_chunks
    chunks (uint32 arithmetic, so a lane that overflows carries into the
    next as it would on the card)."""
    above = words[r0 - 1] if r0 else np.zeros_like(words[0])
    rising = model_rising_lanes(words[r0:r0 + rows],
                                np.concatenate([above[None],
                                                words[r0:r0 + rows - 1]]))
    total = np.zeros(words.shape[1:2] + (vec,), np.int64)
    pair = np.zeros(words.shape[1:2] + (2 * words.shape[2],), np.uint32)
    for k, r in enumerate(range(0, rows, chunk)):
        acc = rising[r:r + chunk].sum(0, dtype=np.uint32)
        pair[:, 0::2] += acc & np.uint32(0x00FF00FF)
        pair[:, 1::2] += (acc >> 8) & np.uint32(0x00FF00FF)
        if (k + 1) % pair_chunks == 0 and r + chunk < rows:
            total += _columns(pair, vec)
            pair[:] = 0
    return total + _columns(pair, vec)


def _halo_runs(packed, col, r0, rows):
    """The halo column's count in one segment: one byte a row, counted in
    an int, as the tile's first lane does it."""
    b = packed[r0:r0 + rows, col].astype(np.uint32)
    above = np.concatenate([packed[r0 - 1:r0, col] if r0 else
                            np.zeros(1, np.uint8), packed[r0:r0 + rows - 1,
                                                          col]])
    return int(model_rising_lanes(b, above.astype(np.uint32)).sum())


def model_packed(packed, *, addr=0, fused=True, sms=H100_SMS, lanes=None,
                 threads=None, chunk=None, pair_chunks=None):
    """The kernels' decomposition of a (Hp, W) packed mask whose base is
    ``addr`` bytes off 16: the seven ``packed_analyze`` fields, or
    ``{"runs"}`` for the scan alone."""
    auto_lanes, auto_threads = model_choose_packed_tiles(
        packed.shape[1] // model_vec_bytes(addr, packed.shape[1]), sms)
    lanes = lanes or auto_lanes
    threads = threads or auto_threads
    chunk = chunk or SCAN["kPackedChunk"]
    pair_chunks = pair_chunks or SCAN["kPairChunks"]
    hp, w = packed.shape
    vec = model_vec_bytes(addr, w)
    segs = threads // lanes
    tile_w = lanes * vec
    words = _words(packed, vec)
    seg = -(-hp // segs)
    runs = np.zeros(w, np.int64)
    c0s = np.arange(tile_w, w, tile_w) if fused else np.arange(0)
    halo = np.zeros(len(c0s), np.int64)
    for s in range(segs):
        r0 = s * seg
        rows = min(seg, hp - r0)
        if rows <= 0:
            break
        runs += _segment_runs(words, r0, rows, chunk, pair_chunks,
                              vec).reshape(w)
        for i, c0 in enumerate(c0s):
            halo[i] += _halo_runs(packed, c0 - 1, r0, rows)
    if not fused:
        return {"runs": runs.astype(np.int32)}
    left = np.concatenate([[0], runs[:-1]])
    left[c0s] = halo                       # the tile's own count
    delta = runs - left
    births = np.maximum(delta, 0)
    return {"runs": runs.astype(np.int32),
            "cut_vertices": (2 * runs).astype(np.int32),
            "transitions": delta != 0,
            "births": births.astype(np.int32),
            "deaths": np.maximum(-delta, 0).astype(np.int32),
            "n_hyperedges": np.int32(births.sum()),
            "n_transitions": np.int32((delta != 0).sum())}


def assert_fields(got, want, label=""):
    assert set(got) == set(want), label
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (label, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


def _plain(packed, fused=True):
    t = torch.from_numpy(packed)
    if fused:
        return {k: v.numpy() for k, v in kp.packed_fused_plain(t).items()}
    return {"runs": kp.packed_colscan_plain(t).numpy()}


# ------------------------------------------------------------- constants


def test_sources_declare_the_model_constants():
    """A byte lane holds a chunk of packed rows at 4 runs a row, the 16-bit
    lanes kPairChunks chunks; the chunk is whole unrolled steps; the
    default block fits the 64-register budget of the scan's launch
    bounds; and the packed kernels are the scan of ychg_scan.cuh."""
    chunk = SCAN["kPackedChunk"]
    assert 4 * chunk <= 255 and chunk % SCAN["kUnroll"] == 0
    assert 4 * chunk * SCAN["kPairChunks"] < 1 << 16
    assert PACKED["kPackedThreads"] in (256, 512, 1024)
    source = (CSRC / "ychg_packed.cu").read_text()
    assert '#include "ychg_scan.cuh"' in source
    assert "scan_tile<PackedRows, V, false, kPackedThreads>" in source
    assert "scan_tile<PackedRows, V, true, kPackedThreads>" in source
    assert "__popc(" not in source


def test_c_signatures_match_the_bindings():
    """Every C entry point of ychg_packed.cu is bound with as many ctypes
    arguments as it declares."""
    source = (CSRC / "ychg_packed.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source))
    assert set(decls) == set(kp._SIGNATURES)
    for name, params in decls.items():
        assert len(params.split(",")) == len(kp._SIGNATURES[name]), name


# -------------------------------------------------- the word's arithmetic


@pytest.mark.parametrize("lane", range(4))
@pytest.mark.parametrize("carry", [0, 1])
def test_every_byte_and_carry_counts_as_popcount(carry, lane):
    """All 256 bytes with the MSB of the byte above 0 and 1 (512 pairs),
    in each byte lane of the word: the SWAR count equals _popcount8 of
    b & ~((b << 1) | carry)."""
    b = np.arange(256, dtype=np.uint32)
    above = np.full(256, carry << 7, np.uint32)
    got = model_rising_lanes(b << (8 * lane), above << (8 * lane))
    assert not (got & ~np.uint32(0xFF << (8 * lane))).any()
    rising = torch.from_numpy((b & ~((b << 1) | carry) & 0xFF).astype(
        np.int32))
    np.testing.assert_array_equal((got >> (8 * lane)).astype(np.int32),
                                  kp._popcount8(rising).numpy())
    assert (got >> (8 * lane)).max() == 4


def test_byte_lanes_of_a_word_do_not_interact():
    """Random words: each byte lane's count depends on its own byte and
    the MSB of the byte above it alone."""
    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    got = model_rising_lanes(w, a)
    for lane in range(4):
        b = (w >> (8 * lane)) & 0xFF
        c = (a >> (8 * lane + 7)) & 1
        rising = torch.from_numpy((b & ~((b << 1) | c) & 0xFF).astype(
            np.int32))
        np.testing.assert_array_equal(
            ((got >> (8 * lane)) & 0xFF).astype(np.int32),
            kp._popcount8(rising).numpy())


# ------------------------------------------------------ tiles and widths


@pytest.mark.parametrize("w,addr,want", [
    (21000, 0, 8), (8192, 0, 16), (512, 0, 16), (520, 0, 8), (516, 0, 4),
    (514, 0, 2), (513, 0, 1), (512, 1, 1), (512, 2, 2), (512, 4, 4),
    (512, 8, 8), (512, 6, 2)])
def test_model_vector_width(w, addr, want):
    assert model_vec_bytes(addr, w) == want


@pytest.mark.parametrize("w,want", [
    (21000, (8, 256)), (8192, (4, 256)), (1, (4, 256)), (65536, (8, 256)),
    (2 * H100_SMS * 32 * 16, (32, 256))])
def test_packed_tiles_at_the_main_shapes(w, want):
    """The tiles ychg_packed.cu's header names: the packed 21000^2 scene
    (2625 vectors of 8 B) takes 8 lanes, 329 blocks of 256 threads, 32
    segments; the packed 8192^2 mask (512 vectors of 16 B) 4 lanes, 128
    blocks, 64 segments."""
    nvec = w // model_vec_bytes(0, w)
    assert model_choose_packed_tiles(nvec, H100_SMS) == want
    lanes, threads = want
    if w == 21000:
        assert -(-nvec // lanes) == 329 and threads // lanes == 32
    if w == 8192:
        assert -(-nvec // lanes) == 128 and threads // lanes == 64


# --------------------------------------------- the model against the rest


@pytest.mark.parametrize("shape", SHAPES)
def test_model_matches_plain_and_jax(shape):
    """At the declared constants, bases 0, 1, 4 and 8 bytes off 16, on 132
    SMs and on 3: the scan against packed_colscan_plain and the JAX
    packed_colscan, the fused kernel against packed_fused_plain and the JAX
    packed_analyze of the unpacked mask."""
    img = _mask(shape, seed=31 + shape[0] * 7 + shape[1])
    packed = kp.pack_rows(torch.from_numpy(img)).numpy()
    want_runs = {"runs": np.asarray(jax_packed.packed_colscan(
        jnp.asarray(packed)))}
    want = {k: np.asarray(v) for k, v in
            jax_packed.packed_analyze(jnp.asarray(img)).items()}
    assert_fields(_plain(packed), want, "plain")
    for addr in (0, 1, 4, 8):
        for sms in (H100_SMS, 3):
            label = f"{shape} addr {addr} sms {sms}"
            assert_fields(model_packed(packed, addr=addr, sms=sms,
                                       fused=False), want_runs, label)
            assert_fields(model_packed(packed, addr=addr, sms=sms), want,
                          label)


@pytest.mark.parametrize("w", [512, 520, 516, 514, 513, 8200, 8197])
def test_model_ragged_width_at_each_vector_width(w):
    """W mod 16 = 0, 8, 4, 2 and 1 (vectors of 16, 8, 4, 2 and 1 bytes),
    at the declared tiles and at small ones whose tiles end inside the
    row, so the ragged edge and every halo column are crossed."""
    packed = _packed((200, w), seed=w)
    want = _plain(packed)
    for lanes, threads in ((None, None), (4, 8), (2, 8), (1, 3)):
        assert_fields(model_packed(packed, lanes=lanes, threads=threads),
                      want, f"W {w} lanes {lanes}")
    assert_fields(model_packed(packed, fused=False, lanes=4, threads=8),
                  {"runs": want["runs"]}, f"W {w}")


@pytest.mark.parametrize("lanes,threads,chunk,pair_chunks", [
    (4, 8, 3, 2), (2, 8, 5, 3), (1, 3, 2, 1), (8, 16, 4, 2)])
def test_model_small_tiles_and_flushes(lanes, threads, chunk, pair_chunks):
    """Small tiles, segment counts and flush periods, so that every flush,
    every segment entry and every halo runs at a small size; dense 0x55
    columns (4 runs a byte) beside random ones."""
    for w, addr in [(17, 0), (40, 8), (33, 1), (64, 4)]:
        packed = _packed((50, w), seed=w * lanes)
        packed[:, :5] = 0x55
        want = _plain(packed)
        got = model_packed(packed, addr=addr, lanes=lanes, threads=threads,
                           chunk=chunk, pair_chunks=pair_chunks)
        assert_fields(got, want, f"W {w} addr {addr}")


def test_model_byte_lanes_need_their_flush():
    """A 0x55 column (alternating rows) has 4 runs a packed byte: one
    segment of 130 packed rows crosses two byte-lane flushes and counts
    right; with no flush its byte lane wraps past 63 rows and the model
    (like the kernel) counts wrong, and 64 rows a chunk already wrap."""
    packed = np.full((130, 16), 0x55, np.uint8)
    packed[::7, 3] = 0x15
    want = _plain(packed)
    assert_fields(model_packed(packed, lanes=4, threads=4), want)
    wrapped = model_packed(packed, lanes=4, threads=4, chunk=1024)
    assert not np.array_equal(wrapped["runs"], want["runs"])
    assert_fields(model_packed(packed[:63], lanes=4, threads=4, chunk=63),
                  _plain(packed[:63]))
    wrapped = model_packed(packed[:64], lanes=4, threads=4, chunk=64)
    assert not np.array_equal(wrapped["runs"], _plain(packed[:64])["runs"])


def test_model_16bit_lanes_need_their_flush():
    """One segment of 16,400 packed rows of 0x55 (65,600 runs a column)
    passes a 16-bit lane's 65,535: at the declared flush period it counts
    right, without the flush it wraps."""
    packed = np.full((16_400, 4), 0x55, np.uint8)
    packed[::5, 2] = 0x54
    want = _plain(packed, fused=False)
    assert int(want["runs"][0]) == 65_600
    assert_fields(model_packed(packed, fused=False, lanes=1, threads=1),
                  want)
    wrapped = model_packed(packed, fused=False, lanes=1, threads=1,
                           pair_chunks=10 ** 6)
    assert not np.array_equal(wrapped["runs"], want["runs"])


def test_model_enters_each_segment_from_the_packed_row_above():
    """All-one columns are one run from top to bottom: a segment entered
    with nothing above it would count a run at every segment start."""
    packed = np.full((40, 16), 0xFF, np.uint8)
    got = model_packed(packed, lanes=4, threads=32)
    assert (got["runs"] == 1).all() and int(got["n_hyperedges"]) == 1
    assert_fields(got, _plain(packed))


# ------------------------------------------------------------ the wrapper


def test_launch_fused_fills_one_zeroed_buffer(monkeypatch):
    """The fused wrapper's plumbing, with the C entry point stubbed: one
    zeroed buffer holds all seven fields, with the dtypes and shapes of
    the plain version; its pointers go out in the C entry point's order;
    no device is made current."""
    calls = []

    class Library:
        def ychg_packed_fused(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kp, "_cuda_packed", lambda packed: None)
    monkeypatch.setattr(_build, "load", lambda name, sig: Library())
    monkeypatch.setattr(_build, "on_stream",
                        lambda x, fn, *args: fn(*args, 0))
    packed = torch.from_numpy(_packed((64, 77), seed=1))
    before = kp.LAUNCHES["ychg_packed_fused"]
    out = kp.launch_fused(packed)
    assert kp.LAUNCHES["ychg_packed_fused"] == before + 1
    want = kp.packed_fused_plain(packed)
    assert tuple(out) == FIELDS
    base = out["runs"].untyped_storage().data_ptr()
    for k in FIELDS:
        assert out[k].dtype == want[k].dtype and out[k].shape == want[k].shape
        assert out[k].untyped_storage().data_ptr() == base, k
        assert out[k].is_contiguous() and not out[k].any(), k
    (args,) = calls
    assert args[:3] == (packed.data_ptr(), 8, 77)
    assert list(args[3:10]) == [out[k].data_ptr() for k in FIELDS]


@pytest.mark.parametrize("w", [0, 1, 5, 17])
def test_launch_fused_fields_are_disjoint_views(monkeypatch, w):
    """The fused wrapper's fields at every width, with the C entry point
    stubbed: (W,) planes and 0-d totals with the dtypes of the plain
    version, zeroed, contiguous, views of one buffer laid out as
    ``zeroed_outputs`` lays out a batch of one, no two overlapping."""
    from repro_torch.core import ychg

    class Library:
        def ychg_packed_fused(self, *args):
            return 0

    monkeypatch.setattr(kp, "_cuda_packed", lambda packed: None)
    monkeypatch.setattr(_build, "load", lambda name, sig: Library())
    monkeypatch.setattr(_build, "on_stream",
                        lambda x, fn, *args: fn(*args, 0))
    one = kp.launch_fused(torch.zeros(2, w, dtype=torch.uint8))
    batch = ychg.zeroed_outputs(FIELDS, 1, w, torch.device("cpu"))
    want = kp.packed_fused_plain(torch.zeros(2, w, dtype=torch.uint8))
    assert tuple(one) == FIELDS
    spans = []
    for k in FIELDS:
        v = one[k]
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        assert v.is_contiguous() and not v.any(), k
        assert (v.storage_offset() * v.itemsize
                == batch[k].storage_offset() * batch[k].itemsize), k
        assert (v.untyped_storage().data_ptr()
                == one["runs"].untyped_storage().data_ptr()), k
        start = v.storage_offset() * v.itemsize
        spans.append((start, start + v.numel() * v.itemsize))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
