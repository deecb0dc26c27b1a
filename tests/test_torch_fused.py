"""Parity: the port's fused kernel wrappers and ``analyze_fused`` on the CPU
against the JAX package's Pallas kernels in interpret mode.

On a CPU tensor each wrapper runs its kernel's plain version; the CUDA
kernels themselves are held to those plain versions on the card by
``chip_smoke.py``. Here: both routes, the seam shapes, routing parity, the
wrappers' refusals, and that importing builds nothing.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ychg_fused import (  # noqa: E402
    fused_analyze_pallas,
    fused_analyze_streamed,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ychg_fused as kf  # noqa: E402
from ychg_invariants import SUMMARY_FIELDS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT_KEYS = ("runs", "transitions", "births", "deaths", "n_hyperedges",
            "n_transitions")


def assert_same(got, want, label=""):
    g = got.cpu().numpy()
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{label}: {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{label}: {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=label)


def assert_dicts_same(got, want):
    assert set(got) == set(want) == set(OUT_KEYS)
    for k in OUT_KEYS:
        assert_same(got[k], want[k], k)


def _stack(shape, seed, p=0.5, dtype=np.uint8):
    return (np.random.default_rng(seed).random(shape) < p).astype(dtype)


# ------------------------------------------------------- full-column route


@pytest.mark.parametrize("shape,dtype", [
    ((2, 7, 5), np.uint8), ((2, 33, 200), np.int32),
    ((3, 16, 128), np.bool_), ((1, 5, 1024), np.float32),
    ((2, 1, 300), np.uint8), ((2, 200, 1), np.uint8),
    ((1, 1, 1), np.uint8), ((2, 19, 141), np.int16),
])
def test_full_matches_pallas_interpret(shape, dtype):
    imgs = _stack(shape, sum(shape), dtype=dtype)
    assert_dicts_same(kf.ychg_fused_full(torch.from_numpy(imgs)),
                      fused_analyze_pallas(jnp.asarray(imgs), interpret=True))


@pytest.mark.parametrize("fill", [0, 1])
def test_full_constant_masks(fill):
    imgs = np.full((3, 19, 141), fill, np.uint8)
    assert_dicts_same(kf.ychg_fused_full(torch.from_numpy(imgs)),
                      fused_analyze_pallas(jnp.asarray(imgs), interpret=True))


# ----------------------------------------------------------- split-H route


@pytest.mark.parametrize("shape,block_h", [
    ((2, 130, 140), 4), ((2, 130, 140), 16), ((2, 33, 129), 16),
    ((1, 130, 257), 16), ((3, 257, 131), 16), ((2, 64, 8), 16),
])
def test_splith_matches_streamed_interpret(shape, block_h):
    """The seam shapes of tests/test_ychg_fused.py: H and W not multiples of
    the block sizes, and runs crossing every H seam."""
    p = 1.0 if shape == (2, 64, 8) else 0.6
    imgs = _stack(shape, sum(shape), p=p)
    assert_dicts_same(
        kf.ychg_fused_splith(torch.from_numpy(imgs), block_h=block_h),
        fused_analyze_streamed(jnp.asarray(imgs), block_h=block_h,
                               interpret=True))


def test_splith_matches_full_plain():
    imgs = torch.from_numpy(_stack((2, 96, 200), 2))
    assert_dicts_same(kf.ychg_fused_splith_plain(imgs, 32),
                      {k: v.numpy() for k, v in
                       kf.ychg_fused_full_plain(imgs).items()})


# ------------------------------------------------------------ analyze_fused


@pytest.mark.parametrize("shape", [(45, 77), (3, 33, 200), (0, 8, 9)])
def test_analyze_fused_matches_jax(shape):
    imgs = _stack(shape, len(shape))
    got = tops.analyze_fused(torch.from_numpy(imgs))
    want = jops.analyze_fused(jnp.asarray(imgs))
    for f in SUMMARY_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f)


def test_routing_matches_jax(monkeypatch):
    """The split-H kernel runs exactly where the reference streams: when
    H * block_w exceeds the budget; results stay identical either way."""
    calls = []

    def spy(mod, name, tag):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(tag)
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(kf, "ychg_fused_full", "port-full")
    spy(kf, "ychg_fused_splith", "port-split")
    spy(jops._f, "fused_analyze_pallas", "jax-full")
    spy(jops._f, "fused_analyze_streamed", "jax-split")
    imgs = _stack((2, 70, 150), 3)
    for budget in (1, 70 * 128 - 1, 70 * 128, 1 << 30):
        calls.clear()
        got = tops.analyze_fused(torch.from_numpy(imgs), block_h=32,
                                 vmem_budget=budget)
        want = jops.analyze_fused(jnp.asarray(imgs), block_h=32,
                                  vmem_budget=budget)
        split = budget < 70 * 128
        assert calls == (["port-split", "jax-split"] if split
                         else ["port-full", "jax-full"]), (budget, calls)
        for f in SUMMARY_FIELDS:
            assert_same(getattr(got, f), getattr(want, f), f)


# ---------------------------------------------------------------- refusals


def test_wrappers_refuse_bad_input():
    x4 = torch.zeros((1, 2, 3, 4), dtype=torch.uint8)
    for fn in (kf.ychg_fused_full, kf.ychg_fused_splith):
        with pytest.raises(ValueError, match="stack"):
            fn(x4)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros((2, 8, 6), dtype=torch.uint8).transpose(1, 2))
        with pytest.raises(TypeError):
            fn(np.zeros((1, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="block_h"):
        kf.ychg_fused_splith(torch.zeros((1, 4, 4)), block_h=0)
    with pytest.raises(ValueError):
        tops.analyze_fused(x4)


def test_kernel_path_refuses_without_cuda():
    """The kernel path never falls back: a CPU tensor is refused, and the
    library will not load (or build) in a process that sees no card."""
    x = torch.zeros((1, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kf.launch_full(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kf.launch_splith(x, block_h=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("ychg_fused", kf._SIGNATURES)
    assert _build.loaded() == ()


def test_importing_builds_nothing(tmp_path):
    """Importing the kernel modules and running their CPU path starts no
    process (no nvcc) and loads no library."""
    script = textwrap.dedent("""
        import subprocess

        def refuse(*a, **k):
            raise AssertionError("a process was started")

        subprocess.Popen = subprocess.run = refuse
        import torch
        from repro_torch.kernels import _build, ops, ychg_fused
        ops.analyze_fused(torch.ones((2, 5, 7), dtype=torch.uint8))
        ops.analyze_fused(torch.ones((2, 5, 7)), vmem_budget=0, block_h=2)
        assert _build.loaded() == (), _build.loaded()
        assert ychg_fused.LAUNCHES == {"ychg_fused_full": 0,
                                       "ychg_fused_splith": 0}
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_library_path_names_source_hash():
    """A change to the source or the flags gives another library name, so a
    stale build is never loaded."""
    path = _build.library_path("ychg_fused")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libychg_fused-") and path.suffix == ".so"
    assert path == _build.library_path("ychg_fused")


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """The sources include ``csrc/*.cuh``: editing a header in a copy of
    ``csrc/`` gives both libraries that include it another name."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in ("ychg_fused", "ychg_colscan")}
    header = csrc / "ychg_scan.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert _build.library_path(name) != path, name
        assert _build.library_path(name).name.startswith(f"lib{name}-")


# --------------------------------------- the scan kernels' decomposition
#
# A NumPy model of how ``csrc/ychg_scan.cuh`` splits the work of
# ``ychg_fused_full``, ``ychg_fused_splith`` and ``ychg_colscan_full`` (the
# kernels themselves run only on the card): the vector width chosen from the
# base address and the row pitch, tiles of ``lanes`` vectors, ``threads /
# lanes`` row segments a tile (of the whole column, or for split-H of each
# ``block_h``-row range) each entered with the image row above it, uint8
# counts in byte lanes flushed every ``chunk`` rows into 16-bit lanes that
# are flushed every ``pair_chunks`` chunks, and step 2 from the tile's own
# counts and its halo column (full-column) or from the summed counts
# (split-H). It runs at the constants the header declares and at small ones.

SCAN_HEADER = Path(kf.__file__).resolve().parent / "csrc" / "ychg_scan.cuh"
SCAN = {k: int(v) for k, v in re.findall(
    r"constexpr int (k\w+) = (\d+);", SCAN_HEADER.read_text())}
H100_SMS = 132


def model_vec_bytes(addr, w, itemsize):
    """The widest vector (16 down to the item size) dividing both the base
    address and the row pitch, as ``vec_bytes`` picks it."""
    a = addr | (w * itemsize)
    v = SCAN["kMaxVecBytes"]
    while v > itemsize and a % v:
        v >>= 1
    return v


def model_choose_lanes(b, nvec, sms):
    """``choose_lanes``: the widest tile whose blocks reach half of the
    SMs, else the narrowest."""
    lanes = SCAN["kMaxLanes"]
    while lanes > SCAN["kMinLanes"] and b * -(-nvec // lanes) < sms // 2:
        lanes >>= 1
    return lanes


def _segment_counts(rising, itemsize, chunk, pair_chunks):
    """Per-column counts of one segment's (rows, W) rising edges as the
    kernel keeps them: uint8 in byte lanes (wrapping at 256) a chunk, then
    16-bit lanes (wrapping at 65536) spilled to int every pair_chunks
    chunks; 32-bit types count in 32 bits."""
    rows, w = rising.shape
    if itemsize != 1:
        return rising.sum(0, dtype=np.int64)
    total = np.zeros(w, np.int64)
    pair = np.zeros(w, np.uint16)
    for k, r in enumerate(range(0, rows, chunk)):
        acc = rising[r:r + chunk].sum(0).astype(np.uint8)
        pair = (pair + acc).astype(np.uint16)
        if (k + 1) % pair_chunks == 0 and r + chunk < rows:
            total += pair
            pair[:] = 0
    return total + pair


def model_full(imgs, *, addr=0, fused=True, block_h=None, sms=H100_SMS,
               lanes=None, threads=None, chunk=None, pair_chunks=None):
    """The kernel's decomposition of a (B, H, W) stack: a dict of the
    ``ychg_fused_full`` fields, of the ``ychg_fused_splith`` fields when
    ``block_h`` is given, or ``{"runs"}`` for ``ychg_colscan_full`` (B = 1,
    no halo). ``addr`` is the base address modulo 16."""
    threads = threads or SCAN["kScanThreads"]
    chunk = chunk or SCAN["kChunk"]
    pair_chunks = pair_chunks or SCAN["kPairChunks"]
    x = kf.foreground(torch.from_numpy(imgs)).numpy()
    b, h, w = x.shape
    itemsize = 1 if imgs.dtype in (np.uint8, np.bool_) else 4
    vec = model_vec_bytes(addr, w, itemsize)
    cols = vec // itemsize                 # columns of one vector
    nvec = w * itemsize // vec
    # row ranges: grid z of split-H, else the whole column
    ranges = ([(0, h)] if block_h is None else
              [(r, min(block_h, h - r)) for r in range(0, h, block_h)])
    # split-H counts each (image, range) pair as an image
    lanes = lanes or model_choose_lanes(b * len(ranges), nvec, sms)
    segs = threads // lanes
    tile_w = lanes * cols                  # columns of one block
    halo_tiles = block_h is None and fused
    c0s = np.arange(tile_w, w, tile_w) if halo_tiles else np.arange(0)
    runs = np.zeros((b, w), np.int64)
    halo = np.zeros((b, len(c0s)), np.int64)
    for i in range(b):
        for row0, nrows in ranges:
            seg = -(-nrows // segs)
            for s in range(segs):
                r0 = row0 + s * seg        # the segment's first image row
                rows = min(seg, row0 + nrows - r0)
                if rows <= 0:
                    break
                blk = x[i, r0:r0 + rows]
                above = x[i, r0 - 1:r0] if r0 else np.zeros((1, w), bool)
                rising = blk & ~np.concatenate([above, blk[:-1]])
                runs[i] += _segment_counts(rising, itemsize, chunk,
                                           pair_chunks)
                # the halo column, counted by the tile's first lane as it goes
                halo[i] += rising[:, c0s - 1].sum(0)
    if not fused:
        return {"runs": runs[0].astype(np.int32)}
    left = np.concatenate([np.zeros((b, 1), np.int64), runs[:, :-1]], 1)
    left[:, c0s] = halo                    # the tile's own count, not runs
    delta = runs - left
    births = np.maximum(delta, 0)
    return {"runs": runs.astype(np.int32), "transitions": delta != 0,
            "births": births.astype(np.int32),
            "deaths": np.maximum(-delta, 0).astype(np.int32),
            "n_hyperedges": births.sum(1).astype(np.int32),
            "n_transitions": (delta != 0).sum(1).astype(np.int32)}


def test_scan_header_declares_the_model_constants():
    assert SCAN["kScanThreads"] == 1024 and SCAN["kMaxVecBytes"] == 16
    assert SCAN["kMinLanes"] <= SCAN["kMaxLanes"] <= 32
    assert SCAN["kChunk"] <= 255 and SCAN["kChunk"] % SCAN["kUnroll"] == 0
    assert SCAN["kChunk"] * SCAN["kPairChunks"] < 1 << 16


@pytest.mark.parametrize("addr,w,itemsize,want", [
    (0, 8192, 1, 16), (0, 21000, 1, 8), (0, 516, 1, 4), (0, 514, 1, 2),
    (0, 513, 1, 1), (1, 512, 1, 1), (4, 512, 1, 4), (8, 512, 1, 8),
    (0, 128, 4, 16), (0, 130, 4, 8), (0, 129, 4, 4), (4, 128, 4, 4),
    (8, 128, 4, 8)])
def test_model_vector_width(addr, w, itemsize, want):
    assert model_vec_bytes(addr, w, itemsize) == want


@pytest.mark.parametrize("b,w,vec,want", [
    (8, 8192, 16, 32), (1, 8192, 16, 4), (1, 21000, 8, 32), (2, 8192, 16, 8),
    (1, 1, 1, 4)])
def test_model_lanes_at_the_main_shapes(b, w, vec, want):
    """The lanes csrc/ychg_scan.cuh's header names for the serving batch,
    the lone mask and the scene, on 132 SMs."""
    assert model_choose_lanes(b, w // vec, H100_SMS) == want


DECOMP_WIDTHS = [1, 5, 15, 16, 17, 24, 511, 512, 513]


@pytest.mark.parametrize("addr", [0, 1, 4, 8])
@pytest.mark.parametrize("w", DECOMP_WIDTHS)
def test_model_fused_matches_plain(w, addr):
    """Declared constants; heights that no segment count divides, H = 0 and
    1; base addresses 1, 4 and 8 bytes off a 16-byte boundary."""
    for h in (0, 1, 37, 300):
        imgs = _stack((2, h, w), w + h + addr)
        want = kf.ychg_fused_full_plain(torch.from_numpy(imgs))
        for sms in (H100_SMS, 3):
            assert_dicts_same({k: torch.from_numpy(np.asarray(v)) for k, v in
                               model_full(imgs, addr=addr, sms=sms).items()},
                              {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.bool_])
@pytest.mark.parametrize("addr", [0, 4, 8])
def test_model_fused_dtypes(dtype, addr):
    imgs = _stack((2, 41, 130), addr, dtype=dtype)
    if dtype == np.float32:
        imgs[0, ::3] *= np.float32(1e-39)  # subnormals: background
    want = kf.ychg_fused_full_plain(torch.from_numpy(imgs))
    assert_dicts_same({k: torch.from_numpy(np.asarray(v)) for k, v in
                       model_full(imgs, addr=addr).items()},
                      {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("lanes,threads,chunk,pair_chunks", [
    (4, 8, 3, 2), (2, 8, 5, 3), (1, 3, 2, 1), (8, 16, 4, 2)])
def test_model_fused_small_tiles_and_flushes(lanes, threads, chunk,
                                             pair_chunks):
    """Small tiles, segment counts and flush periods, so that every flush
    and every halo runs at a small size."""
    for w, addr in [(17, 0), (40, 8), (33, 1)]:
        imgs = _stack((2, 50, w), w * lanes, p=0.6)
        imgs[1, ::2, :5] = 1
        imgs[1, 1::2, :5] = 0
        want = kf.ychg_fused_full_plain(torch.from_numpy(imgs))
        got = model_full(imgs, addr=addr, lanes=lanes, threads=threads,
                         chunk=chunk, pair_chunks=pair_chunks)
        assert_dicts_same({k: torch.from_numpy(np.asarray(v))
                           for k, v in got.items()},
                          {k: v.numpy() for k, v in want.items()})


def test_model_byte_lanes_need_their_flush():
    """A column of alternating rows has a run every other row: past 510
    rows without a flush its byte lane wraps, and the model (like the
    kernel) would count wrong. At the declared chunk it does not."""
    imgs = np.zeros((1, 1100, 16), np.uint8)
    imgs[0, ::2] = 1
    want = kf.ychg_fused_full_plain(torch.from_numpy(imgs))["runs"].numpy()
    ok = model_full(imgs, lanes=4, threads=4)["runs"]
    np.testing.assert_array_equal(ok, want)
    wrapped = model_full(imgs, lanes=4, threads=4, chunk=1024)["runs"]
    assert not np.array_equal(wrapped, want)


# ----------------------------------------------- the split-H decomposition

SPLITH_BLOCK_H = [1, 3, 252, 253, 1 << 20]


def _as_dicts(got, want):
    return ({k: torch.from_numpy(np.asarray(v)) for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("b,h,w,vec,block_h,want", [
    (1, 21000, 21000, 8, 2048, 32), (8, 8192, 8192, 16, 2048, 32),
    (1, 40960, 8192, 16, 2048, 32), (1, 8192, 8192, 16, 2048, 16),
    (1, 8192, 8192, 16, 1 << 20, 4)])
def test_model_splith_lanes_at_the_main_shapes(b, h, w, vec, block_h, want):
    """The lanes csrc/ychg_scan.cuh's header names for split-H on 132 SMs:
    each (image, range) pair counts as an image, so the scene's 11 ranges
    and the serving batch's 32 pairs take 32 lanes."""
    assert model_choose_lanes(b * -(-h // block_h), w // vec, H100_SMS) == want


@pytest.mark.parametrize("addr", [0, 1, 4, 8])
@pytest.mark.parametrize("block_h", SPLITH_BLOCK_H)
def test_model_splith_matches_plain(block_h, addr):
    """Declared constants: H not a multiple of block_h, fewer rows in a
    range than the block has segments (every range here), one range at
    least H tall, H = 0 and 1, bases 1, 4 and 8 bytes off 16."""
    for h, w in ((0, 17), (1, 24), (37, 130), (600, 33)):
        imgs = _stack((2, h, w), h + w + addr)
        want = kf.ychg_fused_splith_plain(torch.from_numpy(imgs), block_h)
        for sms in (H100_SMS, 3):
            assert_dicts_same(*_as_dicts(
                model_full(imgs, addr=addr, block_h=block_h, sms=sms),
                {k: v.numpy() for k, v in want.items()}))


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int32, np.float32])
@pytest.mark.parametrize("block_h", SPLITH_BLOCK_H)
def test_model_splith_matches_streamed_interpret(dtype, block_h):
    """The model at the declared constants against the JAX streamed kernel
    in interpret mode and the plain version, four dtypes, float32 with
    subnormals (background)."""
    h = 37 if block_h < 8 else 600
    imgs = _stack((2, h, 130), block_h + h, dtype=dtype)
    if dtype == np.float32:
        imgs[0, ::3] *= np.float32(1e-39)
    got = model_full(imgs, block_h=block_h)
    assert_dicts_same(*_as_dicts(got, fused_analyze_streamed(
        jnp.asarray(imgs), block_h=min(block_h, 1024), interpret=True)))
    assert_dicts_same(*_as_dicts(got, {
        k: v.numpy() for k, v in kf.ychg_fused_splith_plain(
            torch.from_numpy(imgs), block_h).items()}))


@pytest.mark.parametrize("block_h", [1, 3, 5, 50])
@pytest.mark.parametrize("lanes,threads,chunk,pair_chunks", [
    (4, 8, 3, 2), (2, 8, 5, 3), (1, 3, 2, 1), (8, 16, 4, 2)])
def test_model_splith_small_tiles_and_flushes(lanes, threads, chunk,
                                              pair_chunks, block_h):
    """Small tiles, segment counts and flush periods, so that a range cut
    into segments, the flushes within a segment and the seams between
    ranges all run at a small size; against the JAX streamed kernel."""
    imgs = _stack((2, 50, 40), lanes * threads + block_h, p=0.6)
    imgs[1, ::2, :5] = 1
    imgs[1, 1::2, :5] = 0
    got = model_full(imgs, addr=8, block_h=block_h, lanes=lanes,
                     threads=threads, chunk=chunk, pair_chunks=pair_chunks)
    assert_dicts_same(*_as_dicts(got, fused_analyze_streamed(
        jnp.asarray(imgs), block_h=block_h, interpret=True)))


def test_model_splith_enters_each_range_from_the_image_row_above():
    """Entering a range's first segment with nothing above it (the in-range
    offset tested instead of the image row) counts a run that crosses the
    seam twice; the model, like the kernel, does not."""
    imgs = np.ones((1, 20, 16), np.uint8)
    want = kf.ychg_fused_splith_plain(torch.from_numpy(imgs), 7)
    got = model_full(imgs, block_h=7, lanes=4, threads=8)
    assert_dicts_same(*_as_dicts(got, {k: v.numpy() for k, v in want.items()}))
    assert (got["runs"] == 1).all()
