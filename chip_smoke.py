#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit (nvcc), and imports nothing of JAX or of the JAX package. Phases,
each of which fails the run (non-zero exit, no result line) when it fails:

  1. the card: name and power limit as nvidia-smi reports them;
  2. the build: every CUDA source of the path (ychg_fused, ychg_colscan,
     denoise, ccl, ychg_packed), one nvcc each, in parallel;
  3. every kernel against its plain PyTorch version on the card, exactly
     (every field, dtype included), except denoise on float inputs, which
     is held to 1 ulp in at most 1 in 10^4 outputs (the differing count is
     printed): ragged widths, H = 1, W = 1, constant, checkerboard and
     serpentine masks, B = 1 and 8, uint8/bool/int32/float32 and the cast
     path, -0.0, NaN and inf, float32 subnormals of both signs (bit for
     bit for all seven kernels, denoise included), the tile and strip
     boundaries of ccl (32 x 128 tiles) and denoise (4-column vectors,
     512-column strips of 32 rows) one pixel either side, views whose
     base is misaligned for vector loads, for the full-column ychg
     kernels every vector width (W * itemsize 0, 8, 4, 2 and 1 mod 16),
     bases 1 to 8 bytes off 16, H from 0 past their segment count and
     columns of alternating rows past their byte and 16-bit lanes'
     flushes, 64-bit integer masks through ``Engine()`` against their low
     32 bits (ychg, ccl, denoise), and for ccl alone the
     one-pixel-wide serpentine, all foreground and a checkerboard at
     1 x 8192^2; split-H with H not a multiple of block_h, the serving
     batches (the two-kernel path one mask at a time) and the paper's
     largest scene (21000^2, 4,124,319 hyperedges) through the fused and
     the two step-1 kernels; then each kernel is timed at its main
     shapes, the lone 1 x 8192^2 mask the service flushes among them
     (CUDA events, median of 15 samples of 5 back-to-back calls, after a
     warm-up), beside its plain version, its bound and, for ccl, the
     canonical re-ranking alone and its three passes apart (local, seams,
     final), the C entry points alone of ychg_fused_full and
     ychg_colscan_full on the lone mask, and ychg_fused_full beside
     ychg_fused_splith on the serving batch, the scene and the tall strip
     (1 x 40960 x 8192 uint8: five serving masks stacked along the track,
     which the engine's rule sends to split-H), and the two step-1 kernels
     on the tall strip. ychg_fused_splith is also held at block_h 1, 3,
     252, 253 and above H, with H not a multiple of block_h, ranges
     shorter than the block's segment count, bases 0, 1, 4 and 8 bytes off
     16, four dtypes and float32 subnormals, one range whose segments pass
     a byte lane's and one whose segments pass a 16-bit lane's flush, and
     on the tall strip. The two-kernel path's batch entry
     (``ychg_colscan_analyze``: a step-1 launch on either route and
     ychg_diff's second instantiation, which also writes the cut vertices
     and the totals, a mask, in one host call) is held to its plain
     version and to ``core.ychg.analyze`` on both routes on every
     kernel_cases and split-H case, the serving batch, the scene and the
     tall strip; it is timed through ``kops.analyze_batch`` and as its C
     call alone on the serving batch, its step 2 as a programmatic
     dependent launch (what it runs) against plain stream order (the C
     twin ``ychg_colscan_analyze_stream_order``, a diagnostic), and that
     step-2 kernel alone, on the device, from a torch.profiler trace: the
     ychg_diff row of the kernels line, since the main path runs ychg_diff
     in this form. The standalone ychg_diff (``ops.transitions``), off the
     main path, is timed through its wrapper (median and quartiles of 101
     samples) and as its C entry point. The two packed
     kernels are held to their plain versions on the packed form of H = 1
     to 9, W = 1 and ragged masks, all-one columns, checkerboards,
     serpentines, four dtypes, float32 subnormals, the 4096^2 snowfield of
     ``benchmarks/run.py::bench_kernel_packed`` and the scene, and the
     fused one also to ``core.ychg.analyze`` on the unpacked mask; and on
     masks built packed: every vector width of a packed row, bases 1 to 8
     bytes off 16, Hp = 0 and 1, W = 1, W at and past a tile edge, and
     0x55 columns whose segments pass a byte lane's and a 16-bit lane's
     flush. They are timed on the packed scene and the packed 1 x 8192^2
     mask through their wrappers, on the device (a torch.profiler trace)
     and as their C entry points, and ``pack_rows`` (torch ops) alone and
     as a share of ``packed_analyze`` on the scene;
  4. the main path, with every launch counter set to 0 just before it:
     ``Engine().analyze_batch`` on 8 x 8192^2 uint8 masks for ychg (must
     resolve to ``fused``), ccl and denoise (must resolve to ``cuda``),
     ``Engine(EngineConfig(backend="cuda"))`` for ychg (the paper's two
     kernels, two launches a mask from one host call), and denoise on float32 copies with 1%
     impulse pixels, each equal to ``backend="torch"``;
     ``Engine().run_pipeline(["denoise", "ychg"])`` equal to the two
     stages run one after the other; the service's cold, warm and cached
     passes of 8 masks each for ychg (``fused`` and ``cuda``), ccl and
     denoise, and one pass of 8 float32 masks through ``submit_pipeline``
     (every served result equal to the plain reference on its raw mask;
     the cached pass dispatches nothing; the device batches and stage
     seconds of each are printed); the overload burst; the 21000^2 scene
     through the full-column and split-H routes of both ychg kernel
     backends and of the batch entry, as op ``ccl`` (4,124,319 components) and through
     ``packed_analyze`` and ``packed_colscan``, each equal to
     ``Engine().analyze``; the scene tier: the scene written to a ``.npy``
     and run as a memmap granule by ``BulkJob`` (2048-row strips in stacks
     of 4) and by ``SceneRunner.analyze_scene``, both bit-identical to one
     whole-scene ``Engine().analyze`` call (rate, stitch seconds and
     device batches printed), and a two-granule synthetic 2048 x 8192 job
     killed at stack 3, its newest checkpoint truncated, and resumed with
     a warning to byte-identical ``.ychg`` files; then the HTTP
     front end over loopback on the ``cuda`` engine: 8 x 2048^2 masks
     through ``/v1/analyze_batch``, one 4096^2 mask through ``/v1/ychg``,
     ``/v1/ccl``, ``/v1/denoise`` and ``/v1/pipeline`` at 2048^2 (the
     largest masks its 64 MiB body limit carries), every response equal
     to the plain reference, ``/metrics`` parsed, and a 429 with
     Retry-After at a full queue. Every kernel must have launched in this
     phase;
  5. the paper's comparison, for information: its serial NumPy baseline
     on the host against the ``cuda`` and ``fused`` backends on the card,
     at each resolution of the workload up to 12000^2 and the 21000^2
     scene, all three equal.

It prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, the float32 rate outside the
# tensor cores (an FMA counts as two operations), and the simple int32 rate:
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_PIXEL = 3          # ychg: compare, and-not, add
# packed ychg: shift, a three-input logic op (b & ~(s | carry)), popcount,
# add, and the shift that takes the next byte's carry
PACKED_OPS_PER_BYTE = 5
PACK_OPS_PER_PIXEL = 3     # pack_rows: compare, shift, add
DIFF_OPS_PER_COLUMN = 5    # ychg_diff: subtract, compare, two max, negate
# ychg_diff's batch-entry instantiation: the same, the doubled cut vertex
# and the two sums of the totals
FINISH_OPS_PER_COLUMN = DIFF_OPS_PER_COLUMN + 3
# denoise: 8 + 7 adds, 8 squares, 1 FMA (2), 2 multiplies by 1/9, sqrt,
# subtract, abs, multiply by TAU, compare
DENOISE_FLOPS_PER_PIXEL = 32
# ccl: foreground test and store (init); two neighbour tests, index
# arithmetic and at least one find of two loads per link (merge); one find
# and store (flatten)
CCL_OPS_PER_PIXEL = 12

SERVE_RES, SERVE_BATCH = 8192, 8
SCENE_RES, SCENE_HYPEREDGES = 21000, 4_124_319
SCENE_BLOCK_H = 2048       # EngineConfig.block_h default
TALL_MASKS = 5             # the tall strip: serving masks stacked along H
PACKED_SNOW_RES = 4096     # benchmarks/run.py::bench_kernel_packed's mask
BULK_TILE_H, BULK_STACK = 2048, 4   # the scene leg's strips and stacks
# the kill-and-resume job: two synthetic granules of (H, W), in strips
RESUME_H, RESUME_W, RESUME_TILE_H = 2048, 8192, 256
DEV = "cuda"

CSRC = "src/repro_torch/kernels/csrc/"
# kernel -> (CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "ychg_fused_full": (CSRC + "ychg_fused.cu",
                        "src/repro/kernels/ychg_fused.py:91"),
    "ychg_fused_splith": (CSRC + "ychg_fused.cu",
                          "src/repro/kernels/ychg_fused.py:168"),
    "ychg_colscan_full": (CSRC + "ychg_colscan.cu",
                          "src/repro/kernels/ychg_colscan.py:42"),
    "ychg_colscan_splith": (CSRC + "ychg_colscan.cu",
                            "src/repro/kernels/ychg_colscan.py:51"),
    "ychg_diff": (CSRC + "ychg_colscan.cu",
                  "src/repro/kernels/ychg_colscan.py:68"),
    "denoise": (CSRC + "denoise.cu", "src/repro/kernels/denoise.py:77"),
    "ccl": (CSRC + "ccl.cu", "src/repro/kernels/ccl.py:127"),
    "ychg_packed_colscan": (CSRC + "ychg_packed.cu",
                            "src/repro/kernels/ychg_packed.py:46"),
    "ychg_packed_fused": (CSRC + "ychg_packed.cu",
                          "src/repro/kernels/ychg_packed.py:78"),
}
YCHG_NOTE = ("no single PyTorch call computes per-column run counts with "
             "their neighbour diff and per-image totals")
COLSCAN_NOTE = "no single PyTorch call counts maximal runs per column"
LIBRARY_NOTES = {
    "ychg_fused_full": YCHG_NOTE,
    "ychg_fused_splith": YCHG_NOTE,
    "ychg_colscan_full": COLSCAN_NOTE,
    "ychg_colscan_splith": COLSCAN_NOTE,
    "ychg_diff": ("torch.diff gives the delta alone; no single PyTorch call "
                  "gives transitions, births and deaths"),
    "denoise": ("no single PyTorch call computes the filter: a 3x3 "
                "convolution gives the two window sums, not the outlier "
                "test and the select"),
    "ccl": "no PyTorch call computes connected-component labels",
    "ychg_packed_colscan": ("PyTorch has no popcount, and no single call "
                            "counts runs per column"),
    "ychg_packed_fused": ("PyTorch has no popcount, and no single call "
                          "counts runs per column"),
}
IMPULSE_SHARE = 0.01       # impulse pixels in the float32 denoise inputs
# float32 values around the reference's subnormal flush: +-0, subnormals of
# both signs, NaN, +-inf and normal values far from the smallest normal
SUBNORMAL_VALUES = (0.0, -0.0, 1e-39, -1e-39, 5e-41, -5e-41, 1.5, -2.0,
                    float("nan"), float("inf"), float("-inf"), 0.25)
FRONTEND_RES, FRONTEND_BIG_RES = 2048, 4096
PAPER_MAX_RES = 12000      # the paper's comparison: resolutions up to this


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptx_float_ops(source: str) -> dict:
    """Counts of the float32 arithmetic instructions in the PTX that nvcc
    makes of ``csrc/<source>.cu`` with the library's flags, by form (for
    example ``add.rn.ftz.f32``)."""
    import collections
    import re

    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / f"{source}.ptx"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f in ("-std=c++17", "-O3",
                                                   "-ftz=true")]
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,"
                    "code=compute_90a", *flags, "-ptx", "-o", str(out),
                    str(_build.CSRC / f"{source}.cu")], check=True,
                   capture_output=True, timeout=300)
    return dict(collections.Counter(re.findall(
        r"\b((?:add|sub|mul|fma|sqrt)\.[a-z.]*f32)", out.read_text())))


def ptxas_summary(log: str) -> str:
    """One line of nvcc's ``-Xptxas -v`` report: the kernels, their range
    of registers a thread, and the spill bytes with the kernels that spill."""
    import re

    regs, spills = [], {}
    kernel = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and int(m.group(1)) + int(m.group(2)):
            spills[kernel] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
    if not regs:
        return "no report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers a "
            f"thread, spills {json.dumps(spills) if spills else 'none'}")


def scene_span_seconds() -> dict:
    """Seconds per span name summed over the scene traces in the flight
    recorder (``scene.read``, ``scene.compute``, ``scene.stitch``, ...)."""
    from repro_torch import obs

    out: dict = {}
    for tr in obs.recorder().traces():
        if tr.process == "scene":
            for name, t0, t1, _ in tr.spans():
                out[name] = out.get(name, 0.0) + t1 - t0
    return out


def max_abs_err(got: dict, want: dict, label: str) -> int:
    """Exact comparison of two kernel output dicts; returns the largest
    absolute difference (0) or raises naming the first field that differs."""
    import torch

    check(set(got) == set(want), f"{label}: fields {sorted(got)} != "
                                 f"{sorted(want)}")
    worst = 0
    for k in sorted(want):
        g, w = got[k], want[k]
        check(g.dtype == w.dtype, f"{label}: {k} dtype {g.dtype} != {w.dtype}")
        check(g.shape == w.shape, f"{label}: {k} shape {tuple(g.shape)} != "
                                  f"{tuple(w.shape)}")
        if g.numel():
            diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
            worst = max(worst, int(diff))
    check(worst == 0, f"{label}: kernel differs from its plain version "
                      f"(max abs err {worst})")
    return worst


def time_samples(fn, samples: int = 15, reps: int = 5) -> list:
    """``samples`` CUDA-event times (ms) of ``reps`` calls / reps, after a
    warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def time_ms(fn, samples: int = 15, reps: int = 5) -> float:
    """Median over ``samples`` of the CUDA-event time of ``reps`` calls / reps."""
    return statistics.median(time_samples(fn, samples, reps))


def kernel_device_ms(fn, names: tuple, calls: int = 20) -> tuple[float, int]:
    """Mean device time (ms) of one launch of the CUDA kernel whose name
    holds any of ``names`` (demangled or mangled), read from a
    torch.profiler trace of ``calls`` calls of ``fn``; and the launches the
    trace saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            total_us += getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
            launches += e.count
    check(launches > 0 and total_us > 0,
          f"torch.profiler saw no device time of {names[0]}")
    return total_us / launches / 1e3, launches


def _bound(nbytes: float, t_ops: float) -> tuple[float, str, int]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", int(nbytes))


def bound(x) -> tuple[float, str, int]:
    """Least time (ms) the yCHG kernels need for one call on ``x`` (B, H,
    W): each input byte read once, each output byte written once, against
    the integer work per pixel; and the byte count."""
    b, _, w = x.shape
    nbytes = x.numel() * x.element_size() + b * w * (3 * 4 + 1) + b * 2 * 4
    return _bound(nbytes, OPS_PER_PIXEL * x.numel() / PEAK_INT32_OPS_PER_S)


def bound_colscan(x) -> tuple[float, str, int]:
    """The same for step 1 on one (H, W) mask: the mask read once, 4 B a
    column of int32 runs written."""
    nbytes = x.numel() * x.element_size() + x.shape[-1] * 4
    return _bound(nbytes, OPS_PER_PIXEL * x.numel() / PEAK_INT32_OPS_PER_S)


def bound_diff(runs) -> tuple[float, str, int]:
    """The same for step 2: (W,) int32 runs read once, a bool and two
    int32 a column written."""
    w = runs.shape[0]
    return _bound(w * 4 + w * (1 + 4 + 4),
                  DIFF_OPS_PER_COLUMN * w / PEAK_INT32_OPS_PER_S)


def bound_finish(runs) -> tuple[float, str, int]:
    """The same for the batch entry's step-2 kernel on one mask's (W,)
    runs: the runs read once; the cut vertices, births and deaths (int32),
    the transitions (bool) and the two int32 totals written once."""
    w = runs.shape[-1]
    return _bound(w * 4 + w * (4 + 1 + 4 + 4) + 2 * 4,
                  FINISH_OPS_PER_COLUMN * w / PEAK_INT32_OPS_PER_S)


def bound_denoise(x) -> tuple[float, str, int]:
    """The same for denoise: input read once, 4 B/px of float32 written,
    against its float32 work per pixel."""
    nbytes = x.numel() * (x.element_size() + 4)
    return _bound(nbytes,
                  DENOISE_FLOPS_PER_PIXEL * x.numel() / PEAK_FP32_OPS_PER_S)


def bound_ccl(x) -> tuple[float, str, int]:
    """The same for ccl: input read once, 4 B/px of int32 labels written,
    against its integer work per pixel."""
    nbytes = x.numel() * (x.element_size() + 4)
    return _bound(nbytes, CCL_OPS_PER_PIXEL * x.numel() / PEAK_INT32_OPS_PER_S)


def bound_packed_colscan(p) -> tuple[float, str, int]:
    """The same for the packed scan on one (ceil(H/8), W) uint8 mask: each
    packed byte read once, 4 B a column of int32 runs written."""
    nbytes = p.numel() + p.shape[-1] * 4
    return _bound(nbytes, PACKED_OPS_PER_BYTE * p.numel() / PEAK_INT32_OPS_PER_S)


def bound_packed_fused(p) -> tuple[float, str, int]:
    """The same for the packed fused kernel: runs, cut vertices, births and
    deaths (int32) and transitions (bool) a column, two int32 totals."""
    nbytes = p.numel() + p.shape[-1] * (4 * 4 + 1) + 2 * 4
    return _bound(nbytes, PACKED_OPS_PER_BYTE * p.numel() / PEAK_INT32_OPS_PER_S)


def bound_pack_rows(x) -> tuple[float, str, int]:
    """The same for ``pack_rows``: the (H, W) mask read once, its
    (ceil(H/8), W) uint8 packing written once."""
    h, w = x.shape
    nbytes = x.numel() * x.element_size() + -(-h // 8) * w
    return _bound(nbytes, PACK_OPS_PER_PIXEL * x.numel() / PEAK_INT32_OPS_PER_S)


def float_err(got, want, label: str) -> tuple[float, int]:
    """Denoise's float tolerance: every output within 1 ulp of the plain
    version, at most 1 in 10^4 outputs differing (NaN equal to NaN).
    Returns (largest absolute difference, number of differing outputs)."""
    import torch

    check(got.dtype == want.dtype == torch.float32,
          f"{label}: dtype {got.dtype} != {want.dtype}")
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want))
    diff = ~same
    n = int(diff.sum())
    if n == 0:
        return 0.0, 0
    g, w = got[diff].double(), want[diff].double()
    ulp = (torch.nextafter(want[diff].abs(), torch.tensor(
        float("inf"), device=want.device)) - want[diff].abs()).double()
    err = (g - w).abs()
    check(bool(torch.all(err <= ulp)), f"{label}: kernel more than 1 ulp "
                                       f"from its plain version")
    check(n <= got.numel() // 10_000, f"{label}: {n} of {got.numel()} "
                                      f"outputs differ")
    return float(err.max()), n


def float_exact(got, want, label: str) -> int:
    """float32 outputs bit for bit (NaN equal to NaN); returns 0."""
    import torch

    check(got.dtype == want.dtype == torch.float32,
          f"{label}: dtype {got.dtype} != {want.dtype}")
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want))
    n = int((~same).sum())
    check(n == 0, f"{label}: {n} outputs differ from the plain version")
    return 0


def subnormal_values(np, rng, shape):
    """float32 array of ``shape`` drawn from SUBNORMAL_VALUES."""
    vals = np.array(SUBNORMAL_VALUES, np.float32)
    return vals[rng.integers(0, len(vals), shape)]


def impulse_copies(np, masks, seed: int = 20130611):
    """float32 copies of uint8 masks with IMPULSE_SHARE of the pixels set
    to random values in [0, 4): the impulse noise the filter removes."""
    rng = np.random.default_rng(seed)
    out = []
    for m in masks:
        f = m.astype(np.float32)
        flat = f.reshape(-1)
        k = int(IMPULSE_SHARE * flat.size)
        flat[rng.integers(0, flat.size, k)] = (
            4 * rng.random(k)).astype(np.float32)
        out.append(f)
    return out


def serpentine(np, h: int, w: int):
    """One component snaking through every other row: the longest chain a
    (h, w) mask can hold for its area."""
    m = np.zeros((h, w), np.uint8)
    m[::2] = 1
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = 1
    return m


def image_cases(np, torch):
    """(label, cuda stack, float input?) for the denoise and ccl exactness
    phase: ragged shapes, H = 1, W = 1, B = 1 and 8, the four in-place
    dtypes, two cast-path dtypes, float specials, and the masks that are
    hard for ccl (one component over all, every pixel its own, longest
    chains)."""
    rng = np.random.default_rng(20130612)
    dev = DEV

    def dtypes(label, a):
        t = torch.from_numpy(a).to(dev)
        yield f"{label} uint8", t, False
        yield f"{label} bool", t.bool(), False
        yield f"{label} int32", t.to(torch.int32), False
        yield f"{label} float32", t.to(torch.float32), True

    cases = []
    # ccl's tile is 32 x 128 (csrc/ccl.cu): one pixel either side of it
    # and of two tiles; a thread of denoise owns 4 columns, a warp 128, a
    # block 512 walking 32 rows (csrc/denoise.cu): widths 4 +- 1 and 512
    # +- 1, heights 32 +- 1
    for shape in [(1, 37, 300), (8, 37, 300), (2, 20, 255), (3, 1, 517),
                  (4, 200, 1), (1, 1, 1), (2, 33, 64), (2, 31, 127),
                  (2, 33, 129), (1, 32, 128), (2, 65, 257), (2, 63, 255),
                  (2, 31, 3), (2, 33, 5), (1, 32, 4), (1, 31, 511),
                  (1, 33, 513), (1, 40, 512), (2, 65, 1024)]:
        a = (rng.random(shape) < 0.5) * rng.integers(1, 256, shape)
        cases += dtypes(f"random {shape}", a.astype(np.uint8))
    # vector loads need an aligned base: views that start one element into
    # their storage, with odd H x W (big[1:]) and with W a multiple of 4
    for dtype in (torch.uint8, torch.int32, torch.float32):
        a = (rng.random((3, 37, 301)) < 0.5) * rng.integers(1, 256,
                                                           (3, 37, 301))
        big = torch.from_numpy(a.astype(np.uint8)).to(dev).to(dtype)
        flat = torch.from_numpy(rng.integers(0, 3, 2 * 40 * 256 + 1).astype(
            np.uint8)).to(dev).to(dtype)
        name = str(dtype).split(".")[-1]
        cases.append((f"misaligned base big[1:] (2, 37, 301) {name}",
                      big[1:], dtype == torch.float32))
        cases.append((f"misaligned base (2, 40, 256) {name}",
                      flat[1:].view(2, 40, 256), dtype == torch.float32))
    checker = (np.indices((64, 700)).sum(axis=0) % 2).astype(np.uint8)
    for label, a in [
            ("all-zero", np.zeros((2, 64, 700), np.uint8)),
            ("all-one", np.ones((2, 64, 700), np.uint8)),
            ("checkerboard", np.stack([checker, 1 - checker])),
            ("serpentine", np.stack([serpentine(np, 301, 257),
                                     serpentine(np, 257, 301).T])),
            ("serpentine 1 x 2001 x 1999",
             serpentine(np, 2001, 1999)[None])]:
        cases += dtypes(label, a)
    vals = np.array([0.0, -0.0, 1.5, -2.0, np.nan, np.inf, -np.inf, 3e38,
                     0.25], np.float32)
    f = vals[rng.integers(0, len(vals), (2, 33, 260))]
    cases.append(("float32 with -0.0, nan and inf",
                  torch.from_numpy(f).to(dev), True))
    levels = rng.integers(0, 4, (2, 33, 260)).astype(np.int16)
    cases.append(("int16 (cast path)", torch.from_numpy(levels).to(dev),
                  False))
    cases.append(("float16 (cast path)",
                  torch.from_numpy(levels.astype(np.float16)).to(dev), True))
    return cases


def ccl_big_cases(np, torch):
    """(label, cuda stack) at the serving width for ccl alone: the
    one-pixel-wide serpentine (the longest seam chains: one component
    through every tile row), all foreground (one root, every seam on it)
    and a checkerboard (nothing links; every pixel its own root)."""
    n = SERVE_RES
    i = np.arange(n, dtype=np.uint8)
    return [(f"serpentine 1 x {n}^2", serpentine(np, n, n)[None]),
            (f"all-foreground 1 x {n}^2", np.ones((1, n, n), np.uint8)),
            (f"checkerboard 1 x {n}^2", ((i[:, None] ^ i) & 1)[None])]


def subnormal_image_cases(np, torch):
    """(label, cuda float32 stack) with subnormal pixels for denoise and
    ccl, held bit for bit: mixed values, and windows of subnormals and
    zeros only, where the flush alone decides each output."""
    rng = np.random.default_rng(20130613)
    tiny = np.where(rng.random((2, 40, 300)) < 0.5, np.float32(1e-39),
                    np.float32(-5e-41))
    tiny[:, ::7] = 0.0
    return [("float32 with subnormals",
             torch.from_numpy(subnormal_values(np, rng, (2, 33, 260))).to(DEV)),
            ("float32 subnormals and zeros only",
             torch.from_numpy(tiny).to(DEV))]


def kernel_cases(np, torch, modis):
    """(label, cuda stack, split-H block_h) for the exactness phase."""
    rng = np.random.default_rng(20130610)
    dev = DEV

    def rand(shape, p=0.5):
        return (rng.random(shape) < p).astype(np.uint8)

    def dtypes(label, a):
        t = torch.from_numpy(a).to(dev)
        yield f"{label} uint8", t
        yield f"{label} bool", t.bool()
        yield f"{label} int32", t.to(torch.int32)
        yield f"{label} float32", t.to(torch.float32)

    cases = []
    for shape in [(1, 37, 300), (8, 37, 300), (2, 20, 255), (2, 20, 256),
                  (2, 20, 511), (3, 1, 517), (4, 200, 1), (1, 1, 1)]:
        for label, t in dtypes(f"random {shape}", rand(shape)):
            cases.append((label, t, 16))
    checker = (np.indices((64, 700)).sum(axis=0) % 2).astype(np.uint8)
    for label, a in [("all-zero", np.zeros((2, 64, 700), np.uint8)),
                     ("all-one", np.ones((2, 64, 700), np.uint8)),
                     ("checkerboard", np.stack([checker, 1 - checker]))]:
        for lab, t in dtypes(label, a):
            cases.append((lab, t, 16))
    vals = np.array([0.0, -0.0, 1.5, -2.0, np.nan, 0.0], np.float32)
    f = vals[rng.integers(0, len(vals), (2, 33, 260))]
    cases.append(("float32 with -0.0 and nan", torch.from_numpy(f).to(dev), 8))
    levels = rng.integers(0, 4, (2, 33, 260)).astype(np.int16)
    cases.append(("int16 (cast path)", torch.from_numpy(levels).to(dev), 8))
    cases.append(("float16 (cast path)",
                  torch.from_numpy(levels.astype(np.float16)).to(dev), 8))
    cases.append(("float32 with subnormals", torch.from_numpy(
        subnormal_values(np, rng, (2, 33, 260))).to(dev), 8))
    for block_h in (7, 64):
        cases.append((f"split-H ragged H, block_h={block_h}",
                      torch.from_numpy(rand((3, 1000, 513), 0.6)).to(dev),
                      block_h))
    return cases


# the full-column scan (csrc/ychg_scan.cuh): 1024 threads a block, at
# least 4 lanes, so 256 row segments for one narrow image; segments past a
# byte lane's flush (252 rows, 126 runs: 547 rows would wrap one) and past
# a 16-bit lane's (252 * 256 rows)
SCAN_MAX_SEGMENTS = 256
SCAN_LONG_SEGMENTS = (547, 252 * 256 + 256)


def scan_cases(np, torch):
    """(label, cuda stack) for the full-column kernels (``ychg_fused_full``
    and ``ychg_colscan_full``): every vector width the launch can pick
    (W * itemsize = 0, 8, 4, 2 and 1 mod 16 for uint8; 0, 8 and 4 for
    int32 and float32), contiguous views whose base is 1, 2, 4 or 8 bytes
    off a 16-byte boundary, H from 0 up past the segment count, float32
    subnormals at every width, and columns of alternating rows whose runs
    overflow a byte lane (8192 high, and segments of 547 rows) and a 16-bit
    lane (segments of 64,768 rows) were their flushes missing."""
    rng = np.random.default_rng(20130616)
    dev = DEV

    def rand(shape, p=0.5):
        return torch.from_numpy((rng.random(shape) < p).astype(
            np.uint8)).to(dev)

    cases = []
    for w in (512, 520, 516, 514, 513, 8200, 8197):
        x = rand((3, 67, w))
        cases.append((f"uint8 (3, 67, {w})", x))
        cases.append((f"bool (3, 67, {w})", x.bool()))
    for w in (256, 258, 257):
        x = rand((3, 67, w))
        cases.append((f"int32 (3, 67, {w})", x.to(torch.int32)))
        cases.append((f"float32 (3, 67, {w})", x.to(torch.float32)))
        cases.append((f"float32 subnormals (2, 65, {w})", torch.from_numpy(
            subnormal_values(np, rng, (2, 65, w))).to(dev)))
    for dtype, width in ((torch.uint8, 1), (torch.int32, 4),
                         (torch.float32, 4)):
        flat = rand(2 * 57 * 512 + 16).to(dtype)
        for off in (1, 2, 4, 8):
            if off % width:
                continue
            n = off // width
            name = str(dtype).split(".")[-1]
            cases.append((f"{name} base {off} B off 16 (2, 57, 512)",
                          flat[n:n + 2 * 57 * 512].view(2, 57, 512)))
    for h in (0, 1, 2, 5, 31, 33, SCAN_MAX_SEGMENTS - 1,
              SCAN_MAX_SEGMENTS + 1, 1000):
        cases.append((f"H = {h} (2, {h}, 700)", rand((2, h, 700))))
    alt = torch.zeros((8, SERVE_RES, 512), dtype=torch.uint8, device=dev)
    alt[:, ::2] = 1
    alt[:, ::5, 7] = 0
    cases.append((f"alternating rows (1, {SERVE_RES}, 512)", alt[:1]))
    cases.append((f"alternating rows (8, {SERVE_RES}, 512)", alt))
    for rows in SCAN_LONG_SEGMENTS:
        tall = torch.zeros((1, SCAN_MAX_SEGMENTS * rows, 16), dtype=torch.uint8,
                           device=dev)
        tall[:, ::2] = 1
        tall[:, ::7, 3] = 0
        cases.append((f"alternating rows, segments of {rows} "
                      f"{tuple(tall.shape)}", tall))
    return cases


def splith_cases(np, torch):
    """(label, cuda stack, block_h) for ``ychg_fused_splith`` at the
    constants of ``csrc/ychg_scan.cuh``: block_h 1, 3, 252, 253 and above H
    with H = 600 (a multiple of none of them), so every range is shorter
    than the block's 32 to 256 segments; uint8, bool, int32 and float32
    with subnormals; bases 0, 1, 4 and 8 bytes off a 16-byte boundary; the
    serving widths 8200 and 8197; and one range of 256 x 547 alternating
    rows whose 256 segments each pass a byte lane's flush."""
    rng = np.random.default_rng(20130618)
    dev = DEV

    def rand(shape, p=0.5):
        return torch.from_numpy((rng.random(shape) < p).astype(
            np.uint8)).to(dev)

    cases = []
    x = rand((2, 600, 700))
    sub = torch.from_numpy(subnormal_values(np, rng, (2, 600, 258))).to(dev)
    for block_h in (1, 3, 252, 253, 4096):
        cases += [(f"uint8 (2, 600, 700)", x, block_h),
                  (f"bool (2, 600, 700)", x.bool(), block_h),
                  (f"int32 (2, 600, 700)", x.to(torch.int32), block_h),
                  (f"float32 subnormals (2, 600, 258)", sub, block_h)]
    for dtype, width in ((torch.uint8, 1), (torch.int32, 4)):
        flat = rand(2 * 601 * 512 + 16).to(dtype)
        name = str(dtype).split(".")[-1]
        for off in (0, 1, 4, 8):
            if off % width:
                continue
            n = off // width
            cases.append((f"{name} base {off} B off 16 (2, 601, 512)",
                          flat[n:n + 2 * 601 * 512].view(2, 601, 512), 253))
    for w in (8200, 8197):
        y = rand((2, 1000, w))
        cases += [(f"uint8 (2, 1000, {w})", y, 3),
                  (f"uint8 (2, 1000, {w})", y, 252)]
    tall = torch.zeros((1, SCAN_MAX_SEGMENTS * 547, 16), dtype=torch.uint8,
                       device=dev)
    tall[:, ::2] = 1
    tall[:, ::7, 3] = 0
    cases.append((f"alternating rows {tuple(tall.shape)}", tall,
                  tall.shape[1]))
    return cases


def wide_int_cases(np):
    """(label, host (B, H, W) 64-bit mask, its low 32 bits) for the engine:
    2**32 and -2**32 (low bits 0), 2**40 + 1 and 2**64 - 1 (low bits not
    0) beside ordinary pixels, as jnp.asarray reduces them with x64 off."""
    rng = np.random.default_rng(20130617)
    out = []
    for dtype, narrow, vals in [
            (np.int64, np.int32, [0, 1, 3, 2**32, -2**32, 2**40 + 1]),
            (np.uint64, np.uint32, [0, 1, 3, 2**32, 2**64 - 1, 2**40 + 1])]:
        v = np.array(vals, dtype)
        m = v[rng.integers(0, len(v), (2, 300, 517))]
        out.append((f"{np.dtype(dtype).name} (2, 300, 517)", m,
                    m.astype(narrow)))
    return out


def packed_cases(np, torch, modis):
    """(label, cuda (H, W) mask) for the packed kernels' exactness phase:
    H = 1 to 9 (within and across one packed byte), W = 1, ragged H and W,
    all-one columns that run across every packed byte, checkerboards,
    serpentines, uint8/bool/int32/float32, float32 subnormals of both
    signs, and the 4096^2 snowfield of ``bench_kernel_packed``."""
    rng = np.random.default_rng(20130615)
    dev = DEV

    def dtypes(label, a):
        t = torch.from_numpy(a).to(dev)
        yield f"{label} uint8", t
        yield f"{label} bool", t.bool()
        yield f"{label} int32", t.to(torch.int32)
        yield f"{label} float32", t.to(torch.float32)

    shapes = [(h, w) for h in range(1, 10) for w in (1, 300)] + [
        (13, 129), (33, 200), (128, 384), (257, 131), (1000, 513), (64, 1)]
    cases = []
    for shape in shapes:
        cases += dtypes(f"random {shape}", (rng.random(shape) < 0.5).astype(
            np.uint8))
    checker = (np.indices((64, 700)).sum(axis=0) % 2).astype(np.uint8)
    for label, a in [("all-one 100 x 300", np.ones((100, 300), np.uint8)),
                     ("all-one 17 x 70", np.ones((17, 70), np.uint8)),
                     ("checkerboard", checker),
                     ("checkerboard, shifted", 1 - checker),
                     ("serpentine 301 x 257", serpentine(np, 301, 257)),
                     ("serpentine 257 x 301, transposed",
                      np.ascontiguousarray(serpentine(np, 257, 301).T))]:
        cases += dtypes(label, a)
    tiny = np.zeros((9, 3), np.float32)
    tiny[0, 0], tiny[1, 1], tiny[8, 2] = 1e-40, 1.0, -1e-42
    cases.append(("float32 9 x 3, subnormals of both signs",
                  torch.from_numpy(tiny).to(dev)))
    cases.append(("float32 with subnormals", torch.from_numpy(
        subnormal_values(np, rng, (33, 260))).to(dev)))
    cases.append((f"snowfield {PACKED_SNOW_RES}^2", torch.from_numpy(
        modis.snowfield(PACKED_SNOW_RES, seed=2)).to(dev)))
    return cases


# the packed scan (csrc/ychg_packed.cu): at most 256 row segments a column
# (1024 threads, at least 4 lanes, in any tiling it takes); a byte lane
# holds 63 packed rows of 4 runs (it is flushed every kPackedChunk = 60), a
# 16-bit lane 16,383
PACKED_MAX_SEGMENTS = 256
PACKED_LONG_SEGMENTS = (70, 16_400)


def packed_row_cases(np, torch):
    """(label, cuda (Hp, W) packed mask) for the packed kernels, built
    packed: every vector width of a packed row (W mod 16 = 0, 8, 4, 2 and
    1), contiguous views whose base is 1 to 8 bytes off a 16-byte
    boundary, Hp = 0 and 1, W = 1, W at and one vector or one byte past a
    tile edge (64-byte tiles of 4 lanes below 528 vectors a row, and
    21120 = 165 tiles of 8 lanes x 16 B), and columns of 0x55 (4 runs a
    byte) whose every segment passes a byte lane's flush (70 packed rows
    a segment even at 256 segments) or a 16-bit lane's (16,400: 65,600
    runs), four byte lanes a column word."""
    rng = np.random.default_rng(20130619)
    dev = DEV

    def rand(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)
                                ).to(dev)

    cases = []
    for w in (512, 520, 516, 514, 513, 8200, 8197):
        cases.append((f"packed (67, {w})", rand((67, w))))
    flat = rand(57 * 512 + 16)
    for off in range(1, 9):
        cases.append((f"packed base {off} B off 16 (57, 512)",
                      flat[off:off + 57 * 512].view(57, 512)))
    for hp, w in ((0, 300), (1, 300), (1000, 1), (40, 4096), (40, 4112),
                  (40, 4097), (40, 21120), (40, 21136)):
        cases.append((f"packed ({hp}, {w})", rand((hp, w))))
    for rows in PACKED_LONG_SEGMENTS:
        col = torch.full((PACKED_MAX_SEGMENTS * rows, 4), 0x55,
                         dtype=torch.uint8, device=dev)
        col[::7, 2] = 0x15
        cases.append((f"packed 0x55 columns, segments of {rows} "
                      f"{tuple(col.shape)}", col))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one "
              "CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs.ychg_modis import config as workload_config
    from repro_torch.core import ychg
    from repro_torch.data import modis
    from repro_torch.engine import Engine, EngineConfig, registry
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.kernels import _build
    from repro_torch.kernels import ccl as kccl
    from repro_torch.kernels import denoise as kdn
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ychg_colscan as kc
    from repro_torch.kernels import ychg_fused as kf
    from repro_torch.kernels import ychg_packed as kp
    from repro_torch.launch.serve import (
        check_metrics_page,
        derived_masks,
        overload_over_wire,
        overload_pass,
        pipeline_pass,
        serve_passes,
    )
    from repro_torch.scene import (
        BulkJob,
        BulkJobConfig,
        GranuleReader,
        GranuleSpec,
        SceneProgress,
        SceneRunner,
        read_scene_result,
        synthetic_manifest,
    )
    from repro_torch.service import ServiceConfig, YCHGService

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    def free() -> None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # 1. the card
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {count} visible)", flush=True)

    # 2. the build
    t0 = time.perf_counter()
    sources = ["ychg_fused", "ychg_colscan", "denoise", "ccl", "ychg_packed"]
    seconds = _build.build(sources)
    print(f"build: {json.dumps(seconds)} in "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    for source in sources:
        log = _build.library_path(source).with_suffix(".log")
        if log.exists():
            print(f"  ptxas [{source}]: {ptxas_summary(log.read_text())}")
    # denoise's float32 arithmetic must flush subnormals as the
    # reference's XLA does: every form in its PTX is a .ftz one
    ops = ptx_float_ops("denoise")
    check(ops and all(".ftz." in op for op in ops),
          f"denoise PTX has float32 arithmetic without .ftz: {ops}")
    print(f"ptx [denoise]: float32 arithmetic {json.dumps(ops)}", flush=True)

    # host data: two snowfield draws, the rest rolled copies; float32
    # copies of the first batch with impulse pixels; the scene
    t0 = time.perf_counter()
    serve_masks = derived_masks(SERVE_RES, 2 * SERVE_BATCH)
    float_masks = impulse_copies(np, serve_masks[:SERVE_BATCH])
    scene = modis.striped(SCENE_RES, SCENE_HYPEREDGES)
    print(f"host data: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. each kernel against its plain version
    fields = ("runs", "cut_vertices", "transitions", "births", "deaths",
              "n_hyperedges", "n_transitions")
    stats = {name: {"cases": 0, "max_abs_err": 0} for name in KERNELS}
    float_outputs = {"outputs": 0, "differing": 0}

    def tally(name, err):
        stats[name]["cases"] += 1
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)

    def compare_full(label, x):
        err = max_abs_err(kf.launch_full(x), kf.ychg_fused_full_plain(x),
                          f"ychg_fused_full [{label}]")
        tally("ychg_fused_full", err)

    def compare_splith(label, x, block_h):
        err = max_abs_err(kf.launch_splith(x, block_h=block_h),
                          kf.ychg_fused_splith_plain(x, block_h),
                          f"ychg_fused_splith [{label}, block_h={block_h}]")
        tally("ychg_fused_splith", err)

    def compare_denoise(label, x, float_input):
        got, want = kdn.launch(x), kdn.denoise_plain(x)
        if float_input:
            err, n = float_err(got, want, f"denoise [{label}]")
            float_outputs["outputs"] += got.numel()
            float_outputs["differing"] += n
        else:  # bit for bit
            err = max_abs_err({"image": got.view(torch.int32)},
                              {"image": want.view(torch.int32)},
                              f"denoise [{label}]")
        tally("denoise", err)

    def compare_ccl(label, x) -> int:
        got = kccl.launch(x)
        want, sweeps = kccl.fixpoint_with_sweeps(x)
        tally("ccl", max_abs_err({"labels": got}, {"labels": want},
                                 f"ccl [{label}]"))
        return sweeps

    def compare_colscan(label, img, block_h):
        """The three two-kernel-path kernels on one (H, W) mask; returns
        the full-column runs and their diff."""
        runs = kc.launch_full(img)
        tally("ychg_colscan_full", max_abs_err(
            {"runs": runs}, {"runs": kc.colscan_full_plain(img)},
            f"ychg_colscan_full [{label}]"))
        tally("ychg_colscan_splith", max_abs_err(
            {"runs": kc.launch_splith(img, block_h=block_h)},
            {"runs": kc.colscan_splith_plain(img, block_h)},
            f"ychg_colscan_splith [{label}, block_h={block_h}]"))
        diff = kc.launch_diff(runs)
        tally("ychg_diff", max_abs_err(diff, kc.diff_plain(runs),
                                       f"ychg_diff [{label}]"))
        return runs, diff

    def compare_analyze(label, x, block_h):
        """The two-kernel batch entry on both routes against its plain
        version and ``core.ychg.analyze``."""
        ref = ychg.analyze(x)
        ref = {f: getattr(ref, f) for f in fields}
        for route in (None, block_h):
            got = kc.launch_analyze(x, block_h=route)
            what = f"ychg_colscan_analyze [{label}, block_h={route}]"
            err = max_abs_err(got, kc.analyze_plain(x, route), what)
            max_abs_err(got, ref, f"{what} vs core.ychg.analyze")
            tally("ychg_diff", err)
            tally("ychg_colscan_full" if route is None
                  else "ychg_colscan_splith", err)

    def compare_packed_rows(label, packed):
        """Both packed kernels on one packed mask against their plain
        versions; returns the fused kernel's fields."""
        tally("ychg_packed_colscan", max_abs_err(
            {"runs": kp.launch_colscan(packed)},
            {"runs": kp.packed_colscan_plain(packed)},
            f"ychg_packed_colscan [{label}]"))
        got = kp.launch_fused(packed)
        tally("ychg_packed_fused", max_abs_err(
            got, kp.packed_fused_plain(packed),
            f"ychg_packed_fused [{label}]"))
        return got

    def compare_packed(label, img):
        """Both packed kernels on the packing of one (H, W) mask, against
        their plain versions and, for the fused one, against the reference
        on the unpacked mask; returns the fused kernel's fields."""
        got = compare_packed_rows(label, kp.pack_rows(img))
        ref = ychg.analyze(img)
        max_abs_err(got, {f: getattr(ref, f) for f in fields},
                    f"ychg_packed_fused [{label}] vs core.ychg.analyze")
        return got

    for label, x, block_h in kernel_cases(np, torch, modis):
        compare_full(label, x)
        compare_splith(label, x, block_h)
        compare_analyze(label, x, block_h)
        for i in range(x.shape[0]):
            compare_colscan(f"{label} [{i}]", x[i], block_h)
    for label, x, block_h in splith_cases(np, torch):
        compare_splith(label, x, block_h)
        compare_analyze(label, x, block_h)
    for label, x in scan_cases(np, torch):
        compare_full(label, x)
        if label.startswith("alternating rows, segments of"):
            # one range of the whole column: its segments pass the byte
            # lanes' and the 16-bit lanes' flushes
            compare_splith(label, x, x.shape[1])
        for i in range(min(x.shape[0], 2)):
            tally("ychg_colscan_full", max_abs_err(
                {"runs": kc.launch_full(x[i])},
                {"runs": kc.colscan_full_plain(x[i])},
                f"ychg_colscan_full [{label} [{i}]]"))
        del x
    free()
    # 64-bit integer masks keep their low 32 bits, as jnp.asarray does
    for label, wide, narrow in wide_int_cases(np):
        ref = ychg.analyze(torch.from_numpy(narrow).to(DEV))
        max_abs_err(
            {f: getattr(Engine().analyze_batch(wide).to_summary(), f)
             for f in fields}, {f: getattr(ref, f) for f in fields},
            f"Engine() on {label} vs the plain reference on its low 32 bits")
        for op in ("ychg", "ccl", "denoise"):
            want = Engine().analyze_batch(narrow, op=op).to_host()
            for where, x in (("host", wide),
                             ("device", torch.from_numpy(wide).to(DEV))):
                got = Engine().analyze_batch(x, op=op).to_host()
                for f, w in want.items():
                    check(got[f].dtype == w.dtype and got[f].shape == w.shape
                          and got[f].tobytes() == w.tobytes(),
                          f"Engine() op {op} on {label} ({where}): {f} "
                          f"differs from it on the low 32 bits")
        print(f"exact: Engine() on a {label} mask equals it on its low 32 "
              f"bits for ychg, ccl and denoise, from the host and from the "
              f"device", flush=True)
    runs = torch.from_numpy(np.random.default_rng(20130614).integers(
        0, 1000, 5000).astype(np.int32)).to(DEV)
    tally("ychg_diff", max_abs_err(kc.launch_diff(runs), kc.diff_plain(runs),
                                   "ychg_diff [random runs]"))
    for label, x, float_input in image_cases(np, torch):
        compare_denoise(label, x, float_input)
        compare_ccl(label, x)
    for label, x in subnormal_image_cases(np, torch):
        tally("denoise", float_exact(kdn.launch(x), kdn.denoise_plain(x),
                                     f"denoise [{label}]"))
        compare_ccl(label, x)
    for label, a in ccl_big_cases(np, torch):
        sweeps = compare_ccl(label, torch.from_numpy(a).to(DEV))
        print(f"exact: ccl [{label}] (the plain version took {sweeps} "
              f"sweeps)", flush=True)
        free()
    for label, x in packed_cases(np, torch, modis):
        compare_packed(label, x)
    for label, x in packed_row_cases(np, torch):
        compare_packed_rows(label, x)
        del x
    free()
    serve_stack = torch.from_numpy(np.stack(serve_masks[:SERVE_BATCH])).to(DEV)
    float_stack = torch.from_numpy(np.stack(float_masks)).to(DEV)
    scene_stack = torch.from_numpy(scene).to(DEV)[None]
    tall_stack = serve_stack[:TALL_MASKS].reshape(
        1, TALL_MASKS * SERVE_RES, SERVE_RES)
    compare_full("serving batch", serve_stack)
    compare_splith("serving batch", serve_stack, SCENE_BLOCK_H)
    compare_analyze("serving batch", serve_stack, SCENE_BLOCK_H)
    tall_label = f"tall strip {tuple(tall_stack.shape)}"
    compare_full(tall_label, tall_stack)
    compare_splith(tall_label, tall_stack, SCENE_BLOCK_H)
    compare_analyze(tall_label, tall_stack, SCENE_BLOCK_H)
    for i in range(SERVE_BATCH):
        compare_colscan(f"serving batch [{i}]", serve_stack[i], SCENE_BLOCK_H)
    compare_denoise("serving batch", serve_stack, False)
    compare_denoise("serving batch, float32 with impulses", float_stack, True)
    sweeps = compare_ccl("serving batch", serve_stack)
    print(f"exact: ccl plain version took {sweeps} sweeps on the "
          f"{SERVE_BATCH} x {SERVE_RES}^2 serving batch", flush=True)
    free()
    for name, out in [
            ("ychg_fused_full", kf.launch_full(scene_stack)),
            ("ychg_fused_splith",
             kf.launch_splith(scene_stack, block_h=SCENE_BLOCK_H))]:
        got = int(out["n_hyperedges"][0])
        check(got == SCENE_HYPEREDGES,
              f"{name}: scene gives {got} hyperedges, want {SCENE_HYPEREDGES}")
    compare_full("21000^2 scene", scene_stack)
    compare_splith("21000^2 scene", scene_stack, SCENE_BLOCK_H)
    for route in (None, SCENE_BLOCK_H):
        got = int(kc.launch_analyze(scene_stack,
                                    block_h=route)["n_hyperedges"][0])
        check(got == SCENE_HYPEREDGES,
              f"ychg_colscan_analyze (block_h={route}): scene gives {got} "
              f"hyperedges, want {SCENE_HYPEREDGES}")
    compare_analyze("21000^2 scene", scene_stack, SCENE_BLOCK_H)
    _, diff = compare_colscan("21000^2 scene", scene_stack[0], SCENE_BLOCK_H)
    for name, runs in [
            ("ychg_colscan_full", kc.launch_full(scene_stack[0])),
            ("ychg_colscan_splith",
             kc.launch_splith(scene_stack[0], block_h=SCENE_BLOCK_H))]:
        got = int(torch.sum(kc.launch_diff(runs)["births"],
                            dtype=torch.int32))
        check(got == SCENE_HYPEREDGES,
              f"{name} + ychg_diff: scene gives {got} hyperedges, want "
              f"{SCENE_HYPEREDGES}")
    del diff, runs
    sweeps = compare_ccl("21000^2 scene", scene_stack)
    got = int(compare_packed("21000^2 scene", scene_stack[0])["n_hyperedges"])
    check(got == SCENE_HYPEREDGES,
          f"ychg_packed_fused: scene gives {got} hyperedges, want "
          f"{SCENE_HYPEREDGES}")
    free()
    for name, st in stats.items():
        print(f"exact: {name} equals its plain version on {st['cases']} "
              f"cases", flush=True)
    print(f"float: denoise on float inputs differs from its plain version in "
          f"{float_outputs['differing']} of {float_outputs['outputs']} "
          f"outputs (bound: 1 ulp, 1 in 10^4); max abs err "
          f"{stats['denoise']['max_abs_err']}", flush=True)

    def ccl_passes_ms(x) -> dict:
        """ccl's three passes on ``x``, from its C entry points on one
        labels buffer. The seams and the final pass change the buffer the
        next call starts from, so each is timed as the difference between
        runs that start with the local pass: local, local + seams, all."""
        lib = _build.load("ccl", kccl._SIGNATURES)
        out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), kccl._KERNEL_DTYPES[x.dtype], *x.shape,
                out.data_ptr(), stream)

        def local_and_seams():
            lib.ccl_local(*args)
            lib.ccl_seams(*x.shape, out.data_ptr(), stream)

        t_local = time_ms(lambda: lib.ccl_local(*args))
        t_seams = time_ms(local_and_seams)
        t_all = time_ms(lambda: lib.ccl(*args))
        return {"local": t_local, "seams": t_seams - t_local,
                "final": t_all - t_seams, "all": t_all}

    timings = {}
    lone, scene_img = serve_stack[0], scene_stack[0]
    lone_stack = serve_stack[:1]
    lone_runs = kc.launch_full(lone)
    tall_img = tall_stack[0]
    scene_packed, lone_packed = kp.pack_rows(scene_img), kp.pack_rows(lone)
    for name, x, run, plain, bound_fn, plain_samples in [
            ("ychg_fused_full", serve_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain, bound, 10),
            # the service flushes a lone mask as a batch of 1 when the
            # submitting thread's content hash outlasts the delay window
            ("ychg_fused_full", lone_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain, bound, 10),
            ("ychg_fused_full", scene_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain, bound, 10),
            ("ychg_fused_full", tall_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain, bound, 10),
            ("ychg_fused_splith", scene_stack,
             lambda x: kf.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, SCENE_BLOCK_H), bound,
             10),
            ("ychg_fused_splith", serve_stack,
             lambda x: kf.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, SCENE_BLOCK_H), bound,
             10),
            ("ychg_fused_splith", tall_stack,
             lambda x: kf.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, SCENE_BLOCK_H), bound,
             10),
            # the two-kernel path runs one image a launch
            ("ychg_colscan_full", lone, kc.launch_full,
             kc.colscan_full_plain, bound_colscan, 10),
            ("ychg_colscan_full", scene_img, kc.launch_full,
             kc.colscan_full_plain, bound_colscan, 10),
            ("ychg_colscan_full", tall_img, kc.launch_full,
             kc.colscan_full_plain, bound_colscan, 10),
            ("ychg_colscan_splith", scene_img,
             lambda x: kc.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kc.colscan_splith_plain(x, SCENE_BLOCK_H),
             bound_colscan, 10),
            ("ychg_colscan_splith", lone,
             lambda x: kc.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kc.colscan_splith_plain(x, SCENE_BLOCK_H),
             bound_colscan, 10),
            ("ychg_colscan_splith", tall_img,
             lambda x: kc.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kc.colscan_splith_plain(x, SCENE_BLOCK_H),
             bound_colscan, 10),
            ("ychg_diff", lone_runs, kc.launch_diff, kc.diff_plain,
             bound_diff, 10),
            ("denoise", serve_stack, kdn.launch, kdn.denoise_plain,
             bound_denoise, 5),
            ("denoise", float_stack, kdn.launch, kdn.denoise_plain,
             bound_denoise, 5),
            ("denoise", serve_stack[:1], kdn.launch, kdn.denoise_plain,
             bound_denoise, 5),
            ("ccl", serve_stack, kccl.launch, kccl.ccl_fixpoint_plain,
             bound_ccl, 3),
            ("ccl", serve_stack[:1], kccl.launch, kccl.ccl_fixpoint_plain,
             bound_ccl, 3),
            ("ychg_packed_colscan", scene_packed, kp.launch_colscan,
             kp.packed_colscan_plain, bound_packed_colscan, 10),
            ("ychg_packed_colscan", lone_packed, kp.launch_colscan,
             kp.packed_colscan_plain, bound_packed_colscan, 10),
            ("ychg_packed_fused", scene_packed, kp.launch_fused,
             kp.packed_fused_plain, bound_packed_fused, 10),
            ("ychg_packed_fused", lone_packed, kp.launch_fused,
             kp.packed_fused_plain, bound_packed_fused, 10)]:
        b_ms, b_by, b_bytes = bound_fn(x)
        row = {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
               "ms": time_ms(lambda: run(x)),
               "plain_ms": time_ms(lambda: plain(x), samples=plain_samples,
                                   reps=1),
               "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": b_bytes}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        extra = ""
        if name == "ccl":
            # the ccl op as its backend runs it: kernel, then the canonical
            # re-ranking, which is plain torch ops
            fg, raw = x != 0, kccl.launch(x)
            row["canonicalize_ms"] = time_ms(
                lambda: kccl._canonicalize(raw, fg), samples=5, reps=1)
            row["op_ms"] = time_ms(lambda: kccl.labels_kernel(x), samples=5,
                                   reps=1)
            row["canonicalize_share"] = row["canonicalize_ms"] / row["op_ms"]
            del fg, raw
            extra = (f"; canonicalize {row['canonicalize_ms']:.4f} ms, "
                     f"{100 * row['canonicalize_share']:.1f}% of the whole "
                     f"op {row['op_ms']:.4f} ms")
            row["passes_ms"] = ccl_passes_ms(x)
            print(f"time: ccl passes {row['shape']} {row['dtype']}: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in
                              row["passes_ms"].items())
                  + " (C entry points; seams and final by difference of "
                  f"local, local + seams and all three) on {card}",
                  flush=True)
        if name == "ychg_fused_full" and x is lone_stack:
            # the C entry point alone on preallocated outputs (the totals
            # accumulate over the calls; only the time is read)
            lib = _build.load("ychg_fused", kf._SIGNATURES)
            ptrs = kf._out_ptrs(kf.launch_full(x))
            stream = torch.cuda.current_stream().cuda_stream
            row["entry_point_ms"] = time_ms(
                lambda: lib.ychg_fused_full(x.data_ptr(),
                                            kf._KERNEL_DTYPES[x.dtype],
                                            *x.shape, *ptrs, stream), reps=50)
            extra = f"; C entry point alone {row['entry_point_ms']:.4f} ms"
        if name == "ychg_colscan_full" and x is lone:
            lib = _build.load("ychg_colscan", kc._SIGNATURES)
            out = kc.launch_full(x)
            stream = torch.cuda.current_stream().cuda_stream
            row["entry_point_ms"] = time_ms(
                lambda: lib.ychg_colscan_full(x.data_ptr(),
                                              kc._KERNEL_DTYPES[x.dtype],
                                              *x.shape, out.data_ptr(),
                                              stream), reps=50)
            extra = f"; C entry point alone {row['entry_point_ms']:.4f} ms"
            del out
        if name == "ychg_fused_splith" and x is serve_stack:
            # the C entry point alone on preallocated outputs (the runs and
            # totals accumulate over the calls; only the time is read)
            lib = _build.load("ychg_fused", kf._SIGNATURES)
            ptrs = kf._out_ptrs(kf.launch_splith(x, block_h=SCENE_BLOCK_H))
            stream = torch.cuda.current_stream().cuda_stream
            row["entry_point_ms"] = time_ms(
                lambda: lib.ychg_fused_splith(x.data_ptr(),
                                              kf._KERNEL_DTYPES[x.dtype],
                                              *x.shape, SCENE_BLOCK_H, *ptrs,
                                              stream), reps=20)
            extra = f"; C entry point alone {row['entry_point_ms']:.4f} ms"
        if name == "ychg_diff":
            # the standalone kernel (ops.transitions), off the main path: a
            # host-bound wrapper, so more samples and their quartiles
            row["kernel"] = "diff_kernel<false>, off the main path"
            wrapper = time_samples(lambda: run(x), samples=101, reps=10)
            row["ms"] = statistics.median(wrapper)
            q = statistics.quantiles(wrapper, n=4)
            row["ms_quartiles"] = [q[0], q[2]]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            # the C entry point alone on preallocated outputs: the wrapper's
            # checks and its allocation taken away
            lib = _build.load("ychg_colscan", kc._SIGNATURES)
            ptrs = [v.data_ptr() for v in kc.launch_diff(x).values()]
            stream = torch.cuda.current_stream().cuda_stream
            row["entry_point_ms"] = time_ms(
                lambda: lib.ychg_diff(x.data_ptr(), x.shape[0], *ptrs,
                                      stream), reps=50)
            extra = (f"; median of 101 samples, quartiles "
                     f"{q[0]:.4f}-{q[2]:.4f} ms; C entry point alone "
                     f"{row['entry_point_ms']:.4f} ms; off the main path")
        if name == "ychg_packed_fused" and x is scene_packed:
            # packed_analyze on the unpacked scene is pack_rows (torch ops)
            # and then this kernel
            row["pack_rows_ms"] = time_ms(lambda: kp.pack_rows(scene_img),
                                          samples=5, reps=1)
            row["pack_rows_bound_ms"] = bound_pack_rows(scene_img)[0]
            row["packed_analyze_ms"] = time_ms(
                lambda: kp.packed_analyze(scene_img), samples=5, reps=1)
            row["pack_rows_share"] = (row["pack_rows_ms"]
                                      / row["packed_analyze_ms"])
            extra = (f"; pack_rows alone {row['pack_rows_ms']:.4f} ms "
                     f"(bound {row['pack_rows_bound_ms']:.4f} ms), "
                     f"{100 * row['pack_rows_share']:.1f}% of "
                     f"packed_analyze {row['packed_analyze_ms']:.4f} ms on "
                     f"the unpacked scene")
        timings.setdefault(name, []).append(row)
        print(f"time: {name} {row['shape']} {row['dtype']}: "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms by {b_by} ({b_bytes} B), "
              f"{100 * row['bound_share']:.1f}% of bound{extra}) on {card}",
              flush=True)
        free()
    full, split = timings["ychg_fused_full"], timings["ychg_fused_splith"]
    print(f"time: ychg_fused_full against ychg_fused_splith (block_h "
          f"{SCENE_BLOCK_H}), the engine's two fused routes: serving batch "
          f"{full[0]['ms']:.4f} ms against {split[1]['ms']:.4f} ms, scene "
          f"{full[2]['ms']:.4f} ms against {split[0]['ms']:.4f} ms, tall "
          f"strip {full[3]['ms']:.4f} ms against {split[2]['ms']:.4f} ms on "
          f"{card}", flush=True)
    step1 = (timings["ychg_colscan_full"][2], timings["ychg_colscan_splith"][2])
    print(f"time: the two step-1 routes on the tall strip "
          f"{step1[0]['shape']}: ychg_colscan_full {step1[0]['ms']:.4f} ms, "
          f"ychg_colscan_splith (block_h {SCENE_BLOCK_H}) "
          f"{step1[1]['ms']:.4f} ms (bound {step1[0]['bound_ms']:.4f} ms) on "
          f"{card}", flush=True)

    # the two-kernel path's batch entry on the serving batch: through its
    # wrapper and as its C call alone on preallocated outputs, its step 2
    # as a programmatic dependent launch against plain stream order (the C
    # entry point and its diagnostic twin, in turns), and that step-2
    # kernel's own device time, read from a torch.profiler trace
    lib = _build.load("ychg_colscan", kc._SIGNATURES)
    out = kc.launch_analyze(serve_stack)
    stream = torch.cuda.current_stream().cuda_stream
    args = (serve_stack.data_ptr(), 0, *serve_stack.shape, 0,
            *[out[k].data_ptr() for k in kc.ANALYZE_FIELDS], stream)
    pdl = lambda: lib.ychg_colscan_analyze(*args)  # noqa: E731
    ordered = lambda: lib.ychg_colscan_analyze_stream_order(*args)  # noqa: E731
    turns = [time_ms(f, reps=10) for f in (pdl, ordered, ordered, pdl)]
    batch_entry = {
        "shape": list(serve_stack.shape), "launches": 2 * SERVE_BATCH,
        "wrapper_ms": time_ms(lambda: kops.analyze_batch(serve_stack)),
        "entry_point_ms": turns[0],
        "pdl_ms": [turns[0], turns[3]],
        "stream_order_ms": [turns[1], turns[2]]}
    print(f"time: ychg_colscan_analyze {batch_entry['shape']} uint8 "
          f"({2 * SERVE_BATCH} launches, one host call): through "
          f"kops.analyze_batch {batch_entry['wrapper_ms']:.4f} ms, its C call "
          f"alone {batch_entry['entry_point_ms']:.4f} ms on {card}",
          flush=True)
    print(f"pdl: ychg_colscan_analyze's C call on {batch_entry['shape']}, "
          f"step 2 as a programmatic dependent launch "
          + " / ".join(f"{t:.4f}" for t in batch_entry["pdl_ms"])
          + " ms against plain stream order (ychg_colscan_analyze_stream_order) "
          + " / ".join(f"{t:.4f}" for t in batch_entry["stream_order_ms"])
          + f" ms, in turns; {card}", flush=True)
    # ychg_diff on the main path is this step-2 kernel: its row leads
    step2 = ("diff_kernel<true>", "diff_kernelILb1E")
    runs_row = out["runs"][0].clone()
    b_ms, b_by, b_bytes = bound_finish(runs_row)
    device_ms, seen = kernel_device_ms(pdl, step2)
    check(seen == 20 * SERVE_BATCH,
          f"the trace saw {seen} step-2 launches, want {20 * SERVE_BATCH}")
    row = {"kernel": "diff_kernel<true>, the batch entry's step 2",
           "shape": list(runs_row.shape), "dtype": "int32",
           "ms": device_ms,
           "stream_order_ms": kernel_device_ms(ordered, step2)[0],
           "plain_ms": time_ms(lambda: kc.finish_plain(runs_row), reps=1),
           "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": b_bytes}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    timings["ychg_diff"].insert(0, row)
    print(f"time: ychg_diff on the main path ({row['kernel']}) "
          f"{row['shape']} int32, one mask of the serving batch: "
          f"{row['ms']:.4f} ms a launch on the device (torch.profiler, "
          f"{seen} launches; {row['stream_order_ms']:.4f} ms in stream "
          f"order; plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.6f} ms by {b_by} ({b_bytes} B), "
          f"{100 * row['bound_share']:.1f}% of bound) on {card}", flush=True)
    del out
    # the packed kernels on the device (torch.profiler, after the trace
    # above) and as their C entry points alone on preallocated outputs (the
    # fused totals accumulate over the calls; only the time is read)
    lib = _build.load("ychg_packed", kp._SIGNATURES)
    for name, run in (("ychg_packed_colscan", kp.launch_colscan),
                      ("ychg_packed_fused", kp.launch_fused)):
        entry = getattr(lib, name)
        for row, x in zip(timings[name], (scene_packed, lone_packed)):
            row["device_ms"], row["device_launches_seen"] = kernel_device_ms(
                lambda: run(x), (name.replace("ychg_", "") + "_kernel",))
            check(row["device_launches_seen"] == 20,
                  f"the trace saw {row['device_launches_seen']} {name} "
                  f"launches on {row['shape']}, want 20")
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
            out = run(x)
            ptrs = ([out[k].data_ptr() for k in kp._FUSED_OUT]
                    if isinstance(out, dict) else [out.data_ptr()])
            row["entry_point_ms"] = time_ms(
                lambda: entry(x.data_ptr(), *x.shape, *ptrs, stream), reps=50)
            print(f"time: {name} {row['shape']} uint8 on the device "
                  f"{row['device_ms']:.4f} ms a launch (torch.profiler, "
                  f"{row['device_launches_seen']} launches), "
                  f"{100 * row['device_bound_share']:.1f}% of its bound "
                  f"{row['bound_ms']:.4f} ms; C entry point alone "
                  f"{row['entry_point_ms']:.4f} ms; through its wrapper "
                  f"{row['ms']:.4f} ms; on {card}", flush=True)
            del out
    del serve_stack, float_stack, scene_stack, lone, scene_img, lone_runs
    del lone_stack, tall_stack, tall_img
    del scene_packed, lone_packed
    free()

    # 4. the main path, counted from zero
    for module in (kf, kc, kdn, kccl, kp):
        module.reset_launch_counts()
    registry.reset_call_counts()
    engine = Engine()
    torch_engine = Engine(EngineConfig(backend="torch"))
    cuda_engine = Engine(EngineConfig(backend="cuda"))
    for op, want_backend in [("ychg", "fused"), ("ccl", "cuda"),
                             ("denoise", "cuda")]:
        got = engine.resolve_backend(op=op)
        check(got == want_backend,
              f"Engine() resolves op {op} to {got!r}, want {want_backend!r}")
    stack = np.stack(serve_masks[:SERVE_BATCH])
    float_np = np.stack(float_masks)
    got = engine.analyze_batch(stack).block_until_ready()
    check(kf.LAUNCHES["ychg_fused_full"] > 0,
          "Engine().analyze_batch launched no ychg_fused_full kernel")
    want = torch_engine.analyze_batch(stack)
    max_abs_err({f: getattr(got, f) for f in fields},
                {f: getattr(want, f) for f in fields},
                "Engine fused vs torch, 8 x 8192^2")
    # the two-kernel backend: one step-1 and one step-2 launch a mask
    got = cuda_engine.analyze_batch(stack).block_until_ready()
    check(kc.LAUNCHES["ychg_colscan_full"] == SERVE_BATCH
          and kc.LAUNCHES["ychg_diff"] == SERVE_BATCH,
          f"Engine(backend='cuda').analyze_batch launched "
          f"{json.dumps(kc.LAUNCHES)}, want {SERVE_BATCH} of step 1 and 2")
    max_abs_err({f: getattr(got, f) for f in fields},
                {f: getattr(want, f) for f in fields},
                "Engine cuda vs torch, 8 x 8192^2")
    del got, want
    for op, label, data in [("ccl", "uint8 masks", stack),
                            ("denoise", "uint8 masks", stack),
                            ("denoise", "float32 with impulses", float_np)]:
        got = engine.analyze_batch(data, op=op).block_until_ready()
        want = torch_engine.analyze_batch(data, op=op)
        what = f"Engine {op} vs torch, {label}"
        if op == "ccl":
            max_abs_err({"labels": got.labels, "n": got.n_components},
                        {"labels": want.labels, "n": want.n_components}, what)
        elif data.dtype == np.float32:
            float_err(got.image, want.image, what)
        else:  # bit for bit
            max_abs_err({"image": got.image.view(torch.int32)},
                        {"image": want.image.view(torch.int32)}, what)
        del got, want
        free()
    print(f"main path: Engine() -> fused (ychg), cuda (ccl, denoise); "
          f"{SERVE_BATCH} x {SERVE_RES}^2 equal to backend='torch' for ychg "
          f"(fused and the two-kernel cuda backend), ccl and denoise (uint8 "
          f"masks and float32 with impulses)", flush=True)
    piped = engine.run_pipeline(float_np, ["denoise", "ychg"])
    seq = engine.analyze_batch(
        engine.analyze_batch(float_np, op="denoise").image, op="ychg")
    max_abs_err({f: getattr(piped, f) for f in fields},
                {f: getattr(seq, f) for f in fields},
                "run_pipeline(['denoise', 'ychg']) vs the two stages")
    del piped, seq
    free()
    print(f"main path: Engine().run_pipeline(['denoise', 'ychg']) on "
          f"{SERVE_BATCH} x {SERVE_RES}^2 float32 equals the two stages run "
          f"one after the other", flush=True)

    def plain_reference(op, mask):
        x = torch.from_numpy(mask).to(DEV)
        if op == "ychg":
            s = ychg.analyze(x)
            return {f: getattr(s, f) for f in fields}
        if op == "ccl":
            s = kccl.labels(x[None])
            return {"labels": s.labels, "n_components": s.n_components}
        return {"image": kdn.denoise_plain(x[None]).view(torch.int32)}

    def served_fields(op, res):
        if op == "ychg":
            s = res.to_summary()
            return {f: getattr(s, f) for f in fields}
        if op == "ccl":
            return {"labels": res.labels, "n_components": res.n_components}
        return {"image": res.image.view(torch.int32)}

    for op, config, want_backend in [
            ("ychg", EngineConfig(), "fused"),
            ("ychg", EngineConfig(backend="cuda"), "cuda"),
            ("ccl", EngineConfig(), "cuda"),
            ("denoise", EngineConfig(), "cuda")]:
        report = serve_passes(Engine(config), serve_masks[:SERVE_BATCH],
                              serve_masks[SERVE_BATCH:], op=op)
        check(report.backend == want_backend,
              f"{op} service backend {report.backend!r}")
        label = f"{op}[{want_backend}]"
        served = 0
        for outs, masks in [(report.cold, serve_masks[:SERVE_BATCH]),
                            (report.warm, serve_masks[SERVE_BATCH:]),
                            (report.cached, serve_masks[:SERVE_BATCH])]:
            for res, mask in zip(outs, masks):
                max_abs_err(served_fields(op, res), plain_reference(op, mask),
                            f"served {label} result {served}")
                served += 1
        check(report.cached_batches == 0,
              f"{label}: cached pass dispatched {report.cached_batches} "
              f"batches")
        check(report.cached_hit_rate == 1.0,
              f"{label}: cached pass hit rate {report.cached_hit_rate}")
        m = report.metrics
        print(f"serve {label}: {served} served results equal the plain "
              f"reference; cold {report.t_cold * 1e3:.1f} ms, warm "
              f"{report.t_warm * 1e3:.1f} ms ({report.warm_mpx_s:.0f} "
              f"Mpx/s), cached {report.t_cached * 1e3:.1f} ms; p50 "
              f"{m.p50_latency_ms:.1f} ms p95 {m.p95_latency_ms:.1f} ms over "
              f"{m.completed} requests on {card}", flush=True)
        print(f"serve {label}: device batches per pass of {SERVE_BATCH} masks: "
              + json.dumps(report.batches), flush=True)
        print(f"serve {label}: warm pass by stage (s, summed over its "
              f"requests): " + json.dumps(report.warm_stage_s), flush=True)
        del report
        free()

    prep = pipeline_pass(Engine(), float_masks, ("denoise", "ychg"))
    check(prep.backend == "cuda+fused",
          f"pipeline service backends {prep.backend!r}")
    for i, (res, mask) in enumerate(zip(prep.results, float_masks)):
        x = torch.from_numpy(mask).to(DEV)[None]
        ref = ychg.analyze(kdn.denoise_plain(x)[0])
        s = res.to_summary()
        max_abs_err({f: getattr(s, f) for f in fields},
                    {f: getattr(ref, f) for f in fields},
                    f"served denoise+ychg result {i}")
    pm = prep.metrics
    print(f"serve denoise+ychg: {len(prep.results)} served results equal the "
          f"plain reference; pass {prep.seconds * 1e3:.1f} ms in "
          f"{prep.batches} device batches; p50 {pm.p50_latency_ms:.1f} ms "
          f"p95 {pm.p95_latency_ms:.1f} ms on {card}", flush=True)
    print("serve denoise+ychg: by stage (s, summed over its requests): "
          + json.dumps(prep.stage_s), flush=True)
    del prep
    free()

    burst = [np.roll(mk, s, axis=1) for s in (1, 2)
             for mk in serve_masks]
    admitted, shed = overload_pass(engine, burst, max_batch=SERVE_BATCH)
    print(f"overload: burst of {len(burst)}: {admitted} admitted, {shed} "
          f"shed", flush=True)

    for label, eng in [
            ("full-column", Engine()),
            ("split-H", Engine(EngineConfig(stream_vmem_budget=0))),
            ("two-kernel full-column", cuda_engine),
            ("two-kernel split-H",
             Engine(EngineConfig(backend="cuda", stream_vmem_budget=0)))]:
        r = eng.analyze(scene).block_until_ready()
        n = int(r.n_hyperedges[0])
        check(n == SCENE_HYPEREDGES,
              f"scene via {label} engine: {n} hyperedges, want "
              f"{SCENE_HYPEREDGES}")
        print(f"scene: {SCENE_RES}^2 via the {label} engine gives {n} "
              f"hyperedges", flush=True)
    r = engine.analyze(scene, op="ccl").block_until_ready()
    n = int(r.n_components[0])
    check(n == SCENE_HYPEREDGES,
          f"scene as op ccl: {n} components, want {SCENE_HYPEREDGES}")
    print(f"scene: {SCENE_RES}^2 as op ccl gives {n} components (the plain "
          f"version took {sweeps} sweeps on it)", flush=True)
    del r
    free()
    scene_dev = torch.from_numpy(scene).to(DEV)
    whole = engine.analyze(scene_dev).to_summary()
    whole_fields = {f: getattr(whole, f) for f in fields}
    max_abs_err(kp.packed_analyze(scene_dev), whole_fields,
                "packed_analyze vs Engine().analyze, scene")
    max_abs_err({"runs": kp.packed_colscan(kp.pack_rows(scene_dev))},
                {"runs": whole.runs},
                "packed_colscan vs Engine().analyze runs, scene")
    print(f"scene: {SCENE_RES}^2 through packed_analyze and packed_colscan "
          f"equals Engine().analyze ({int(whole.n_hyperedges)} hyperedges)",
          flush=True)
    whole_host = {f: v.cpu().numpy() for f, v in whole_fields.items()}
    del scene_dev, whole, whole_fields
    free()

    # the scene tier: the scene as a memmap granule, in full-width strips
    def host_equal(got, label):
        for f, w in whole_host.items():
            g = np.asarray(got[f])
            check(g.dtype == w.dtype and g.shape == w.shape
                  and np.array_equal(g, w),
                  f"{label}: field {f} differs from one whole-scene "
                  f"Engine().analyze call")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.npy")
        np.save(path, scene)
        spec = GranuleSpec(granule_id=f"striped_{SCENE_RES}",
                           height=SCENE_RES, width=SCENE_RES, kind="memmap",
                           path=path)
        progress = SceneProgress()
        obs.recorder().clear()
        report = BulkJob(Engine(), [spec], BulkJobConfig(
            out_dir=os.path.join(tmp, "out"),
            ckpt_dir=os.path.join(tmp, "ckpt"), tile_h=BULK_TILE_H,
            stack_tiles=BULK_STACK), progress=progress).run()
        check(report.completed and len(report.written) == 1,
              f"scene bulk job ended {report.status}")
        result = read_scene_result(report.written[0])
        host_equal(result.to_host(), "scene bulk job")
        snap = progress.snapshot()
        print(f"scene tier: BulkJob on the {SCENE_RES}^2 memmap granule "
              f"({report.tiles_done} strips of {BULK_TILE_H} rows in "
              f"{report.stacks_done} device batches of up to {BULK_STACK}) "
              f"is bit-identical to one whole-scene call "
              f"({int(result.n_hyperedges)} hyperedges): "
              f"{report.elapsed_s:.3f} s, "
              f"{SCENE_RES ** 2 / report.elapsed_s / 1e6:.1f} Mpx/s, stitch "
              f"{snap.stitch_time_s:.4f} s; on {card}", flush=True)
        print("scene tier: BulkJob by span (s): "
              + json.dumps(scene_span_seconds()), flush=True)
        reader = GranuleReader.open(spec, BULK_TILE_H)
        obs.recorder().clear()
        t0 = time.perf_counter()
        streamed = SceneRunner(Engine(), stack_tiles=BULK_STACK).analyze_scene(
            reader)
        t_stream = time.perf_counter() - t0
        host_equal(streamed.to_host(), "SceneRunner.analyze_scene")
        print(f"scene tier: SceneRunner.analyze_scene (analyze_stream) on the "
              f"same granule is bit-identical too: {t_stream:.3f} s, "
              f"{SCENE_RES ** 2 / t_stream / 1e6:.1f} Mpx/s; on {card}",
              flush=True)
        print("scene tier: SceneRunner by span (s): "
              + json.dumps(scene_span_seconds()), flush=True)
        del result, streamed
    del whole_host
    free()

    manifest = synthetic_manifest(2, RESUME_H, RESUME_W, seed=11)
    with tempfile.TemporaryDirectory() as tmp:
        def job(tag, progress=None):
            return BulkJob(Engine(), manifest, BulkJobConfig(
                out_dir=os.path.join(tmp, tag, "out"),
                ckpt_dir=os.path.join(tmp, tag, "ckpt"),
                tile_h=RESUME_TILE_H, stack_tiles=2, checkpoint_every=1),
                progress=progress)

        straight = job("straight").run()
        check(straight.completed, "straight bulk job did not complete")
        first = job("killed").run(max_stacks=3)
        check(not first.completed, "max_stacks=3 did not interrupt the job")
        newest = sorted(glob.glob(os.path.join(tmp, "killed", "ckpt",
                                               "step_*")))[-1]
        with open(glob.glob(os.path.join(newest, "*.npz"))[0], "r+b") as f:
            f.truncate(8)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            second = job("killed", SceneProgress()).run()
        check(any(issubclass(c.category, RuntimeWarning) for c in caught),
              "the truncated checkpoint resumed without a RuntimeWarning")
        check(second.completed and second.resumes == 1,
              f"resumed job ended {second.status} with {second.resumes} "
              f"resumes")
        for g in manifest:
            a, b = (os.path.join(tmp, tag, "out", f"{g.granule_id}.ychg")
                    for tag in ("straight", "killed"))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                check(fa.read() == fb.read(),
                      f"{g.granule_id}: killed and resumed output differs "
                      f"from the straight run's")
    print(f"scene tier: {len(manifest)} synthetic {RESUME_H} x {RESUME_W} "
          f"granules killed at stack 3, newest checkpoint truncated, resumed "
          f"with a warning ({second.stacks_done} stacks redone) to "
          f"byte-identical .ychg files", flush=True)

    # the front end over loopback, on the two-kernel engine, at the largest
    # masks its 64 MiB body limit carries (an 8192^2 uint8 mask is 89 MB
    # of base64)
    def crop(mask, res):
        return np.ascontiguousarray(mask[:res, :res])

    def wire_equal(got, want, label):
        check(set(got) == set(want), f"{label}: fields {sorted(got)}")
        for f, w in want.items():
            w = w.cpu().numpy()
            check(got[f].dtype == w.dtype and got[f].shape == w.shape
                  and np.array_equal(got[f], w),
                  f"{label}: field {f} differs from the plain reference")

    fe_config = ServiceConfig(bucket_sides=(FRONTEND_RES, FRONTEND_BIG_RES),
                              max_batch=SERVE_BATCH)
    fe_batch = [crop(m, FRONTEND_RES) for m in serve_masks[:SERVE_BATCH]]
    fe_big = crop(serve_masks[SERVE_BATCH], FRONTEND_BIG_RES)
    fe_ccl = crop(serve_masks[SERVE_BATCH + 1], FRONTEND_RES)
    fe_noisy = [crop(m, FRONTEND_RES) for m in float_masks[:2]]
    with YCHGService(cuda_engine, fe_config) as svc, \
            ServerThread(svc) as srv, \
            YCHGClient("127.0.0.1", srv.port) as client:
        check(client.health()["backend"] == "cuda",
              "the front end's engine does not resolve ychg to cuda")
        t0 = time.perf_counter()
        items = list(client.analyze_batch(fe_batch))
        t_batch = time.perf_counter() - t0
        check(sorted(it.id for it in items) == list(range(SERVE_BATCH))
              and all(it.ok for it in items),
              f"/v1/analyze_batch: {[(it.id, it.error) for it in items]}")
        for it in items:
            wire_equal(it.result, plain_reference("ychg", fe_batch[it.id]),
                       f"/v1/analyze_batch mask {it.id}")
        t0 = time.perf_counter()
        got = client.analyze(fe_big, op="ychg")
        t_big = time.perf_counter() - t0
        wire_equal(got, plain_reference("ychg", fe_big), "/v1/ychg")
        got = client.analyze(fe_ccl, op="ccl")
        want = kccl.labels(torch.from_numpy(fe_ccl).to(DEV)[None])
        wire_equal(got, {"labels": want.labels[0],
                         "n_components": want.n_components[0]}, "/v1/ccl")
        got = client.analyze(fe_noisy[0], op="denoise")
        x = torch.from_numpy(fe_noisy[0]).to(DEV)[None]
        float_err(torch.from_numpy(got["image"]).to(DEV),
                  kdn.denoise_plain(x)[0], "/v1/denoise")
        got = client.pipeline(fe_noisy[1], ["denoise", "ychg"])
        x = torch.from_numpy(fe_noisy[1]).to(DEV)[None]
        ref = ychg.analyze(kdn.denoise_plain(x)[0])
        wire_equal(got, {f: getattr(ref, f) for f in fields}, "/v1/pipeline")
        lat_count = check_metrics_page(client.metrics_text())
    del items, got, want, x, ref
    retry = overload_over_wire(cuda_engine, fe_config, fe_batch[0],
                               fe_batch[1])
    px = SERVE_BATCH * FRONTEND_RES ** 2
    print(f"frontend: loopback HTTP over the cuda engine, every response "
          f"equal to the plain reference: /v1/analyze_batch of "
          f"{SERVE_BATCH} x {FRONTEND_RES}^2 in {t_batch * 1e3:.1f} ms "
          f"({px / t_batch / 1e6:.1f} Mpx/s), /v1/ychg {FRONTEND_BIG_RES}^2 "
          f"in {t_big * 1e3:.1f} ms ({FRONTEND_BIG_RES ** 2 / t_big / 1e6:.1f}"
          f" Mpx/s), /v1/ccl, /v1/denoise and /v1/pipeline at "
          f"{FRONTEND_RES}^2; /metrics parsed ({lat_count:.0f} latency "
          f"observations tie out); a full queue answered 429 with "
          f"Retry-After {retry:.3f} s; on {card}", flush=True)
    free()

    launches = {**kf.LAUNCHES, **kc.LAUNCHES, **kdn.LAUNCHES, **kccl.LAUNCHES,
                **kp.LAUNCHES}
    for name in KERNELS:
        check(launches[name] > 0, f"the main path launched {name} no time")
    calls = {op: {b: registry.call_count(b, op) for b in
                  registry.backend_names(op)} for op in registry.registered_ops()}
    print(f"launches on the main path: {json.dumps(launches)}; backend "
          f"calls: {json.dumps(calls)}", flush=True)

    # 5. for information: one engine call on the device-resident serving
    # batch through each ychg kernel backend, then the paper's comparison:
    # its serial baseline on
    # the host against both card backends on a mask already on the card
    x = torch.from_numpy(stack).to(DEV)
    row = {}
    for name, eng in [("cuda", cuda_engine), ("fused", engine)]:
        eng.analyze_batch(x).block_until_ready()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.analyze_batch(x).block_until_ready()
            times.append(time.perf_counter() - t0)
        row[name] = statistics.median(times) * 1e3
    print(f"engine: one analyze_batch of the {SERVE_BATCH} x {SERVE_RES}^2 "
          f"serving batch on the card: cuda (two kernels, "
          f"{2 * SERVE_BATCH} launches from one host call) "
          f"{row['cuda']:.3f} ms, fused (one "
          f"launch) {row['fused']:.3f} ms (median of 5, host clock); {card}",
          flush=True)
    del x
    serial_engine = Engine(EngineConfig(backend="serial"), device="cpu")
    for res in [r for r in workload_config().resolutions
                if r <= PAPER_MAX_RES] + [SCENE_RES]:
        if res <= SERVE_RES:
            mask, source = crop(serve_masks[0], res), "snowfield"
        elif res <= SCENE_RES:
            mask, source = crop(scene, res), "striped scene"
        else:
            continue
        reps = 3 if res >= 8000 else 5
        row = {}
        outs = {}
        for name, eng, x in [("serial", serial_engine, mask),
                             ("cuda", cuda_engine,
                              torch.from_numpy(mask).to(DEV)),
                             ("fused", engine, torch.from_numpy(mask).to(DEV))]:
            outs[name] = eng.analyze(x).block_until_ready().to_host()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                eng.analyze(x).block_until_ready()
                times.append(time.perf_counter() - t0)
            row[name] = statistics.median(times) * 1e3
        for name in ("cuda", "fused"):
            fields_equal = all(
                outs[name][f].dtype == outs["serial"][f].dtype
                and np.array_equal(outs[name][f], outs["serial"][f])
                for f in fields)
            check(fields_equal, f"paper comparison {res}^2: {name} differs "
                                f"from serial")
        print(f"paper: {res}^2 ({source}): serial {row['serial']:.3f} ms on "
              f"the host, cuda (two kernels) {row['cuda']:.3f} ms, fused "
              f"{row['fused']:.3f} ms on the card (median of {reps}, host "
              f"clock, mask on the device); serial / cuda "
              f"{row['serial'] / row['cuda']:.2f}x; all three equal; {card}",
              flush=True)
        del outs
    free()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        main_row = timings[name][0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "library_note": LIBRARY_NOTES[name],
            "device_ms": main_row.get("device_ms"),
            "entry_point_ms": main_row.get("entry_point_ms"),
            "cases": stats[name]["cases"],
            "exact": name != "denoise" or float_outputs["differing"] == 0,
            "shape": main_row["shape"],
            "timings": timings[name],
        })
        if name == "ychg_diff":
            kernels[-1]["batch_entry"] = batch_entry
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
