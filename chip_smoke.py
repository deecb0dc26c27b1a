#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit (nvcc), and imports nothing of JAX or of the JAX package. Phases,
each of which fails the run (non-zero exit, no result line) when it fails:

  1. the card: name and power limit as nvidia-smi reports them;
  2. the build: every CUDA source of the path (ychg_fused, denoise, ccl),
     one nvcc each, in parallel;
  3. every kernel against its plain PyTorch version on the card, exactly
     (every field, dtype included), except denoise on float inputs, which
     is held to 1 ulp in at most 1 in 10^4 outputs (the differing count is
     printed): ragged widths, H = 1, W = 1, constant, checkerboard and
     serpentine masks, B = 1 and 8, uint8/bool/int32/float32 and the cast
     path, -0.0, NaN and inf, split-H with H not a multiple of block_h, the
     serving batches and the paper's largest scene (21000^2, 4,124,319
     hyperedges) through both yCHG kernels; then each kernel is timed at
     its main shapes, the lone 1 x 8192^2 mask the service flushes among
     them (CUDA events, median of 15 samples of 5 back-to-back calls,
     after a warm-up), beside its plain version, its bound and, for ccl,
     the canonical re-ranking alone;
  4. the main path, with every launch counter set to 0 just before it:
     ``Engine().analyze_batch`` on 8 x 8192^2 uint8 masks for ychg (must
     resolve to ``fused``), ccl and denoise (must resolve to ``cuda``),
     and denoise on float32 copies with 1% impulse pixels, each equal to
     ``backend="torch"``; ``Engine().run_pipeline(["denoise", "ychg"])``
     equal to the two stages run one after the other; the service's cold,
     warm and cached passes of 8 masks each for ychg, ccl and denoise, and
     one pass of 8 float32 masks through ``submit_pipeline`` (every served
     result equal to the plain reference on its raw mask; the cached pass
     dispatches nothing; the device batches and stage seconds of each are
     printed); the overload burst; and the 21000^2 scene through
     ``Engine().analyze`` (full-column kernel), through an engine with
     ``stream_vmem_budget=0`` (the split-H kernel) and as op ``ccl``
     (4,124,319 components). Every kernel must have launched in this
     phase.

It prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
DEV = "cuda"

CSRC = "src/repro_torch/kernels/csrc/"
# kernel -> (CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "ychg_fused_full": (CSRC + "ychg_fused.cu",
                        "src/repro/kernels/ychg_fused.py:91"),
    "ychg_fused_splith": (CSRC + "ychg_fused.cu",
                          "src/repro/kernels/ychg_fused.py:168"),
    "denoise": (CSRC + "denoise.cu", "src/repro/kernels/denoise.py:77"),
    "ccl": (CSRC + "ccl.cu", "src/repro/kernels/ccl.py:127"),
}
YCHG_NOTE = ("no single PyTorch call computes per-column run counts with "
             "their neighbour diff and per-image totals")
LIBRARY_NOTES = {
    "ychg_fused_full": YCHG_NOTE,
    "ychg_fused_splith": YCHG_NOTE,
    "denoise": ("no single PyTorch call computes the filter: a 3x3 "
                "convolution gives the two window sums, not the outlier "
                "test and the select"),
    "ccl": "no PyTorch call computes connected-component labels",
}
IMPULSE_SHARE = 0.01       # impulse pixels in the float32 denoise inputs


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


def time_ms(fn, samples: int = 15, reps: int = 5) -> float:
    """Median over ``samples`` of the CUDA-event time of ``reps`` calls / reps."""
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
    return statistics.median(times)


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
    for shape in [(1, 37, 300), (8, 37, 300), (2, 20, 255), (3, 1, 517),
                  (4, 200, 1), (1, 1, 1), (2, 33, 64)]:
        a = (rng.random(shape) < 0.5) * rng.integers(1, 256, shape)
        cases += dtypes(f"random {shape}", a.astype(np.uint8))
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
    for block_h in (7, 64):
        cases.append((f"split-H ragged H, block_h={block_h}",
                      torch.from_numpy(rand((3, 1000, 513), 0.6)).to(dev),
                      block_h))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one "
              "CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import ychg
    from repro_torch.data import modis
    from repro_torch.engine import Engine, EngineConfig, registry
    from repro_torch.kernels import _build
    from repro_torch.kernels import ccl as kccl
    from repro_torch.kernels import denoise as kdn
    from repro_torch.kernels import ychg_fused as kf
    from repro_torch.launch.serve import (
        derived_masks,
        overload_pass,
        pipeline_pass,
        serve_passes,
    )

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
    sources = ["ychg_fused", "denoise", "ccl"]
    seconds = _build.build(sources)
    print(f"build: {json.dumps(seconds)} in "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    for source in sources:
        log = _build.library_path(source).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas [{source}]: {line.strip()}")

    # host data: two snowfield draws, the rest rolled copies; float32
    # copies of the first batch with impulse pixels; the scene
    t0 = time.perf_counter()
    serve_masks = derived_masks(SERVE_RES, 2 * SERVE_BATCH)
    float_masks = impulse_copies(np, serve_masks[:SERVE_BATCH])
    scene = modis.striped(SCENE_RES, SCENE_HYPEREDGES)
    print(f"host data: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. each kernel against its plain version
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

    for label, x, block_h in kernel_cases(np, torch, modis):
        compare_full(label, x)
        compare_splith(label, x, block_h)
    for label, x, float_input in image_cases(np, torch):
        compare_denoise(label, x, float_input)
        compare_ccl(label, x)
    serve_stack = torch.from_numpy(np.stack(serve_masks[:SERVE_BATCH])).to(DEV)
    float_stack = torch.from_numpy(np.stack(float_masks)).to(DEV)
    scene_stack = torch.from_numpy(scene).to(DEV)[None]
    compare_full("serving batch", serve_stack)
    compare_splith("serving batch", serve_stack, SCENE_BLOCK_H)
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
    sweeps = compare_ccl("21000^2 scene", scene_stack)
    free()
    for name, st in stats.items():
        print(f"exact: {name} equals its plain version on {st['cases']} "
              f"cases", flush=True)
    print(f"float: denoise on float inputs differs from its plain version in "
          f"{float_outputs['differing']} of {float_outputs['outputs']} "
          f"outputs (bound: 1 ulp, 1 in 10^4); max abs err "
          f"{stats['denoise']['max_abs_err']}", flush=True)

    timings = {}
    for name, x, run, plain, bound_fn, plain_samples in [
            ("ychg_fused_full", serve_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain, bound, 10),
            # the service flushes a lone mask as a batch of 1 when the
            # submitting thread's content hash outlasts the delay window
            ("ychg_fused_full", serve_stack[:1],
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain, bound, 10),
            ("ychg_fused_full", scene_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain, bound, 10),
            ("ychg_fused_splith", scene_stack,
             lambda x: kf.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, SCENE_BLOCK_H), bound,
             10),
            ("ychg_fused_splith", serve_stack,
             lambda x: kf.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, SCENE_BLOCK_H), bound,
             10),
            ("denoise", serve_stack, kdn.launch, kdn.denoise_plain,
             bound_denoise, 5),
            ("denoise", float_stack, kdn.launch, kdn.denoise_plain,
             bound_denoise, 5),
            ("denoise", serve_stack[:1], kdn.launch, kdn.denoise_plain,
             bound_denoise, 5),
            ("ccl", serve_stack, kccl.launch, kccl.ccl_fixpoint_plain,
             bound_ccl, 3),
            ("ccl", serve_stack[:1], kccl.launch, kccl.ccl_fixpoint_plain,
             bound_ccl, 3)]:
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
            del fg, raw
            extra = (f"; canonicalize {row['canonicalize_ms']:.4f} ms, "
                     f"whole op {row['op_ms']:.4f} ms")
        timings.setdefault(name, []).append(row)
        print(f"time: {name} {row['shape']} {row['dtype']}: "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms by {b_by} ({b_bytes} B), "
              f"{100 * row['bound_share']:.1f}% of bound{extra}) on {card}",
              flush=True)
        free()
    del serve_stack, float_stack, scene_stack
    free()

    # 4. the main path, counted from zero
    for module in (kf, kdn, kccl):
        module.reset_launch_counts()
    registry.reset_call_counts()
    engine = Engine()
    torch_engine = Engine(EngineConfig(backend="torch"))
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
    fields = ("runs", "cut_vertices", "transitions", "births", "deaths",
              "n_hyperedges", "n_transitions")
    max_abs_err({f: getattr(got, f) for f in fields},
                {f: getattr(want, f) for f in fields},
                "Engine fused vs torch, 8 x 8192^2")
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
          f"{SERVE_BATCH} x {SERVE_RES}^2 equal to backend='torch' for ychg, "
          f"ccl and denoise (uint8 masks and float32 with impulses)",
          flush=True)
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

    serve_backend = {"ychg": "fused", "ccl": "cuda", "denoise": "cuda"}
    for op in ("ychg", "ccl", "denoise"):
        report = serve_passes(Engine(), serve_masks[:SERVE_BATCH],
                              serve_masks[SERVE_BATCH:], op=op)
        check(report.backend == serve_backend[op],
              f"{op} service backend {report.backend!r}")
        served = 0
        for outs, masks in [(report.cold, serve_masks[:SERVE_BATCH]),
                            (report.warm, serve_masks[SERVE_BATCH:]),
                            (report.cached, serve_masks[:SERVE_BATCH])]:
            for res, mask in zip(outs, masks):
                max_abs_err(served_fields(op, res), plain_reference(op, mask),
                            f"served {op} result {served}")
                served += 1
        check(report.cached_batches == 0,
              f"{op}: cached pass dispatched {report.cached_batches} batches")
        check(report.cached_hit_rate == 1.0,
              f"{op}: cached pass hit rate {report.cached_hit_rate}")
        m = report.metrics
        print(f"serve {op}: {served} served results equal the plain "
              f"reference; cold {report.t_cold * 1e3:.1f} ms, warm "
              f"{report.t_warm * 1e3:.1f} ms ({report.warm_mpx_s:.0f} "
              f"Mpx/s), cached {report.t_cached * 1e3:.1f} ms; p50 "
              f"{m.p50_latency_ms:.1f} ms p95 {m.p95_latency_ms:.1f} ms over "
              f"{m.completed} requests on {card}", flush=True)
        print(f"serve {op}: device batches per pass of {SERVE_BATCH} masks: "
              + json.dumps(report.batches), flush=True)
        print(f"serve {op}: warm pass by stage (s, summed over its "
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

    for label, eng in [("full-column", Engine()),
                       ("split-H", Engine(EngineConfig(stream_vmem_budget=0)))]:
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

    launches = {**kf.LAUNCHES, **kdn.LAUNCHES, **kccl.LAUNCHES}
    for name in KERNELS:
        check(launches[name] > 0, f"the main path launched {name} no time")
    calls = {op: {b: registry.call_count(b, op) for b in
                  registry.backend_names(op)} for op in registry.registered_ops()}
    print(f"launches on the main path: {json.dumps(launches)}; backend "
          f"calls: {json.dumps(calls)}", flush=True)

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
            "cases": stats[name]["cases"],
            "exact": name != "denoise" or float_outputs["differing"] == 0,
            "shape": main_row["shape"],
            "timings": timings[name],
        })
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
