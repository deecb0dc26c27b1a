#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit (nvcc), and imports nothing of JAX or of the JAX package. Phases,
each of which fails the run (non-zero exit, no result line) when it fails:

  1. the card: name and power limit as nvidia-smi reports them;
  2. the build: every CUDA source of the path, one nvcc each, in parallel;
  3. every kernel against its plain PyTorch version on the card, exactly
     (every field, dtype included): ragged widths, H = 1, W = 1, constant
     and checkerboard masks, B = 1 and 8, uint8/bool/int32/float32 and the
     cast path, split-H with H not a multiple of block_h, and the paper's
     largest scene (21000^2, 4,124,319 hyperedges) through both kernels;
     then each kernel is timed at its main shapes, the lone 1 x 8192^2
     mask the service flushes among them (CUDA events, median of 15
     samples of 5 back-to-back calls, after a warm-up);
  4. the main path, with every launch counter set to 0 just before it:
     ``Engine().analyze_batch`` on 8 x 8192^2 uint8 masks (must resolve to
     ``fused`` and equal ``backend="torch"``), the service's cold, warm and
     cached passes of 8 masks each (every served result equal to the plain
     reference on its raw mask; the cached pass dispatches nothing; the
     device batches of each pass are printed), the
     overload burst, and the 21000^2 scene through ``Engine().analyze``
     (full-column kernel) and through an engine with
     ``stream_vmem_budget=0`` (the split-H kernel). Every kernel must have
     launched in this phase.

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

# NVIDIA H100 SXM data sheet: HBM3 rate, and the simple int32 rate: 64 INT32
# lanes per SM x 132 SMs x 1.98 GHz boost (the 67 TFLOP/s float32 figure
# counts an FMA as two operations, so it is not twice this).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_PIXEL = 3          # compare, and-not, add

SERVE_RES, SERVE_BATCH = 8192, 8
SCENE_RES, SCENE_HYPEREDGES = 21000, 4_124_319
SCENE_BLOCK_H = 2048       # EngineConfig.block_h default
DEV = "cuda"

CUDA_SOURCE = "src/repro_torch/kernels/csrc/ychg_fused.cu"
REPLACES = {
    "ychg_fused_full": "src/repro/kernels/ychg_fused.py:91",
    "ychg_fused_splith": "src/repro/kernels/ychg_fused.py:168",
}
LIBRARY_NOTE = ("no single PyTorch call computes per-column run counts with "
                "their neighbour diff and per-image totals")


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


def bound(x) -> tuple[float, str]:
    """Least time (ms) the card needs for one call on ``x`` (B, H, W): each
    input byte read once, each output byte written once, against the
    integer work per pixel."""
    b, _, w = x.shape
    nbytes = x.numel() * x.element_size() + b * w * (3 * 4 + 1) + b * 2 * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = OPS_PER_PIXEL * x.numel() / PEAK_INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    from repro_torch.kernels import ychg_fused as kf
    from repro_torch.launch.serve import derived_masks, overload_pass, serve_passes

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 1. the card
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {count} visible)", flush=True)

    # 2. the build
    t0 = time.perf_counter()
    seconds = _build.build(["ychg_fused"])
    print(f"build: {json.dumps(seconds)} in "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    log = _build.library_path("ychg_fused").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # host data: two snowfield draws, the rest rolled copies; the scene
    t0 = time.perf_counter()
    serve_masks = derived_masks(SERVE_RES, 2 * SERVE_BATCH)
    scene = modis.striped(SCENE_RES, SCENE_HYPEREDGES)
    print(f"host data: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. each kernel against its plain version
    stats = {name: {"cases": 0, "max_abs_err": 0} for name in REPLACES}

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

    for label, x, block_h in kernel_cases(np, torch, modis):
        compare_full(label, x)
        compare_splith(label, x, block_h)
    serve_stack = torch.from_numpy(np.stack(serve_masks[:SERVE_BATCH])).to(DEV)
    scene_stack = torch.from_numpy(scene).to(DEV)[None]
    compare_full("serving batch", serve_stack)
    compare_splith("serving batch", serve_stack, SCENE_BLOCK_H)
    for name, out in [
            ("ychg_fused_full", kf.launch_full(scene_stack)),
            ("ychg_fused_splith",
             kf.launch_splith(scene_stack, block_h=SCENE_BLOCK_H))]:
        got = int(out["n_hyperedges"][0])
        check(got == SCENE_HYPEREDGES,
              f"{name}: scene gives {got} hyperedges, want {SCENE_HYPEREDGES}")
    compare_full("21000^2 scene", scene_stack)
    compare_splith("21000^2 scene", scene_stack, SCENE_BLOCK_H)
    torch.cuda.synchronize()
    for name, st in stats.items():
        print(f"exact: {name} equals its plain version on {st['cases']} "
              f"cases", flush=True)

    timings = {}
    for name, x, run, plain in [
            ("ychg_fused_full", serve_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain),
            # the service flushes a lone mask as a batch of 1 when the
            # submitting thread's content hash outlasts the delay window
            ("ychg_fused_full", serve_stack[:1],
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain),
            ("ychg_fused_full", scene_stack,
             lambda x: kf.launch_full(x), kf.ychg_fused_full_plain),
            ("ychg_fused_splith", scene_stack,
             lambda x: kf.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, SCENE_BLOCK_H)),
            ("ychg_fused_splith", serve_stack,
             lambda x: kf.launch_splith(x, block_h=SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, SCENE_BLOCK_H))]:
        b_ms, b_by = bound(x)
        row = {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
               "ms": time_ms(lambda: run(x)),
               "plain_ms": time_ms(lambda: plain(x), samples=10, reps=1),
               "bound_ms": b_ms, "bound_by": b_by}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        timings.setdefault(name, []).append(row)
        print(f"time: {name} {row['shape']} {row['dtype']}: "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms by {b_by}, "
              f"{100 * row['bound_share']:.1f}% of bound) on {card}",
              flush=True)
    del serve_stack, scene_stack

    # 4. the main path, counted from zero
    kf.reset_launch_counts()
    registry.reset_call_counts()
    engine = Engine()
    check(engine.resolve_backend() == "fused",
          f"Engine() resolves to {engine.resolve_backend()!r}, want 'fused'")
    stack = np.stack(serve_masks[:SERVE_BATCH])
    got = engine.analyze_batch(stack).block_until_ready()
    check(kf.LAUNCHES["ychg_fused_full"] > 0,
          "Engine().analyze_batch launched no ychg_fused_full kernel")
    want = Engine(EngineConfig(backend="torch")).analyze_batch(stack)
    fields = ("runs", "cut_vertices", "transitions", "births", "deaths",
              "n_hyperedges", "n_transitions")
    max_abs_err({f: getattr(got, f) for f in fields},
                {f: getattr(want, f) for f in fields},
                "Engine fused vs torch, 8 x 8192^2")
    print(f"main path: Engine() -> fused, {SERVE_BATCH} x {SERVE_RES}^2 equal "
          f"to backend='torch'", flush=True)

    report = serve_passes(Engine(), serve_masks[:SERVE_BATCH],
                          serve_masks[SERVE_BATCH:])
    check(report.backend == "fused", f"service backend {report.backend!r}")
    served = 0
    for outs, masks in [(report.cold, serve_masks[:SERVE_BATCH]),
                        (report.warm, serve_masks[SERVE_BATCH:]),
                        (report.cached, serve_masks[:SERVE_BATCH])]:
        for res, mask in zip(outs, masks):
            ref = ychg.analyze(torch.from_numpy(mask).to(DEV))
            s = res.to_summary()
            max_abs_err({f: getattr(s, f) for f in fields},
                        {f: getattr(ref, f) for f in fields},
                        f"served result {served}")
            served += 1
    check(report.cached_batches == 0,
          f"cached pass dispatched {report.cached_batches} batches")
    check(report.cached_hit_rate == 1.0,
          f"cached pass hit rate {report.cached_hit_rate}")
    m = report.metrics
    print(f"serve: {served} served results equal the plain reference; cold "
          f"{report.t_cold * 1e3:.1f} ms, warm {report.t_warm * 1e3:.1f} ms "
          f"({report.warm_mpx_s:.0f} Mpx/s), cached "
          f"{report.t_cached * 1e3:.1f} ms; p50 "
          f"{m.p50_latency_ms:.1f} ms p95 {m.p95_latency_ms:.1f} ms over "
          f"{m.completed} requests on {card}", flush=True)
    print(f"serve: device batches per pass of {SERVE_BATCH} masks: "
          + json.dumps(report.batches), flush=True)
    print("serve: warm pass by stage (s, summed over its requests): "
          + json.dumps(report.warm_stage_s), flush=True)

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

    launches = dict(kf.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"the main path launched {name} no time")
    print(f"launches on the main path: {json.dumps(launches)}; backend "
          f"calls: fused {registry.call_count('fused')}", flush=True)

    kernels = []
    for name in REPLACES:
        main_row = timings[name][0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": CUDA_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "library_note": LIBRARY_NOTE,
            "cases": stats[name]["cases"],
            "exact": True,
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
