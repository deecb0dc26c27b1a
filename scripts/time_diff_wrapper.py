#!/usr/bin/env python3
"""Time the standalone ychg_diff kernel through its wrapper
(``repro_torch.kernels.ychg_colscan.launch_diff``) and as its C entry point,
on one CUDA card, for the checkout whose ``src`` directory is given.

    python3 scripts/time_diff_wrapper.py [--src DIR] [--width 8192]
        [--samples 101] [--reps 10]

The wrapper is host-bound: its time moves with the host's load, so only
times taken on one machine within minutes of each other compare. To
compare two checkouts, run this for each in turns (A, B, B, A) in one
command on one machine. It
builds the checkout's ``ychg_colscan`` library if needed and prints one JSON
line: the checkout, the card's name and power limit, and for the wrapper and
the C entry point the median and quartiles (ms) of ``samples`` CUDA-event
times of ``reps`` back-to-back calls each.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def samples_ms(fn, samples: int, reps: int) -> dict:
    import torch

    for _ in range(20):
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
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "src")
    ap.add_argument("--src", default=here)
    ap.add_argument("--width", type=int, default=8192)
    ap.add_argument("--samples", type=int, default=101)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_diff_wrapper: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import ychg_colscan as kc

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    rng = np.random.default_rng(20130611)
    runs = torch.from_numpy(
        rng.integers(0, 50, args.width).astype(np.int32)).cuda()
    out = kc.launch_diff(runs)
    want = kc.diff_plain(runs)
    for k, v in want.items():
        if not torch.equal(out[k], v):
            print(f"time_diff_wrapper: {k} differs from the plain version",
                  file=sys.stderr)
            return 1
    lib = _build.load("ychg_colscan", kc._SIGNATURES)
    ptrs = [out[k].data_ptr() for k in ("transitions", "births", "deaths")]
    stream = torch.cuda.current_stream().cuda_stream
    print(json.dumps({
        "src": args.src, "card": card, "width": args.width,
        "samples": args.samples, "reps": args.reps,
        "wrapper_ms": samples_ms(lambda: kc.launch_diff(runs), args.samples,
                                 args.reps),
        "entry_point_ms": samples_ms(
            lambda: lib.ychg_diff(runs.data_ptr(), args.width, *ptrs, stream),
            args.samples, args.reps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
