#!/usr/bin/env python3
"""Time host-to-card copies on one CUDA card: the host link's yardstick,
and the design and chunk of ``repro_torch.engine.engine.PinnedStager``.

    python3 scripts/time_h2d.py [--samples 12] [--threads 1,8]
        [--sizes mask8192,stack21000] [--methods M,...] [--switch-ms MS]
        [--out FILE]

Sizes: one 8192^2 uint8 mask (67,108,864 B, a serving request) and one
4 x 2048 x 21000 uint8 stack (172,032,000 B, a scene stack). Methods, each
the whole copy as a caller sees it, from the start of the copy to the end
of a synchronisation of the copying thread's stream:

  * ``pageable``: ``host_tensor(a).to(device)``, from pageable memory;
  * ``pinned``: ``copy_(non_blocking=True)`` from a buffer page-locked
    beforehand (the DMA alone: the host link's rate);
  * ``whole``: one ``np.copyto`` of the mask into one page-locked buffer of
    its size, then one such ``copy_``;
  * ``staged_<n>MiB``: ``PinnedStager().to_device(a, device)`` with
    ``STAGE_CHUNK_BYTES`` set to n MiB, the copy the service makes (one
    page-locked slot, each piece waited for before the next);
  * the plan as a loop in Python, piece by piece into two page-locked
    slots: ``loop_<n>MiB`` (``np.copyto``, then torch's
    ``copy_(non_blocking=True)``, an event recorded, and waited on before
    the slot is refilled), ``host_<n>MiB`` (the host copies alone),
    ``raw_<n>MiB`` (``cudaMemcpyAsync`` through ctypes in place of torch's
    ``copy_``), ``torchhost_<n>MiB`` (torch's ``copy_``, its intra-op
    threads, for the host copy) and ``blocking_<n>MiB`` (events whose wait
    sleeps instead of spinning).

Each method runs from 1 thread and from 8 at once (``--threads``), each
thread with its own source array, CUDA stream and slots. Reported for
each: the median and quartiles of one copy's time (ms) over the threads'
samples, and the bytes all threads moved over the wall time (GB/s); for
the ``pinned`` copy from one thread, its device time by CUDA events. One
JSON line a case, and one with the card's name, power limit, torch's
version and the interpreter's switch interval first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"mask8192": 8192 * 8192, "stack21000": 4 * 2048 * 21000}
CHUNKS_MIB = (1, 2, 4, 8, 16, 64)


def quartiles(times: list) -> dict:
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2]}


def card_line(torch) -> dict:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi: {e}"
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "host_cores": os.cpu_count()}


def cudart():
    """The CUDA runtime library torch loaded, through ctypes (whose calls
    release the interpreter's lock)."""
    import ctypes

    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "libcudart" in line}
    lib = ctypes.CDLL(sorted(paths)[0])
    lib.cudaMemcpyAsync.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.cudaMemcpyAsync.restype = ctypes.c_int
    return lib


def python_loop(torch, np, kind, a, device, chunk):
    """The staged copy's plan as a loop in Python, in the variant ``kind``
    names (the module docstring's ``loop``, ``host``, ``raw``,
    ``torchhost`` and ``blocking``)."""
    from repro_torch.engine.engine import chunk_plan, pinned_buffer

    slots = [pinned_buffer(chunk) for _ in range(2)]
    events = [torch.cuda.Event(blocking=kind == "blocking")
              for _ in range(2)]
    lib = cudart() if kind == "raw" else None
    src = a.reshape(-1)

    def loop():
        out = torch.empty(a.size, dtype=torch.uint8, device=device)
        stream = (torch.cuda.current_stream(device).cuda_stream if lib
                  else None)
        for k, (i, j) in enumerate(chunk_plan(src.size, chunk)):
            slot = slots[k % 2][:j - i]
            if kind != "host":
                events[k % 2].synchronize()
            if kind == "torchhost":
                slot.copy_(torch.from_numpy(src[i:j]))
            else:
                np.copyto(slot.numpy(), src[i:j])
            if kind == "host":
                continue
            if kind == "raw":
                err = lib.cudaMemcpyAsync(out.data_ptr() + i,
                                          slot.data_ptr(), j - i, 1, stream)
                if err:
                    raise RuntimeError(f"cudaMemcpyAsync: error {err}")
            else:
                out[i:j].copy_(slot, non_blocking=True)
            events[k % 2].record()
        return out
    return loop


def make_copy(torch, np, method, a, device):
    """A function of no argument that makes one copy of ``a`` onto
    ``device`` on the current stream."""
    from repro_torch.engine import engine
    from repro_torch.engine.engine import host_tensor, pinned_buffer

    if method == "pageable":
        return lambda: host_tensor(a).to(device)
    if method in ("pinned", "whole"):
        buf = pinned_buffer(a.size)
        buf.numpy()[:] = a.reshape(-1)

        def one_piece():
            if method == "whole":
                np.copyto(buf.numpy(), a.reshape(-1))
            out = torch.empty(a.size, dtype=torch.uint8, device=device)
            out.copy_(buf, non_blocking=True)
            return out
        return one_piece
    kind, mib = method[:-len("MiB")].split("_")
    chunk = int(mib) << 20
    if kind == "staged":
        engine.STAGE_CHUNK_BYTES = chunk   # read when a stager is made
        stager = engine.PinnedStager()
        return lambda: stager.to_device(a, device)
    return python_loop(torch, np, kind, a, device, chunk)


def run_case(torch, np, method, nbytes, threads, samples, device):
    barrier = threading.Barrier(threads + 1)
    times = [[] for _ in range(threads)]
    starts, ends = [0.0] * threads, [0.0] * threads
    errors = []

    def worker(t):
        try:
            rng = np.random.default_rng(1000 * t + nbytes % 997)
            a = rng.integers(0, 256, nbytes, dtype=np.uint8)
            stream = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                copy = make_copy(torch, np, method, a, device)
                for _ in range(2):   # allocations, first touch
                    out = copy()
                    stream.synchronize()
                if t == 0 and not method.startswith("host"):   # exact
                    if not torch.equal(out.reshape(-1).cpu(),
                                       torch.from_numpy(a)):
                        raise AssertionError(f"{method}: bytes differ")
                del out
                barrier.wait()
                starts[t] = time.perf_counter()
                for _ in range(samples):
                    t0 = time.perf_counter()
                    copy()
                    stream.synchronize()
                    times[t].append((time.perf_counter() - t0) * 1e3)
                ends[t] = time.perf_counter()
        except BaseException as e:   # reported, and the barrier let go
            errors.append(repr(e))
            barrier.abort()

    workers = [threading.Thread(target=worker, args=(t,))
               for t in range(threads)]
    for w in workers:
        w.start()
    try:
        barrier.wait()
    except threading.BrokenBarrierError:
        pass
    for w in workers:
        w.join()
    if errors:
        raise RuntimeError(f"{method} x{threads}: {errors[0]}")
    wall = max(ends) - min(starts)
    flat = [x for ts in times for x in ts]
    line = {"method": method, "bytes": nbytes, "threads": threads,
            "samples": len(flat), "copy_ms": quartiles(flat),
            "gb_per_s": threads * samples * nbytes / wall / 1e9}
    if method == "pinned" and threads == 1:
        line["device_ms"] = pinned_device_ms(torch, np, nbytes, device)
    return line


def pinned_device_ms(torch, np, nbytes, device, n=10):
    """The mean device time of one page-locked copy, by CUDA events."""
    from repro_torch.engine.engine import pinned_buffer

    src = pinned_buffer(nbytes)
    out = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out.copy_(src, non_blocking=True)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    e0.record()
    for _ in range(n):
        out.copy_(src, non_blocking=True)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--samples", type=int, default=12)
    p.add_argument("--threads", default="1,8")
    p.add_argument("--sizes", default=",".join(SIZES))
    p.add_argument("--methods", default=None,
                   help="comma-separated, as the module docstring names "
                        "them")
    p.add_argument("--switch-ms", type=float, default=None,
                   help="the interpreter's thread switch interval")
    p.add_argument("--out", default=None,
                   help="also write the JSON lines to this file")
    args = p.parse_args(argv)
    if args.switch_ms is not None:
        sys.setswitchinterval(args.switch_ms / 1e3)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_h2d: no CUDA card visible", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    methods = (args.methods.split(",") if args.methods else
               ["pageable", "pinned", "whole"]
               + [f"staged_{m}MiB" for m in CHUNKS_MIB]
               + ["loop_4MiB", "loop_16MiB"])
    lines = [{**card_line(torch), "switch_s": sys.getswitchinterval()}]
    print(json.dumps(lines[0]), flush=True)
    for name in args.sizes.split(","):
        nbytes = SIZES[name]
        for threads in (int(t) for t in args.threads.split(",")):
            for method in methods:
                line = {"size": name, **run_case(
                    torch, np, method, nbytes, threads, args.samples,
                    device)}
                lines.append(line)
                print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
