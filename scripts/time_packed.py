#!/usr/bin/env python3
"""Time the packed yCHG kernels of one checkout on one CUDA card: through
their wrappers (``repro_torch.kernels.ychg_packed.launch_colscan`` and
``launch_fused``), as their C entry points, and on the device; and the
unpacked scan kernels through their wrappers beside them.

    python3 scripts/time_packed.py [--src DIR] [--samples 51]

Inputs: the paper's 21000^2 scene (``modis.striped``) and its top-left
8192^2 crop, packed on the card by the checkout's ``pack_rows``; eight
crops of the scene at different offsets stand in for the 8 x 8192^2
serving batch. Every kernel is first held to its plain version on these
inputs. Reported for each packed kernel and shape: the wrapper's and the
C entry point's median and quartiles (ms) of ``samples`` CUDA-event times
of 10 back-to-back calls, and the mean device time of one launch from a
torch.profiler trace of 20 calls (which must see all 20 launches). For
``ychg_fused_full`` (serving batch, scene), ``ychg_fused_splith`` (scene,
block_h 2048) and ``ychg_colscan_full`` (8192^2 crop, scene): the
wrapper's median and quartiles; and, the same way, ``torch.zeros`` of the
fused outputs' bytes and ``core.ychg.zeroed_outputs`` of its seven fields
at W = 8192 (the fused wrapper's host work). With ``cuobjdump`` on the
path or in ``$CUDA_HOME/bin``, a digest of each library's machine code,
kernel by kernel (names up to the anonymous namespace's tag, which
differs between checkouts), so that two checkouts' builds of an unchanged
kernel can be shown identical.

Wrapper times move with the host's load, so only times taken on one
machine within minutes compare. To compare two checkouts, run this for
each in turns (A, B, B, A) in one command on one machine: unpack the other
checkout into ``build/parent/`` with ``git archive`` and pass ``--src
build/parent/src``. It prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def quartiles(times: list) -> dict:
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2]}


def sass_digests(lib: str) -> dict:
    """Kernel name -> digest of its SASS, or {} without cuobjdump."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    code: dict = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__", m.group(1))
            code[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
        if m and name:
            code[name].append(m.group(1))
    return {n: hashlib.sha256("\n".join(c).encode()).hexdigest()[:16]
            for n, c in sorted(code.items())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--samples", type=int, default=51)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this checkout's timing helpers and bounds

    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("time_packed: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import ychg
    from repro_torch.data import modis
    from repro_torch.kernels import _build
    from repro_torch.kernels import ychg_colscan as kc
    from repro_torch.kernels import ychg_fused as kf
    from repro_torch.kernels import ychg_packed as kp

    def same(got, want, label):
        for k, v in want.items():
            g = got[k] if isinstance(got, dict) else got
            cs.check(g.dtype == v.dtype and torch.equal(g, v),
                     f"{label}: {k} differs from the plain version")

    def event_samples(fn, reps=10):
        return quartiles(cs.time_samples(fn, args.samples, reps))

    _build.build(["ychg_packed", "ychg_fused", "ychg_colscan"])
    scene_np = modis.striped(cs.SCENE_RES, cs.SCENE_HYPEREDGES)
    scene = torch.from_numpy(scene_np).cuda()
    lone = scene[:cs.SERVE_RES, :cs.SERVE_RES].contiguous()
    step = (cs.SCENE_RES - cs.SERVE_RES) // cs.SERVE_BATCH
    batch = torch.stack([scene[i * step:i * step + cs.SERVE_RES,
                               (7 - i) * step:(7 - i) * step + cs.SERVE_RES]
                         for i in range(cs.SERVE_BATCH)]).contiguous()
    lib = _build.load("ychg_packed", kp._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"src": args.src, "card": cs.card_line(),
              "samples": args.samples, "packed": [], "unpacked": []}
    shapes = {"scene": kp.pack_rows(scene), "lone 8192^2": kp.pack_rows(lone)}
    for kernel, run, plain, bound_fn in [
            ("ychg_packed_colscan", kp.launch_colscan,
             lambda p: {"runs": kp.packed_colscan_plain(p)},
             cs.bound_packed_colscan),
            ("ychg_packed_fused", kp.launch_fused, kp.packed_fused_plain,
             cs.bound_packed_fused)]:
        traced = (kernel.replace("ychg_", "") + "_kernel",)
        for label, p in shapes.items():
            want = plain(p)
            same(run(p), want, f"{kernel} [{label}]")
            out = run(p)
            ptrs = ([out[k].data_ptr() for k in kp._FUSED_OUT]
                    if isinstance(out, dict) else [out.data_ptr()])
            entry = getattr(lib, kernel)
            device_ms, seen = cs.kernel_device_ms(lambda: run(p), traced)
            cs.check(seen == 20, f"{kernel} [{label}]: the trace saw {seen} "
                     "launches, want 20")
            row = {"kernel": kernel, "shape": list(p.shape), "input": label,
                   "bound_ms": bound_fn(p)[0], "device_ms": device_ms,
                   "launches_seen": seen,
                   "wrapper_ms": event_samples(lambda: run(p)),
                   "entry_point_ms": event_samples(
                       lambda: entry(p.data_ptr(), *p.shape, *ptrs, stream))}
            result["packed"].append(row)
            del out
    # what the fused wrapper's host time goes to: its outputs' zeroed
    # buffer alone, and cut into the seven fields
    w = shapes["lone 8192^2"].shape[1]
    dev = scene.device
    result["host"] = {
        "zeros_ms": event_samples(lambda: torch.zeros(
            17 * w + 8, dtype=torch.uint8, device=dev)),
        "zeroed_outputs_b1_ms": event_samples(
            lambda: ychg.zeroed_outputs(kp._FUSED_OUT, 1, w, dev))}
    for kernel, x, run, plain in [
            ("ychg_fused_full", batch, kf.launch_full,
             kf.ychg_fused_full_plain),
            ("ychg_fused_full", scene[None], kf.launch_full,
             kf.ychg_fused_full_plain),
            ("ychg_fused_splith", scene[None],
             lambda x: kf.launch_splith(x, block_h=cs.SCENE_BLOCK_H),
             lambda x: kf.ychg_fused_splith_plain(x, cs.SCENE_BLOCK_H)),
            ("ychg_colscan_full", lone, kc.launch_full,
             lambda x: {"runs": kc.colscan_full_plain(x)}),
            ("ychg_colscan_full", scene, kc.launch_full,
             lambda x: {"runs": kc.colscan_full_plain(x)})]:
        same(run(x), plain(x), f"{kernel} {list(x.shape)}")
        result["unpacked"].append({
            "kernel": kernel, "shape": list(x.shape),
            "wrapper_ms": event_samples(lambda: run(x), reps=5)})
    result["sass"] = {name: sass_digests(str(_build.library_path(name)))
                      for name in ("ychg_fused", "ychg_colscan",
                                   "ychg_packed")}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
