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
     Retry-After at a full queue; last ``launch.serve --op-smoke`` at
     2048^2 on the card (every op over ``/v1/{op}`` bit-identical to its
     reference, ``/v1/pipeline`` denoise -> ychg equal to its stages sent
     apart, an unknown op answered 404 naming the registry, one dispatch
     series an op on ``/metrics``). Every kernel must have launched in this
     phase;
  5. the engine's batch mesh and the worker fleet, every launch counter
     set to 0 just before it: the serving batch through
     ``Engine().with_mesh(make_batch_mesh())``, through a mesh naming the
     card three times on its first five masks (padded to six, the pad
     stripped) and through the meshed engine ``with_config(
     stream_vmem_budget=0)`` (ychg on ``ychg_fused_splith``), for ychg,
     ccl and denoise, each equal to the unmeshed ``Engine()`` (every
     field, dtype included) with its kernel's launch counter moving
     (host-clock ms beside the unmeshed call); then two worker processes
     (``python -m repro_torch.fleet.worker``) on the card behind a
     ``FleetRouter``: 8 x 2048^2 masks through ``/v1/analyze_batch``, one
     4096^2 mask through ``/v1/ychg``, ``/v1/ccl``, ``/v1/denoise`` and
     ``/v1/pipeline`` at 2048^2, each byte-identical to an in-process
     ``Service(Engine())``; both workers served; the rolled-up
     ``/metrics`` shows dispatches to ``fused`` (ychg) and ``cuda`` (ccl,
     denoise); wire ms and Mpx/s through the router beside the direct
     front end on fresh masks; the owner of one mask killed, its repeat
     rerouted (``ychg_fleet_rerouted_total`` >= 1), the slot restarted
     and the repeat served from the survivor's cache
     (``ychg_cache_peer_hits_total`` >= 1), both byte-identical; spawn
     and restart seconds; last the SLO legs (priority, deadline and
     quota) of ``launch.serve.slo_smoke`` on the card;
  6. the paper's comparison, for information: its serial NumPy baseline
     on the host against the ``cuda`` and ``fused`` backends on the card,
     at each resolution of the workload up to 12000^2 and the 21000^2
     scene, all three equal;
  7. ``Engine.lower``, the dry run, the data pipeline and the examples,
     every launch counter set to 0 just before: eleven cells (the serving
     batch for ychg on ``fused``, ``cuda`` and ``torch``, for ccl and
     denoise on ``cuda`` and ``torch``; the scene and the tall strip for
     ychg on ``fused`` and ``cuda``) lowered and compiled, first with
     their sources built by nvcc into an empty directory, then cached,
     ``torch.cuda.memory_allocated()`` the same before and after each;
     each cell run once, its launches equal to the lowering's, every
     field's shape and dtype equal to ``out_info``, and for the ychg
     kernel routes and denoise on ``cuda`` the peak above the stack
     between the output's bytes and the reckoning (the bytes requested
     exactly; the blocks held with each tensor rounded up to 512 B and
     the caching allocator's unsplit remainder of a block above 1 MiB);
     ``launch.dryrun.run_ychg_cells`` up to 21000^2 at B = 8, every cell
     ok and nothing allocated; an 8192^2 snowfield in 512^2 tiles through
     ``Prefetcher``, ``ychg_stats`` on the fused engine and
     ``filter_empty_tiles``, one ``ychg_fused_full`` launch a batch and
     the stats equal to the ``torch`` engine's, and ``anyres_select``
     equal too; the five examples (``python -m
     repro_torch.examples.<name>``) run together, each exiting 0;
  8. LM serving, every launch counter set to 0 just before (the LM path
     launches none of the nine kernels, and the phase fails if it does),
     TF32 off: qwen2-0.5b at full width and minicpm3-4b (MLA) at full width
     and two layers, both in float32 with weights from a seeded generator on
     the card and the same tensors copied to the CPU: ``forward`` on a
     seeded 2 x 64 prompt on the card against the CPU, ``decode_step`` over
     the 64 positions on the card against ``forward``, and the greedy
     tokens of ``ServeEngine.generate`` for 16 steps on the card against
     the CPU (a step may differ only where the CPU's top-2 logit gap is
     under the bound, printed), all within 1e-3 of max|logit|; the same
     for rwkv6-3b at full width and two layers; phi3.5-moe-42b-a6.6b at
     full width and two layers, forward card against CPU at its own
     capacity factor (experts recorded on both sides: a token whose
     experts differ before any earlier difference must have a CPU router
     gap under 1e-4, and only the tokens before the first difference are
     compared) and decode against forward on the card at capacity factor
     E (dropless); jamba-v0.1-52b at full width and one period (8 layers:
     Mamba, attention, MoE) in float32 on the card alone (53 GB), decode
     against forward at capacity factor E, then in bfloat16 through
     ``ServeEngine.generate`` twice to equal greedy tokens; qwen2-0.5b
     with int8 weights (float32 activations), ``decode_step`` over a
     prompt card against CPU and greedy tokens equal; then
     qwen2-0.5b and rwkv6-3b (full depth) at their own dtypes (bfloat16):
     ``ServeEngine.generate``,
     batch 8, prompt 128, 64 new tokens, greedy, after a warm-up run twice
     to equal tokens, with prefill ms (CUDA events, median of 5) and
     decode ms a step (CUDA events, median of the 64 steps), tokens/s and
     ``max_memory_allocated`` beside the decode step's bound (parameter
     bytes plus the cache or state bytes a step reads, over 3.35 TB/s) and the
     prefill's (two operations a parameter a token over the bfloat16
     peak); last ``python -m repro_torch.launch.serve
     --workload lm --arch qwen2-0.5b --batch 4 --prompt 32 --max-new 32``
     (the full config) and the ``serve_lm`` example, run together, each
     exiting 0;
  9. training, every launch counter set to 0 just before (training
     launches none of the nine kernels), TF32 off: qwen2-0.5b at full
     width and two layers in float32, one ``make_train_step`` at remat
     "none", "dots" and "full" on the card from the same weights and
     batch, bit for bit under deterministic algorithms, and at "full"
     against the CPU (loss and grad_norm within 1e-4 relative, the
     updated parameters within half the step's lr), then ``grad_accum=2``
     against one batch of twice the rows on the card; the same three
     remats bit for bit and "full" against the CPU on jamba's smoke
     config (the Mamba chunk checkpoints; jamba at full width does not
     train on one card); qwen2-0.5b at full depth and its own dtypes
     (bfloat16 parameters, float32 moments) at each remat: step ms (CUDA
     events, median), ``max_memory_allocated`` over loss and gradients
     alone and over the whole step; rwkv6-3b at full width in bfloat16,
     ``ssm_chunk`` 16, batch 8 x 256, three steps at remat "full" and
     "none" at the largest depth that fits (step ms, both peaks, the
     loss), beside the bytes the step-by-step recurrence would keep
     without the chunk checkpoints (its own saved tensors, one step
     measured); qwen2-0.5b at full depth, its config's remat "full":
     ``TrainLoop`` over ``TokenDataset``,
     batch 8, seq 256, 20 steps with a checkpoint at step 10, the loss at
     step 20 below step 1's, step ms (CUDA events, median) beside the
     bound 6 x parameters x tokens over 989 TFLOP/s, tokens/s and
     ``max_memory_allocated``; a second loop resumed from the step-10
     checkpoint alone ends on the first loop's parameters, moments and
     losses bit for bit (``torch.use_deterministic_algorithms``); last
     ``python -m repro_torch.launch.train --arch qwen2-0.5b --steps 20
     --batch 8 --seq 256`` and ``python -m repro_torch.examples.train_lm
     --tiny --steps 20``, run together, each exiting 0;
 10. sharding and the LM dry run, every launch counter set to 0 just
     before (none of the nine kernels may launch), TF32 off: every LM
     cell of ``launch.dryrun`` (each architecture x shape x single/multi
     mesh) reckoned ``ok`` with ``torch.cuda.memory_allocated()``
     unchanged, the cells whose per-device argument bytes exceed the
     card's memory printed; a one-rank NCCL process group (a
     ``FileStore``) and ``make_host_mesh()``'s (1, 1) ("data", "model")
     mesh: qwen2-0.5b at full width and two layers in float32, the
     meshed forward (train rules) and decode over 64 positions (decode
     rules) against the unmeshed ones within phase 8's bound; at full
     depth in bfloat16 ``ServeEngine(mesh=...)`` against the unmeshed
     engine, batch 8, prompt 128, 32 new tokens, greedy tokens equal,
     decode ms a step of each (CUDA events, median), the reckoned
     per-device parameter bytes equal to the placed shards'; phi3.5-moe
     at full width and two layers with ``moe_impl="alltoall"`` under the
     mesh against unmeshed (model = 1: the dispatch path, as in the
     reference); one meshed train step of qwen2-0.5b x2 against the
     unmeshed one within phase 9's bound; then, on the host's CPU alone,
     the gloo rehearsal that ``tests/test_torch_sharding_dist.py`` runs
     too (``gloo_rank``: four processes, a (2, 2) mesh, small float32
     configs): dense and MLA forward and greedy tokens against unmeshed,
     the MoE all-to-all against dispatch (its cross-entropy's gradient
     leaf by leaf), the dense train step, a checkpoint restored onto (4, 1) and
     (2, 2), and the collectives each step issued beside the dry run's
     reckoning of them.

It prints phase 8's numbers as one ``lm:`` JSON line, phase 9's as one
``train:`` line and phase 10's as one ``shard:`` line, the kernels' JSON
line, the card line, and last ``{"ok": true, "device": {...}}``.
llama4-maverick-400b-a17b has no leg: at full width and two layers it is
37.1 GB in bfloat16 and 74.2 GB in float32, so no float32 card-against-CPU
check fits; the CPU tests hold it at its smoke size.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import glob
import json
import math
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

# the kernels' bound column comes from repro_torch.launch.roofline (the
# H100's rates and each kernel's work), imported in main(), so that this
# script and Engine.lower's cost analysis reckon alike
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
# phase 5: the mesh legs' repeated mesh and ragged batch; the backend each
# op resolves to on the card, meshed in this process and in the fleet's
# worker processes; the SLO leg's request side and batch
MESH_REPEAT, MESH_RAGGED_B = 3, 5
MESH_BACKENDS = {"ychg": "fused", "ccl": "cuda", "denoise": "cuda"}
FLEET_BACKENDS = dict(MESH_BACKENDS)
SLO_RES, SLO_BATCH = 1024, 4
# the service's digest kernel: the serve cells' bucket sides (uint8), the
# wide dtypes at one side, and lengths at the tree's edges (one leaf, one
# inner node, a partial last leaf, four levels)
KEYHASH_SIDES = (1024, 2048, 4096, 8192)
KEYHASH_WIDE_SIDE = 2048
KEYHASH_LENGTHS = (0, 1, 4095, 4097, 128 * 4096 + 1, 128 * 128 * 4096 + 5)
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


# phase 7: Engine.lower, the dry run, the pipeline and the examples. The
# cells lowered and run: (label, op, backend); the inputs by label
LOWER_CELLS = (
    ("serving batch", "ychg", "fused"), ("serving batch", "ychg", "cuda"),
    ("serving batch", "ychg", "torch"), ("serving batch", "ccl", "cuda"),
    ("serving batch", "ccl", "torch"), ("serving batch", "denoise", "cuda"),
    ("serving batch", "denoise", "torch"), ("scene", "ychg", "fused"),
    ("scene", "ychg", "cuda"), ("tall strip", "ychg", "fused"),
    ("tall strip", "ychg", "cuda"))
# the cells whose peak memory must lie within the reckoning: the kernel
# routes that allocate nothing but their tensors (ccl's re-ranking runs
# PyTorch's own scan kernels, whose temporaries the plan cannot see)
PEAK_CHECKED = {("ychg", "fused"), ("ychg", "cuda"), ("denoise", "cuda")}
ALLOC_ROUND = 512          # the caching allocator's block granularity
# the caching allocator splits a cached block above 1 MiB only when more
# than 1 MiB would remain, so a tensor above 1 MiB may hold up to 1 MiB
# more (chip run 1, PR 20: the two-kernel route's 1,114,176-byte buffer
# held a 1,498,624-byte block); the bytes requested are checked exactly
ALLOC_UNSPLIT = 1 << 20
# the engines' split-H budget (EngineConfig's default): the tall strip
# takes split-H, the serving batch and the scene whole columns
STREAM_VMEM_BUDGET = 4 * 1024 * 1024
DRYRUN_MAX_RES = 21000
PIPELINE_TILE, ANYRES_TILE, ANYRES_K = 512, 1024, 5
EXAMPLES = ("quickstart", "satellite_roi", "roi_pipeline",
            "roi_service_http", "roi_scene_bulk")
EXAMPLE_TIMEOUT_S = 300


# phase 8: LM serving. The float32 checks (card against CPU) run qwen2-0.5b
# at full width and minicpm3-4b (MLA), rwkv6-3b (RWKV-6) and
# phi3.5-moe-42b-a6.6b (MoE) at full width and two layers; jamba-v0.1-52b
# (Mamba + attention + MoE) at full width and one period (8 layers) on the
# card alone, in float32 and then in bfloat16; qwen2-0.5b with int8
# weights; the bfloat16 serving shape is qwen2-0.5b and rwkv6-3b (full
# depth) at their own dtypes; the CLI serves the full config. The rehearsal
# sets LM_SMOKE to run the reduced configs.
LM_ARCH, LM_MLA_ARCH, LM_MLA_LAYERS = "qwen2-0.5b", "minicpm3-4b", 2
LM_RWKV_ARCH, LM_MOE_ARCH = "rwkv6-3b", "phi3.5-moe-42b-a6.6b"
LM_HYBRID_ARCH, LM_HYBRID_LAYERS = "jamba-v0.1-52b", 8
LM_FAMILY_LAYERS = 2
LM_SMOKE = False
LM_CHECK_BATCH, LM_CHECK_PROMPT, LM_CHECK_NEW = 2, 64, 16
LM_INT8_PROMPT, LM_INT8_NEW = 16, 8
LM_BATCH, LM_PROMPT, LM_NEW = 8, 128, 64
LM_PREFILL_SAMPLES = 5
# the float32 bound, a share of max|logit| on the CPU: card against CPU,
# decode against forward, and the top-2 gap under which a greedy token may
# differ; stated before the first run on the card
LM_REL_BOUND = 1e-3
# the gap between a token's k-th and (k+1)-th router probabilities under
# which its experts may differ between the card and the CPU (float32
# probabilities one rounding apart); stated before the first run
LM_ROUTE_GAP_BOUND = 1e-4
LM_CLI = ("--workload", "lm", "--arch", LM_ARCH, "--batch", "4", "--prompt",
          "32", "--max-new", "32")
LM_PROCESS_TIMEOUT_S = 300


def lm_config(name: str, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.configs.archs import smoke_config

    cfg = smoke_config(name) if LM_SMOKE else get_config(name)
    return cfg.scaled(**overrides)


def float32_config(name: str, **overrides):
    return lm_config(name, param_dtype="float32", activation_dtype="float32",
                     **overrides)


def has_moe(cfg) -> bool:
    return any(spec.channel == "moe" for spec in cfg.layer_pattern)


def dropless(cfg):
    """``cfg`` with a capacity factor of E, so that every expert has a slot
    for every assignment and nothing drops: decode (T = B) and forward (T =
    B x S) then route alike."""
    return cfg.scaled(moe_capacity_factor=float(cfg.num_experts))


def free_card(torch) -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class RouteRecorder:
    """While active, records each MoE layer's expert indices and router
    probabilities as ``models.moe._route`` computes them, on the host."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe._route
        torch = self.torch

        def recording(p, xt, cfg):
            gates, idx, aux = self._route(p, xt, cfg)
            probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
            self.calls.append((idx.cpu(), probs.cpu()))
            return gates, idx, aux

        moe._route = recording
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route


def route_ties(torch, card_calls, cpu_calls, k: int, label: str):
    """(first flat token index whose experts differ, or None; the ties).
    A token whose experts differ in a layer whose input still agrees (a
    token before every earlier difference) is a tie: its CPU gap between
    the k-th and (k+1)-th router probabilities must be under the bound.
    Differences after the first are its consequences and are not held."""
    check(len(card_calls) == len(cpu_calls),
          f"{label}: {len(card_calls)} MoE layers on the card, "
          f"{len(cpu_calls)} on the CPU")
    first, ties = None, []
    for layer, ((card_idx, _), (cpu_idx, cpu_probs)) in enumerate(
            zip(card_calls, cpu_calls)):
        differ = torch.nonzero((card_idx != cpu_idx).any(-1))[:, 0].tolist()
        for t in differ:
            if first is not None and t >= first:
                continue
            top = torch.topk(cpu_probs[t], k + 1).values
            gap = float(top[k - 1] - top[k])
            check(gap < LM_ROUTE_GAP_BOUND,
                  f"{label}: token {t}'s experts differ on the card in MoE "
                  f"layer {layer} with a router gap {gap} >= "
                  f"{LM_ROUTE_GAP_BOUND}")
            ties.append({"layer": layer, "token": t, "gap": gap})
        if differ:
            first = min(differ) if first is None else min(first, *differ)
    return first, ties


def decode_against_forward(torch, cfg, params, tokens) -> tuple:
    """(forward's logits, max abs of ``decode_step`` over the prompt
    against them), on the parameters' device."""
    from repro_torch.models import decode_step, forward, init_cache

    b, p = tokens.shape
    full = forward(params, cfg, tokens)[0]
    cache = init_cache(cfg, b, p, tokens.device)
    steps = []
    for i in range(p):
        logits, cache = decode_step(params, cfg, cache, tokens[:, i:i + 1], i)
        steps.append(logits)
    return full, float((torch.stack(steps, 1) - full).abs().max())


def greedy_ties(np, torch, label, cfg, host, prompt, got, want,
                bound: float) -> list:
    """Rows whose greedy tokens part between the card (``got``) and the
    CPU (``want``): each may part only where the CPU's top-2 logit gap at
    that step is under ``bound``."""
    from repro_torch.models import forward

    ties = []
    for row in range(got.shape[0]):
        differ = np.nonzero(got[row] != want[row])[0]
        if not differ.size:
            continue
        k = int(differ[0])
        seq = np.concatenate([prompt[row], want[row, :k]])[None]
        last = forward(host, cfg, torch.from_numpy(seq))[0][0, -1]
        top = torch.topk(last.float(), 2).values
        gap = float(top[0] - top[1])
        check(gap < bound, f"{label}: greedy token {k} of row {row} "
                           f"differs on the card with a top-2 gap "
                           f"{gap} >= {bound}")
        ties.append({"row": row, "step": k, "gap": gap})
        print(f"lm [{label}]: greedy row {row} parts at step {k}, a "
              f"top-2 gap of {gap:.3e} under the bound", flush=True)
    return ties


def lm_float32_check(np, torch, label: str, cfg, card: str,
                     greedy: bool = True) -> dict:
    """One model in float32 on the card against the same weights on the
    CPU: ``forward`` (for a MoE model at its own capacity factor, with the
    router-tie rule), ``decode_step`` over the prompt against ``forward``
    on the card (a MoE model at a dropless capacity factor), and, with
    ``greedy``, ``ServeEngine.generate``'s greedy tokens."""
    from repro_torch.models import count_params, forward, init_params
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    host = tree_map(lambda t: t.cpu(), params)
    b, p, new = LM_CHECK_BATCH, LM_CHECK_PROMPT, LM_CHECK_NEW
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)
    tokens = torch.from_numpy(prompt)
    moe = has_moe(cfg)
    route = {}
    with torch.inference_mode():
        with RouteRecorder(torch) as on_card_routes:
            on_card = forward(params, cfg, tokens.to(DEV))[0]
        with RouteRecorder(torch) as on_cpu_routes:
            on_cpu = forward(host, cfg, tokens)[0]
        scale = float(on_cpu.abs().max())
        bound = LM_REL_BOUND * scale
        compared = b * p
        if moe:
            first, ties = route_ties(torch, on_card_routes.calls,
                                     on_cpu_routes.calls,
                                     cfg.experts_per_token, label)
            compared = compared if first is None else first
            check(compared > 0, f"{label}: the first token's experts differ")
            route = {"moe_layers": len(on_cpu_routes.calls),
                     "route_ties": ties, "tokens_compared": compared}
        err = float((on_card.cpu().reshape(b * p, -1)[:compared]
                     - on_cpu.reshape(b * p, -1)[:compared]).abs().max())
        check(err <= bound, f"{label}: forward on the card differs from the "
                            f"CPU by {err} > {bound}")
        del on_card, on_cpu
        dcfg = dropless(cfg) if moe else cfg
        _, dec_err = decode_against_forward(torch, dcfg, params,
                                            tokens.to(DEV))
        check(dec_err <= bound, f"{label}: decode_step on the card differs "
                                f"from forward by {dec_err} > {bound}")
        ties = []
        if greedy:
            got = ServeEngine(cfg, params, p + new, device=DEV).generate(
                prompt, new).tokens
            want = ServeEngine(cfg, host, p + new, device="cpu").generate(
                prompt, new).tokens
            ties = greedy_ties(np, torch, label, cfg, host, prompt, got,
                               want, bound)
    del params, host
    free_card(torch)
    print(f"lm [{label}]: {count_params(cfg):,} params float32, prompt "
          f"{b} x {p}: forward on the card against the CPU max abs "
          f"{err:.3e} (relative to max|logit| {scale:.4f}: "
          f"{err / scale:.3e})"
          + (f" over the first {compared} of {b * p} tokens, at capacity "
             f"factor {cfg.moe_capacity_factor:g}, experts equal in "
             f"{route['moe_layers']} MoE layers "
             f"{'except at ' + json.dumps(route['route_ties']) if route['route_ties'] else 'for every token'}"
             if moe else "")
          + f"; decode_step over {p} positions against forward max abs "
          f"{dec_err:.3e}"
          + (f" (dropless capacity factor {dcfg.moe_capacity_factor:g})"
             if moe else "")
          + f"; bound {bound:.3e} ({LM_REL_BOUND:g} of max|logit|)"
          + (f"; greedy tokens of ServeEngine.generate equal for {new} "
             f"steps "
             f"{'except at ' + json.dumps(ties) if ties else 'in every row'}"
             if greedy else "")
          + f"; {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return {"forward_max_abs": err, "decode_max_abs": dec_err,
            "max_logit": scale, "bound": bound, "greedy_ties": ties, **route}


def lm_card_check(np, torch, label: str, cfg, card: str) -> dict:
    """A model too large for a float32 copy on the CPU side: on the card
    alone, ``decode_step`` over the prompt against ``forward``, at a
    dropless capacity factor."""
    from repro_torch.models import count_params, init_params

    t0 = time.perf_counter()
    cfg = dropless(cfg) if has_moe(cfg) else cfg
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (LM_CHECK_BATCH, LM_CHECK_PROMPT)).astype(np.int32)
    with torch.inference_mode():
        full, dec_err = decode_against_forward(
            torch, cfg, params, torch.from_numpy(prompt).to(DEV))
        scale = float(full.abs().max())
        finite = bool(torch.isfinite(full).all())
    bound = LM_REL_BOUND * scale
    peak = torch.cuda.max_memory_allocated()
    del params, full
    free_card(torch)
    check(finite, f"{label}: forward on the card is not finite")
    check(dec_err <= bound, f"{label}: decode_step on the card differs from "
                            f"forward by {dec_err} > {bound}")
    print(f"lm [{label}]: {count_params(cfg):,} params float32 on the card "
          f"alone, prompt {LM_CHECK_BATCH} x {LM_CHECK_PROMPT}, capacity "
          f"factor {cfg.moe_capacity_factor:g} (dropless): decode_step "
          f"against forward max abs {dec_err:.3e}, bound {bound:.3e} "
          f"({LM_REL_BOUND:g} of max|logit| {scale:.4f}); "
          f"max_memory_allocated {peak:,} B; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return {"decode_max_abs": dec_err, "max_logit": scale, "bound": bound,
            "max_memory_allocated": peak}


def lm_generate_twice(np, torch, label: str, cfg, card: str) -> dict:
    """``ServeEngine.generate`` at the model's own dtypes, greedy, twice:
    equal tokens of the right shape."""
    from repro_torch.models import count_params, init_params
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (LM_CHECK_BATCH, LM_CHECK_PROMPT)).astype(np.int32)
    eng = ServeEngine(cfg, params, LM_CHECK_PROMPT + LM_CHECK_NEW, device=DEV)
    runs = [eng.generate(prompt, LM_CHECK_NEW).tokens for _ in range(2)]
    del params, eng
    free_card(torch)
    check(np.array_equal(runs[0], runs[1]),
          f"{label}: two greedy runs gave different tokens")
    check(runs[0].shape == (LM_CHECK_BATCH, LM_CHECK_NEW),
          f"{label}: tokens of shape {runs[0].shape}")
    seconds = time.perf_counter() - t0
    print(f"lm [{label}]: {count_params(cfg):,} params {cfg.param_dtype}: "
          f"ServeEngine.generate batch {LM_CHECK_BATCH}, prompt "
          f"{LM_CHECK_PROMPT}, {LM_CHECK_NEW} new tokens, greedy, two runs "
          f"equal; {seconds:.1f} s with the init; {card}", flush=True)
    return {"tokens_equal": True, "seconds": seconds}


def lm_int8_check(np, torch, label: str, cfg, card: str) -> dict:
    """int8 weights (float32 activations, TF32 off): ``decode_step`` over
    a prompt and then greedy on the card against the same quantised tree
    on the CPU (each group dequantized just before it runs); the greedy
    tokens equal, or parting only at a top-2 gap under the bound."""
    from repro_torch.models import count_params, decode_step, init_cache
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves_with_path, tree_map

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    int8 = sum(t.numel() for _, t in tree_leaves_with_path(params)
               if t.dtype == torch.int8)
    check(int8 > 0, f"{label}: no int8 leaves")
    host = tree_map(lambda t: t.cpu(), params)
    b, p, new = LM_CHECK_BATCH, LM_INT8_PROMPT, LM_INT8_NEW
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)
    caches = {"card": init_cache(cfg, b, p + new, DEV),
              "cpu": init_cache(cfg, b, p + new, "cpu")}
    trees = {"card": params, "cpu": host}
    logits = {"card": [], "cpu": []}
    tokens = {"card": [], "cpu": []}
    with torch.inference_mode():
        for side, dev in (("card", DEV), ("cpu", "cpu")):
            tok = None
            for i in range(p + new - 1):
                t = (torch.from_numpy(prompt[:, i:i + 1]) if i < p
                     else tok).to(dev)
                out, caches[side] = decode_step(trees[side], cfg,
                                                caches[side], t, i)
                logits[side].append(out.cpu())
                if i >= p - 1:
                    tok = torch.argmax(out, dim=-1)[:, None].to(torch.int32)
                    tokens[side].append(tok.cpu())
    card_logits = torch.stack(logits["card"][:p], 1)
    cpu_logits = torch.stack(logits["cpu"][:p], 1)
    scale = float(cpu_logits.abs().max())
    bound = LM_REL_BOUND * scale
    err = float((card_logits - cpu_logits).abs().max())
    got = torch.cat(tokens["card"], 1).numpy()
    want = torch.cat(tokens["cpu"], 1).numpy()
    del params, caches, trees
    free_card(torch)
    check(err <= bound, f"{label}: decode_step on the card differs from the "
                        f"CPU by {err} > {bound}")
    ties = []
    for row in range(b):
        differ = np.nonzero(got[row] != want[row])[0]
        if differ.size:   # the CPU's top-2 gap at the first parting step
            k = int(differ[0])
            top = torch.topk(logits["cpu"][p - 1 + k][row].float(), 2).values
            gap = float(top[0] - top[1])
            check(gap < bound, f"{label}: greedy token {k} of row {row} "
                               f"differs with a top-2 gap {gap} >= {bound}")
            ties.append({"row": row, "step": k, "gap": gap})
    del host
    print(f"lm [{label}]: {count_params(cfg):,} params ({int8:,} int8), "
          f"float32 activations: decode_step over {p} prompt positions on "
          f"the card against the CPU max abs {err:.3e}, bound {bound:.3e} "
          f"({LM_REL_BOUND:g} of max|logit| {scale:.4f}); greedy tokens "
          f"for {new} steps "
          f"{'equal except at ' + json.dumps(ties) if ties else 'equal in every row'}"
          f"; {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return {"decode_max_abs": err, "max_logit": scale, "bound": bound,
            "int8_params": int8, "greedy_ties": ties}


def lm_serving_leg(np, torch, label: str, cfg, card: str) -> dict:
    """The serving shape at the model's own dtypes: ``ServeEngine.generate``
    batch 8, prompt 128, 64 new tokens, greedy, after a warm-up run twice
    to equal tokens; prefill ms and decode ms a step by CUDA events, each
    beside its bound, tokens/s and ``max_memory_allocated``."""
    from repro_torch.launch.roofline import PEAK_BYTES_PER_S
    from repro_torch.models import count_params, init_params
    from repro_torch.models.layers import tree_leaves_with_path
    from repro_torch.serve import ServeEngine

    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    eng = ServeEngine(cfg, params, LM_PROMPT + LM_NEW, device=DEV)
    eng.generate(prompts, LM_NEW)       # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, seconds = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(eng.generate(prompts, LM_NEW).tokens)
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check(np.array_equal(runs[0], runs[1]),
          f"{label}: two greedy runs gave different tokens")
    check(runs[0].shape == (LM_BATCH, LM_NEW),
          f"{label}: tokens of shape {runs[0].shape}")

    def event():
        return torch.cuda.Event(enable_timing=True)

    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(DEV)
        prefill = []
        for _ in range(LM_PREFILL_SAMPLES):
            start, end = event(), event()
            start.record()
            logits, cache = eng._prefill(params, tokens)
            end.record()
            end.synchronize()
            prefill.append(start.elapsed_time(end))
        prefill_ms = statistics.median(prefill)
        cache = eng._pad_cache(cache)
        cache_bytes = sum(t.numel() * t.element_size()
                          for _, t in tree_leaves_with_path(cache))
        tok = eng._sample(logits, 0.0, None)
        marks = [event() for _ in range(LM_NEW + 1)]
        marks[0].record()
        for i in range(LM_NEW):
            logits, cache = eng._serve(params, cache, tok, LM_PROMPT + i)
            tok = eng._sample(logits, 0.0, None)
            marks[i + 1].record()
        marks[-1].synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    decode_ms = statistics.median(step_ms)
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves_with_path(params))
    bound_ms = (param_bytes + cache_bytes) / PEAK_BYTES_PER_S * 1e3
    n_params = count_params(cfg)
    # prefill: two operations a parameter a token, bf16 tensor-core peak
    prefill_bound_ms = max(
        2 * n_params * LM_BATCH * LM_PROMPT / 989e12,
        (param_bytes + cache_bytes * LM_PROMPT / (LM_PROMPT + LM_NEW))
        / PEAK_BYTES_PER_S) * 1e3
    tok_s = [LM_BATCH * LM_NEW / t for t in seconds]
    del params, eng, cache, logits, tokens
    free_card(torch)
    print(f"lm [{label}]: ServeEngine.generate batch {LM_BATCH}, "
          f"prompt {LM_PROMPT}, {LM_NEW} new tokens, greedy, two runs equal; "
          f"generate {json.dumps([round(t, 4) for t in seconds])} s "
          f"({json.dumps([round(t, 1) for t in tok_s])} tokens/s); prefill "
          f"{prefill_ms:.3f} ms (median of {LM_PREFILL_SAMPLES}, CUDA "
          f"events; min {min(prefill):.3f}, max {max(prefill):.3f}; bound "
          f"{prefill_bound_ms:.3f} ms); decode "
          f"{decode_ms:.3f} ms a step (median of {LM_NEW}, CUDA events; "
          f"min {min(step_ms):.3f}, max {max(step_ms):.3f}) against a bound "
          f"of {bound_ms:.3f} ms ({param_bytes:,} parameter bytes + "
          f"{cache_bytes:,} cache bytes a step over "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s): {bound_ms / decode_ms:.1%} "
          f"of the bound; max_memory_allocated {peak:,} B; {card}",
          flush=True)
    return {"batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
            "generate_s": seconds, "tokens_per_s": tok_s,
            "prefill_ms": prefill_ms, "prefill_samples_ms": prefill,
            "prefill_bound_ms": prefill_bound_ms,
            "decode_ms": decode_ms, "decode_step_ms": step_ms,
            "decode_bound_ms": bound_ms, "param_bytes": param_bytes,
            "cache_bytes": cache_bytes, "max_memory_allocated": peak}


def run_together(commands: dict, tag: str, timeout: float) -> float:
    """Starts every command at once, waits for all, fails on a non-zero
    exit (quoting its stderr's tail), prints each one's output; returns
    the seconds they took together. Kills what is still running on the
    way out."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in commands.items()}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=timeout)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        out, err = outs.get(name, ("", ""))
        check(proc.returncode == 0,
              f"{name} exited {proc.returncode}: {err[-2000:]}")
        print(f"{tag}: {name} exit 0; output: "
              f"{' | '.join(out.strip().splitlines())}", flush=True)
    return time.perf_counter() - t0


def kernel_modules():
    from repro_torch.kernels import ccl as kccl
    from repro_torch.kernels import denoise as kdn
    from repro_torch.kernels import ychg_colscan as kc
    from repro_torch.kernels import ychg_fused as kf
    from repro_torch.kernels import ychg_packed as kp

    return (kf, kc, kdn, kccl, kp)


def reset_kernel_counts() -> tuple:
    modules = kernel_modules()
    for module in modules:
        module.reset_launch_counts()
    return modules


def check_no_kernel_launched(modules, what: str) -> dict:
    launches = {}
    for module in modules:
        launches.update(module.LAUNCHES)
    check(not any(launches.values()),
          f"{what} launched a yCHG kernel: {launches}")
    return launches


def lm_phase(np, torch, card: str) -> dict:
    """Phase 8: LM serving on the card, every kernel launch counter set to
    0 just before (the LM path launches none of the nine kernels)."""
    from repro_torch.launch.serve import export_pythonpath

    t_phase = time.perf_counter()
    modules = reset_kernel_counts()
    # float32 is float32 on the card only with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    family = LM_FAMILY_LAYERS
    for label, cfg, greedy in [
            (LM_ARCH, float32_config(LM_ARCH), True),
            (f"{LM_MLA_ARCH} x{LM_MLA_LAYERS}",
             float32_config(LM_MLA_ARCH, num_layers=LM_MLA_LAYERS), True),
            (f"{LM_RWKV_ARCH} x{family}",
             float32_config(LM_RWKV_ARCH, num_layers=family), True),
            (f"{LM_MOE_ARCH} x{family}",
             float32_config(LM_MOE_ARCH, num_layers=family), False)]:
        report[label] = lm_float32_check(np, torch, label, cfg, card, greedy)
    label = f"{LM_HYBRID_ARCH} x{LM_HYBRID_LAYERS}"
    report[label] = lm_card_check(
        np, torch, label,
        float32_config(LM_HYBRID_ARCH, num_layers=LM_HYBRID_LAYERS), card)
    report[f"{label} bfloat16"] = lm_generate_twice(
        np, torch, f"{label} bfloat16",
        lm_config(LM_HYBRID_ARCH, num_layers=LM_HYBRID_LAYERS), card)
    report[f"{LM_ARCH} int8"] = lm_int8_check(
        np, torch, f"{LM_ARCH} int8",
        float32_config(LM_ARCH, weight_quant="int8"), card)
    # the serving shape at the models' own dtypes
    for arch in (LM_ARCH, LM_RWKV_ARCH):
        report[f"{arch} bfloat16"] = lm_serving_leg(
            np, torch, f"{arch} bfloat16", lm_config(arch), card)

    # the CLI at the full config and the serve_lm example, as a user runs
    # them, together
    export_pythonpath()
    flag = ["--device", "cpu"] if DEV == "cpu" else []
    seconds = run_together({
        "serve --workload lm": [sys.executable, "-m",
                                "repro_torch.launch.serve", *LM_CLI, *flag,
                                *(["--smoke"] if LM_SMOKE else [])],
        "examples.serve_lm": [sys.executable, "-m",
                              "repro_torch.examples.serve_lm", *flag]},
        "lm", LM_PROCESS_TIMEOUT_S)
    print(f"lm: the CLI and the example exited 0 in {seconds:.1f} s (run "
          f"together)", flush=True)

    launches = check_no_kernel_launched(modules, "the LM path")
    print(f"phase 8 (LM serving): {time.perf_counter() - t_phase:.1f} s; "
          f"the LM path launched none of the nine kernels "
          f"{json.dumps(launches)}", flush=True)
    return report


# phase 9: training. qwen2-0.5b at full width: two layers in float32 (TF32
# off), one train step at each remat bit for bit, on the card against the
# CPU at "full" from the same weights and batch (the same on jamba's smoke
# config), then grad_accum=2 against one batch of twice the rows on the
# card; at full depth and its own dtypes (bfloat16 parameters, float32
# moments) TrainLoop over TokenDataset, batch 8, seq 256, 20 steps with a
# checkpoint at 10, and a second loop resumed from it; the CLI and the
# train_lm example as processes. The rehearsal sets LM_SMOKE (the reduced
# config) and TRAIN_PATTERNS (a dataset whose patterns a 256-token
# vocabulary can tell apart).
TRAIN_ARCH, TRAIN_CHECK_LAYERS = "qwen2-0.5b", 2
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 64
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_RESUME_AT = 8, 256, 20, 10
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
TRAIN_PATTERNS = 64          # TokenDatasetConfig's default
# the float32 bounds, stated before the first run on the card: loss and
# grad_norm relative, the updated parameters absolute as a share of the
# step's lr (AdamW moves a component whose gradient is at rounding level
# by up to its share of lr in either order of summation)
TRAIN_REL_BOUND = 1e-4
TRAIN_PARAM_LR_SHARE = 0.5
# the remat legs: every remat on qwen2-0.5b x2 float32 and on the jamba
# smoke config (Mamba's chunk checkpoints), bit for bit; qwen2-0.5b at full
# depth in bfloat16 at each remat (step ms, peak of loss and gradients, peak
# of the step), TRAIN_REMAT_STEPS timed steps after one warm-up; rwkv6-3b
# at full width in bfloat16, batch TRAIN_BATCH x TRAIN_SEQ, at remat full
# and none, TRAIN_RWKV_STEPS steps each, at the largest depth of
# TRAIN_RWKV_DEPTHS that fits on the card
REMATS = ("none", "dots", "full")
TRAIN_REMAT_STEPS = 3
TRAIN_RWKV_ARCH, TRAIN_RWKV_STEPS = "rwkv6-3b", 2
TRAIN_RWKV_DEPTHS = (32, 24, 16, 8)
TRAIN_HYBRID_ARCH = "jamba-v0.1-52b"
# H100 SXM tensor-core bfloat16 peak, dense (NVIDIA H100 datasheet)
BF16_PEAK_FLOPS = 989e12
TRAIN_CLI = ("--arch", TRAIN_ARCH, "--steps", "20", "--batch", "8", "--seq",
             "256")


def tree_max_abs(a, b) -> float:
    """Max abs difference of two trees, DTensor leaves taken whole."""
    from repro_torch.models.layers import is_dtensor, tree_leaves_with_path

    def whole(t):
        return (t.full_tensor() if is_dtensor(t) else t).float().cpu()

    other = dict(tree_leaves_with_path(b))
    return max(float((whole(t) - whole(other[path])).abs().max())
               for path, t in tree_leaves_with_path(a))


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` while active, as it was
    before after: a bit-for-bit check of two steps needs each op's bits
    to repeat (on the CPU, without it, the embedding lookup's backward,
    an ``index_put`` with accumulation, adds rows in thread order)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def remat_bits_differ(torch, runs: dict) -> list:
    """(remat, what) for each output of a train step at another remat that
    is not bit for bit the "none" step's: ``runs`` maps a remat to
    (parameters, optimiser state, metrics)."""
    from repro_torch.models.layers import tree_leaves_with_path

    p, o, m = runs["none"]
    differ = []
    for remat, (p2, o2, m2) in runs.items():
        differ += [(remat, k) for k in ("loss", "grad_norm")
                   if not torch.equal(m[k], m2[k])]
        for tree, tree2 in ((p, p2), (o.mu, o2.mu), (o.nu, o2.nu)):
            other = dict(tree_leaves_with_path(tree2))
            differ += [(remat, "/".join(path))
                       for path, t in tree_leaves_with_path(tree)
                       if not torch.equal(t, other[path])]
    return differ


def remat_step_check(np, torch, cfg, batch, label: str, card: str) -> dict:
    """One ``make_train_step`` of ``cfg`` (float32) at remat "none", "dots"
    and "full" on the card from the same weights and batch, under
    deterministic algorithms: loss, grad_norm, the updated parameters and
    moments bit for bit; then the "full" step on the CPU against the
    card's within phase 9's float32 bounds."""
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    runs = {}
    with deterministic(torch):
        for remat in REMATS:
            # the schedule's peak at once, so the step moves the parameters
            step = make_train_step(cfg.scaled(remat=remat), warmup_steps=0)
            runs[remat] = step(params, adamw_init(params), batch)
    differ = remat_bits_differ(torch, runs)
    check(not differ, f"train {label}: the step at another remat differs "
                      f"from remat=none in {len(differ)} outputs, e.g. "
                      f"{differ[:4]}")
    host = tree_map(lambda t: t.cpu(), params)
    full = cfg.scaled(remat="full")
    p_cpu, _, m_cpu = make_train_step(full, warmup_steps=0)(
        host, adamw_init(host), batch)
    p_card, _, m_card = runs["full"]
    lr = float(m_cpu["lr"])
    out = {"remats": list(REMATS), "bit_equal": True, "lr": lr,
           "param_bound": TRAIN_PARAM_LR_SHARE * lr}
    for name in ("loss", "grad_norm"):
        a, b = float(m_card[name]), float(m_cpu[name])
        out[f"{name}_rel"] = abs(a - b) / abs(b)
        out[name] = b
        check(out[f"{name}_rel"] <= TRAIN_REL_BOUND,
              f"train {label}: {name} on the card {a} against the CPU {b}")
    out["param_max_abs"] = tree_max_abs(p_card, p_cpu)
    check(out["param_max_abs"] <= out["param_bound"],
          f"train {label}: updated parameters differ by "
          f"{out['param_max_abs']} > {out['param_bound']}")
    del params, runs, host, p_cpu, p_card
    free_card(torch)
    print(f"train remat [{label}]: one train step at remat none, dots and "
          f"full on the card from the same weights and batch (deterministic "
          f"algorithms): loss, grad_norm, parameters and moments bit for bit "
          f"(max abs 0.0); at full the card against the CPU: loss relative "
          f"{out['loss_rel']:.3e}, grad_norm {out['grad_norm_rel']:.3e} "
          f"(bound {TRAIN_REL_BOUND:g}), parameters max abs "
          f"{out['param_max_abs']:.3e} (bound {out['param_bound']:.3e}); "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return out


def train_float32_check(np, torch, card: str) -> dict:
    """One ``make_train_step`` on the card against the CPU from the same
    float32 weights and batch (loss, grad_norm, the updated parameters) at
    remat "full", the card's step at "none" and "dots" bit for bit the
    same (``remat_step_check``), then ``grad_accum=2`` against one batch
    of twice the rows on the card."""
    from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig
    from repro_torch.models import count_params, init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    cfg = float32_config(TRAIN_ARCH, num_layers=TRAIN_CHECK_LAYERS,
                         remat="full")
    batch = TokenDataset(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_CHECK_SEQ,
        global_batch=2 * TRAIN_CHECK_BATCH)).batch(0)
    half = {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()}
    out = remat_step_check(np, torch, cfg, half,
                           f"{TRAIN_ARCH} x{TRAIN_CHECK_LAYERS} float32", card)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    step = make_train_step(cfg, warmup_steps=0)
    whole = step(params, adamw_init(params), batch)
    accum = make_train_step(cfg, warmup_steps=0, grad_accum=2)(
        params, adamw_init(params), batch)
    out["accum_loss_rel"] = abs(float(accum[2]["loss"])
                                - float(whole[2]["loss"])) / abs(
                                    float(whole[2]["loss"]))
    out["accum_param_max_abs"] = tree_max_abs(accum[0], whole[0])
    check(out["accum_loss_rel"] <= TRAIN_REL_BOUND,
          f"train float32: grad_accum=2 loss differs by "
          f"{out['accum_loss_rel']} (relative)")
    check(out["accum_param_max_abs"] <= out["param_bound"],
          f"train float32: grad_accum=2 parameters differ by "
          f"{out['accum_param_max_abs']} > {out['param_bound']}")
    del params, whole, accum
    free_card(torch)
    lr = out["lr"]
    print(f"train [{TRAIN_ARCH} x{TRAIN_CHECK_LAYERS} float32]: "
          f"{count_params(cfg):,} params, batch {TRAIN_CHECK_BATCH} x "
          f"{TRAIN_CHECK_SEQ}, remat full, one train step at lr {lr:g}: loss "
          f"on the card "
          f"against the CPU relative {out['loss_rel']:.3e}, grad_norm "
          f"{out['grad_norm_rel']:.3e} (bound {TRAIN_REL_BOUND:g}), updated "
          f"parameters max abs {out['param_max_abs']:.3e} (bound "
          f"{out['param_bound']:.3e}, {TRAIN_PARAM_LR_SHARE:g} of lr); "
          f"grad_accum=2 against one batch of {2 * TRAIN_CHECK_BATCH} on "
          f"the card: loss relative {out['accum_loss_rel']:.3e}, parameters "
          f"max abs {out['accum_param_max_abs']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return out


def train_loop_leg(np, torch, card: str) -> dict:
    """``TrainLoop`` at full depth and the model's own dtypes: 20 steps
    with a checkpoint at 10 (loss falling, step ms by CUDA events beside
    the 6 x parameters x tokens bound, tokens/s, peak memory), then a
    second loop resumed from the step-10 checkpoint alone, ending on the
    uninterrupted run's parameters and moments, bit for bit under
    ``torch.use_deterministic_algorithms``."""
    import shutil

    from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig
    from repro_torch.models import count_params, init_params
    from repro_torch.models.layers import tree_leaves_with_path
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step

    t0 = time.perf_counter()
    cfg = lm_config(TRAIN_ARCH)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    ds = TokenDataset(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, n_patterns=TRAIN_PATTERNS))
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    marks, losses = [], {}

    def timed(p, o, batch):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = step(p, o, batch)
        end.record()
        marks.append((start, end))
        return out

    def batches(start):
        return (ds.batch(i) for i in range(start, TRAIN_STEPS))

    def log(into):
        return lambda s, m: into.__setitem__(s, m["loss"])

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            first_dir = os.path.join(tmp, "run")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_run = time.perf_counter()
            loop = TrainLoop(timed, TrainLoopConfig(
                total_steps=TRAIN_STEPS, ckpt_dir=first_dir,
                ckpt_every=TRAIN_RESUME_AT, log_every=1), log_fn=log(losses))
            p_run, o_run, end = loop.run(params, adamw_init(params),
                                         batches(0))
            run_s = time.perf_counter() - t_run
            peak = torch.cuda.max_memory_allocated()
            step_ms = [a.elapsed_time(b) for a, b in marks]
            # the job killed after step 10's save: a directory with that
            # checkpoint alone
            resume_dir = os.path.join(tmp, "resumed")
            os.makedirs(resume_dir)
            name = f"step_{TRAIN_RESUME_AT:08d}"
            shutil.copytree(os.path.join(first_dir, name),
                            os.path.join(resume_dir, name))
            shutil.rmtree(first_dir)
            resumed_losses = {}
            loop2 = TrainLoop(step, TrainLoopConfig(
                total_steps=TRAIN_STEPS, ckpt_dir=resume_dir,
                ckpt_every=TRAIN_STEPS * 10, log_every=1),
                log_fn=log(resumed_losses))
            p2, o2, start = loop2.resume_or_init(params, adamw_init(params))
            check(start == TRAIN_RESUME_AT,
                  f"train: resumed at step {start}, not {TRAIN_RESUME_AT}")
            p2, o2, end2 = loop2.run(p2, o2, batches(start), start_step=start)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    check(end == end2 == TRAIN_STEPS, f"train: loops ended at {end}, {end2}")
    check(loop.nan_skips == loop2.nan_skips == 0, "train: a NaN step")
    differ = [("/".join(path), float((leaf.float() - dict(
        tree_leaves_with_path(tree2))[path].float()).abs().max()))
        for tree, tree2 in ((p_run, p2), (o_run.mu, o2.mu), (o_run.nu, o2.nu))
        for path, leaf in tree_leaves_with_path(tree)
        if not torch.equal(leaf, dict(tree_leaves_with_path(tree2))[path])]
    check(int(o2.step) == int(o_run.step) == TRAIN_STEPS,
          f"train: optimiser steps {int(o_run.step)}, {int(o2.step)}")
    check(not differ, f"train: the resumed run's state differs from the "
                      f"uninterrupted run's in {len(differ)} leaves, e.g. "
                      f"{differ[:3]}")
    check(all(resumed_losses[s] == losses[s]
              for s in range(TRAIN_RESUME_AT + 1, TRAIN_STEPS + 1)),
          "train: the resumed run's losses differ")
    check(losses[TRAIN_STEPS] < losses[1],
          f"train: loss at step {TRAIN_STEPS} {losses[TRAIN_STEPS]} is not "
          f"below step 1's {losses[1]}")
    n_params = count_params(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    median_ms = statistics.median(step_ms[1:])
    bound_ms = 6 * n_params * tokens / BF16_PEAK_FLOPS * 1e3
    del params, p_run, o_run, p2, o2
    free_card(torch)
    out = {"params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "losses": [losses[s] for s in sorted(losses)],
           "step_ms": step_ms, "median_step_ms": median_ms,
           "bound_ms": bound_ms, "tokens_per_s": tokens / median_ms * 1e3,
           "run_s": run_s, "max_memory_allocated": peak, "remat": cfg.remat,
           "resumed_at": TRAIN_RESUME_AT, "resume_bit_equal": True}
    print(f"train [{TRAIN_ARCH} {cfg.param_dtype}]: {n_params:,} params, "
          f"remat {cfg.remat}, "
          f"TrainLoop batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps "
          f"(lr {TRAIN_LR:g}, warm-up {TRAIN_WARMUP}), checkpoint at "
          f"{TRAIN_RESUME_AT}: loss {losses[1]:.4f} at step 1 -> "
          f"{losses[TRAIN_STEPS]:.4f} at step {TRAIN_STEPS}; step "
          f"{median_ms:.3f} ms (median of steps 2-{TRAIN_STEPS}, CUDA events; "
          f"min {min(step_ms[1:]):.3f}, max {max(step_ms[1:]):.3f}; the "
          f"first {step_ms[0]:.3f}) against a bound of {bound_ms:.3f} ms (6 x "
          f"{n_params:,} x {tokens} tokens over {BF16_PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s): {bound_ms / median_ms:.1%} of the bound; "
          f"{out['tokens_per_s']:.1f} tokens/s; loop with its two saves "
          f"{run_s:.1f} s; max_memory_allocated {peak:,} B; resumed from step "
          f"{TRAIN_RESUME_AT} to {TRAIN_STEPS}: parameters, moments and "
          f"losses equal to the uninterrupted run's bit for bit "
          f"(deterministic algorithms); {time.perf_counter() - t0:.1f} s; "
          f"{card}", flush=True)
    return out


def loss_and_grads(torch, cfg, params, batch):
    """``loss_fn`` and its gradients over every parameter leaf, taken as
    ``train.step`` takes them (leaves detached and requiring grad), on the
    batch moved to the card."""
    from repro_torch.models import loss_fn
    from repro_torch.models.layers import tree_leaves_with_path, tree_map

    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_leaves_with_path(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, _ = loss_fn(live, cfg, torch.as_tensor(batch["tokens"]).to(DEV),
                      torch.as_tensor(batch["labels"]).to(DEV))
    return loss.detach(), torch.autograd.grad(loss, leaves)


def grad_peak(torch, cfg, params, batch) -> tuple:
    """(``max_memory_allocated`` over loss and gradients alone, reset just
    before; the bytes allocated before them)."""
    free_card(torch)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = loss_and_grads(torch, cfg, params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del loss, grads
    free_card(torch)
    return peak, held


def step_timer(torch):
    """A pair of CUDA events recording around a call: ``(start, end)``."""
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def train_remat_leg(np, torch, card: str) -> dict:
    """qwen2-0.5b at full width and depth, its own dtypes (bfloat16
    parameters, float32 moments), batch TRAIN_BATCH x TRAIN_SEQ, at each
    remat from the same weights and batch: ``max_memory_allocated`` over
    loss and gradients alone and over whole steps (AdamW's out-of-place
    trees included), and the step's ms (CUDA events, median of
    TRAIN_REMAT_STEPS after a warm-up)."""
    from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    base = lm_config(TRAIN_ARCH)
    params = init_params(base, torch.Generator(DEV).manual_seed(0))
    batch = TokenDataset(TokenDatasetConfig(
        vocab_size=base.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, n_patterns=TRAIN_PATTERNS)).batch(0)
    out = {}
    for remat in REMATS:
        cfg = base.scaled(remat=remat)
        grad_max, held = grad_peak(torch, cfg, params, batch)
        step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup_steps=0)
        opt = adamw_init(params)
        losses = [float(step(params, opt, batch)[2]["loss"])]   # warm-up
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(TRAIN_REMAT_STEPS):
            start, end = step_timer(torch)
            start.record()
            metrics = step(params, opt, batch)[2]
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
        out[remat] = {"median_step_ms": statistics.median(ms), "step_ms": ms,
                      "grad_max_memory_allocated": grad_max,
                      "step_max_memory_allocated":
                          torch.cuda.max_memory_allocated(),
                      "held_before": held, "loss": losses[0]}
        check(len(set(losses)) == 1, f"train remat [{TRAIN_ARCH}]: the same "
                                     f"step at {remat} gave losses {losses}")
        del opt
        free_card(torch)
    del params
    free_card(torch)
    for remat, r in out.items():
        print(f"train remat [{TRAIN_ARCH} {base.param_dtype}] remat={remat}: "
              f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, step "
              f"{r['median_step_ms']:.3f} ms (median of {TRAIN_REMAT_STEPS}, "
              f"CUDA events; min {min(r['step_ms']):.3f}, max "
              f"{max(r['step_ms']):.3f}); max_memory_allocated over loss and "
              f"gradients {r['grad_max_memory_allocated']:,} B "
              f"({r['grad_max_memory_allocated'] - r['held_before']:,} B "
              f"above the {r['held_before']:,} B held before), over the "
              f"whole step {r['step_max_memory_allocated']:,} B; loss "
              f"{r['loss']:.4f}; {card}", flush=True)
    check(len({r["loss"] for r in out.values()}) == 1,
          f"train remat [{TRAIN_ARCH}]: losses differ across remat "
          f"{[r['loss'] for r in out.values()]}")
    out["seconds"] = time.perf_counter() - t0
    return out


def recurrence_kept_bytes(torch, cfg, batch: int, seq: int) -> dict:
    """The bytes the RWKV time-mix recurrence keeps for the backward, read
    from its own saved tensors: its steps (``rwkv._mix_steps``, no
    checkpoint) at (batch, heads, head dim) on the card under
    ``saved_tensors_hooks``, one step and two, the difference a step,
    times ``seq`` and the layers; beside the chunked scan's, one float32
    state a chunk of ``cfg.ssm_chunk``."""
    from repro_torch.models import rwkv

    h, k = rwkv.num_heads_of(cfg), cfg.rwkv_head_dim

    def kept(steps: int) -> int:
        gen = torch.Generator(DEV).manual_seed(steps)
        xs = [torch.randn((batch, steps, h, k), generator=gen, device=DEV,
                          requires_grad=True) for _ in range(4)]
        u = torch.randn((h, k), generator=gen, device=DEV,
                        requires_grad=True)
        inputs = {t.untyped_storage().data_ptr() for t in (*xs, u)}
        seen = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in inputs:
                seen[st.data_ptr()] = st.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = rwkv._mix_steps(torch.zeros((batch, h, k, k), device=DEV),
                                  *xs, u)
        del out
        return sum(seen.values())

    per_step = kept(2) - kept(1)
    state = batch * h * k * k * 4
    return {"per_step": per_step, "state": state,
            "stepwise": per_step * seq * cfg.num_layers,
            "chunked": math.ceil(seq / cfg.ssm_chunk) * state
            * cfg.num_layers}


def rwkv_train_run(torch, cfg, batches) -> dict:
    """``len(batches)`` train steps of ``cfg`` from fresh weights, each on
    the parameters the last one returned (the steps' ms by CUDA events,
    their losses and peak), then the peak over loss and gradients alone
    on the last parameters, the moments freed first."""
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    opt = adamw_init(params)
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup_steps=0)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for batch in batches:
        start, end = step_timer(torch)
        start.record()
        params, opt, metrics = step(params, opt, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    del opt
    grad_max, held = grad_peak(torch, cfg, params, batches[0])
    del params
    free_card(torch)
    check(all(math.isfinite(x) for x in losses),
          f"train rwkv: losses {losses}")
    return {"step_ms": ms, "losses": losses, "grad_max_memory_allocated":
            grad_max, "held_before": held, "step_max_memory_allocated": peak}


def train_rwkv_leg(np, torch, card: str) -> dict:
    """rwkv6-3b at full width, its own dtypes (bfloat16 parameters, float32
    moments), ``ssm_chunk`` 16 and ``remat="full"``, batch TRAIN_BATCH x
    TRAIN_SEQ, TRAIN_RWKV_STEPS steps (the loss before the first update
    and after it) at the largest depth of
    TRAIN_RWKV_DEPTHS whose "full" run fits on the card, then the same at
    "none" (its out-of-memory stated, not failed); and the bytes the
    step-by-step recurrence would keep without the chunk checkpoints."""
    from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig
    from repro_torch.models import count_params

    t0 = time.perf_counter()
    base = lm_config(TRAIN_RWKV_ARCH)
    ds = TokenDataset(TokenDatasetConfig(
        vocab_size=base.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, n_patterns=TRAIN_PATTERNS))
    batches = [ds.batch(i) for i in range(TRAIN_RWKV_STEPS)]
    depths = [d for d in TRAIN_RWKV_DEPTHS if d < base.num_layers]
    out = {"runs": {}, "out_of_memory": {}}
    for depth in [base.num_layers, *depths]:
        for remat in ("full", "none"):
            cfg = base.scaled(num_layers=depth, remat=remat)
            try:
                out["runs"][remat] = rwkv_train_run(torch, cfg, batches)
                continue
            except torch.OutOfMemoryError as e:
                out["out_of_memory"][f"{remat} x{depth}"] = {
                    "error": " ".join(str(e).split(". ")[:2]),
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated()}
            free_card(torch)
            if remat == "full":
                break
        if "full" in out["runs"]:
            break
    check("full" in out["runs"], f"train rwkv: no depth of "
                                 f"{TRAIN_RWKV_DEPTHS} fits at remat full: "
                                 f"{out['out_of_memory']}")
    cfg = base.scaled(num_layers=depth)
    out.update(depth=depth, params=count_params(cfg),
               kept=recurrence_kept_bytes(torch, cfg, TRAIN_BATCH, TRAIN_SEQ))
    free_card(torch)
    for remat, r in out["runs"].items():
        print(f"train rwkv [{TRAIN_RWKV_ARCH} x{depth} of {base.num_layers} "
              f"{base.param_dtype}] remat={remat}: {out['params']:,} params, "
              f"ssm_chunk {base.ssm_chunk}, batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, {TRAIN_RWKV_STEPS} steps at lr {TRAIN_LR:g}: "
              f"step ms {[round(x, 3) for x in r['step_ms']]} (CUDA events); "
              f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; "
              f"max_memory_allocated over the steps "
              f"{r['step_max_memory_allocated']:,} B, over loss and "
              f"gradients alone {r['grad_max_memory_allocated']:,} B (above "
              f"the {r['held_before']:,} B of parameters); {card}",
              flush=True)
    k = out["kept"]
    print(f"train rwkv [{TRAIN_RWKV_ARCH} x{depth}]: out of memory at "
          f"{json.dumps(out['out_of_memory'])}; the recurrence keeps "
          f"{k['per_step']:,} B a step ({k['per_step'] / k['state']:.2f} "
          f"float32 states of {k['state']:,} B) step by step, "
          f"{k['stepwise']:,} B over {TRAIN_SEQ} steps and {depth} layers "
          f"without the chunk checkpoints, {k['chunked']:,} B with them (one "
          f"state a chunk of {base.ssm_chunk}); "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def train_hybrid_check(np, torch, card: str) -> dict:
    """jamba's smoke config (Mamba chunk checkpoints over ``ssm_chunk``
    steps, attention, MoE) at every remat, bit for bit, and card against
    CPU at "full": jamba at full width does not train on one card (one
    period of 8 layers is about 53 GB in float32)."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig

    cfg = smoke_config(TRAIN_HYBRID_ARCH)
    batch = TokenDataset(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_CHECK_SEQ,
        global_batch=TRAIN_CHECK_BATCH)).batch(0)
    return remat_step_check(np, torch, cfg, batch,
                            f"{TRAIN_HYBRID_ARCH} smoke float32, ssm_chunk "
                            f"{cfg.ssm_chunk}", card)


def train_phase(np, torch, card: str) -> dict:
    """Phase 9: training on the card, every kernel launch counter set to 0
    just before (training launches none of the nine kernels)."""
    from repro_torch.launch.serve import export_pythonpath

    t_phase = time.perf_counter()
    modules = reset_kernel_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"float32": train_float32_check(np, torch, card),
              "hybrid": train_hybrid_check(np, torch, card),
              "loop": train_loop_leg(np, torch, card),
              "remat": train_remat_leg(np, torch, card),
              "rwkv": train_rwkv_leg(np, torch, card)}

    export_pythonpath()
    flag = ["--device", "cpu"] if DEV == "cpu" else []
    with tempfile.TemporaryDirectory() as ckpt:
        seconds = run_together({
            "launch.train": [sys.executable, "-m",
                             "repro_torch.launch.train", *TRAIN_CLI, *flag,
                             *(["--smoke"] if LM_SMOKE else [])],
            "examples.train_lm": [sys.executable, "-m",
                                  "repro_torch.examples.train_lm", "--tiny",
                                  "--steps", "20", "--ckpt", ckpt, *flag]},
            "train", LM_PROCESS_TIMEOUT_S)
    report["processes_s"] = seconds
    print(f"train: the CLI and the example exited 0 in {seconds:.1f} s (run "
          f"together)", flush=True)
    launches = check_no_kernel_launched(modules, "training")
    print(f"phase 9 (training): {time.perf_counter() - t_phase:.1f} s; "
          f"training launched none of the nine kernels "
          f"{json.dumps(launches)}", flush=True)
    return report


# phase 10: sharding and the LM dry run. Every LM cell reckoned (nothing
# allocated); then a one-rank process group (nccl on the card; the
# rehearsal sets gloo) and its (1, 1) ("data", "model") DeviceMesh:
# qwen2-0.5b at full width and two layers in float32 (TF32 off), meshed
# forward and decode against unmeshed on the card; at full depth in
# bfloat16, ServeEngine(mesh=...) against the unmeshed engine (greedy
# tokens, decode ms a step); phi3.5-moe at full width and two layers under
# the mesh (dispatch: model = 1); one meshed train step; the reckoned
# per-device parameter bytes against the placed shards. The float32 bound
# is phase 8's (LM_REL_BOUND of max|logit|), the train step's phase 9's.
SHARD_BACKEND = "nccl"
SHARD_CHECK_BATCH, SHARD_CHECK_PROMPT = 2, 64
SHARD_SERVE_NEW = 32

# phase 10's gloo rehearsal, which tests/test_torch_sharding_dist.py runs
# too: GLOO_PROCS processes on the host's CPU, one torch thread each, a
# (GLOO_PROCS // GLOO_MODEL, GLOO_MODEL) ("data", "model") mesh, and small
# float32 configs: a dense and an MLA model (forward, greedy tokens; the
# dense one's train step and checkpoint) and a MoE one on the all-to-all
# path (against dispatch, its gradient leaf by leaf), and
# the collectives each step issues (``collective_log``)
GLOO_PROCS, GLOO_MODEL = 4, 2
GLOO_TIMEOUT_S = 300
GLOO_BATCH, GLOO_SEQ, GLOO_PROMPT, GLOO_NEW, GLOO_MAX_LEN = 4, 16, 6, 8, 24
GLOO_BASE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                 d_ff=64, vocab_size=96, activation_dtype="float32",
                 param_dtype="float32", remat="none", attn_chunk=8)
GLOO_MLA = dict(q_lora_rank=16, kv_lora_rank=8, qk_rope_dim=4,
                qk_nope_dim=8, v_head_dim=8)
# label -> (config fields, the layer's mixer)
GLOO_MODELS = {"dense": (dict(family="dense"), "attn"),
               "mla": (dict(family="dense", **GLOO_MLA), "mla")}
GLOO_MOE = dict(family="moe", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, d_ff=64, vocab_size=97, num_experts=4,
                experts_per_token=2, moe_capacity_factor=16.0,
                activation_dtype="float32", param_dtype="float32",
                remat="none", attn_chunk=64, pattern=(("attn", "moe"),))
GLOO_FWD_ATOL, GLOO_FWD_RTOL = 2e-5, 1e-5    # the float32 bar
GLOO_A2A_BOUND = 1e-3          # the reference's all-to-all test's bar
GLOO_GRAD_REL = 1e-5           # of each leaf's gradient norm
# the steps whose collectives are logged: decode of each model, the train
# cell's forward (the loss without gradients) and the whole train step
GLOO_COLLECTIVE_CASES = (("decode", "dense"), ("decode", "mla"),
                         ("decode", "moe"), ("decode", "moe-dispatch"),
                         ("forward", "dense"), ("forward", "moe"),
                         ("train", "dense"), ("train", "moe"))


def gloo_model_config(label: str):
    """A GLOO_MODELS entry (or "moe", "moe-dispatch") as a ModelConfig of
    the port."""
    from repro_torch.configs.base import LayerSpec, ModelConfig

    if label.startswith("moe"):
        kw = dict(GLOO_MOE)
        kw["moe_impl"] = "dispatch" if label == "moe-dispatch" \
            else "alltoall"
    else:
        fields, mixer = GLOO_MODELS[label]
        kw = {**GLOO_BASE, **fields, "pattern": ((mixer, "mlp"),)}
    pattern = kw.pop("pattern")
    return ModelConfig(name="t-" + label, layer_pattern=tuple(
        LayerSpec(*p) for p in pattern), **kw)


def collective_log(torch):
    """A dispatch mode that logs every collective issued under it, as
    (kind, result bytes, group size, in backward): DTensor's own (it lets
    DTensor run first, as ``CommDebugMode`` does) and the explicit ones.
    Scatters and broadcasts (placing a step's inputs) are logged as kind
    "placement"."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    def size(group) -> int:
        if isinstance(group, str):
            return _resolve_process_group(group).size()
        return dist.ProcessGroup.unbox(group).size()

    def nbytes(t) -> int:
        return t.numel() * t.element_size()

    # op -> (kind, the input tensor, the group, how the result's bytes
    # follow from the input's and the group's size)
    same = lambda b, g: b        # noqa: E731
    ops = {
        "_c10d_functional.all_reduce": (
            "all-reduce", lambda a: a[0], lambda a: a[2], same),
        "_c10d_functional.all_gather_into_tensor": (
            "all-gather", lambda a: a[0], lambda a: a[2],
            lambda b, g: b * g),
        "_c10d_functional.reduce_scatter_tensor": (
            "reduce-scatter", lambda a: a[0], lambda a: a[3],
            lambda b, g: b // g),
        "_c10d_functional.all_to_all_single": (
            "all-to-all", lambda a: a[0], lambda a: a[3], same),
        "c10d.allreduce_": (
            "all-reduce", lambda a: a[0][0], lambda a: a[1], same),
        "c10d.alltoall_base_": (
            "all-to-all", lambda a: a[1], lambda a: a[2], same),
        "c10d._allgather_base_": (
            "all-gather", lambda a: a[1], lambda a: a[2],
            lambda b, g: b * g),
        "c10d.allgather_": (
            "all-gather", lambda a: a[1][0], lambda a: a[2],
            lambda b, g: b * g),
        "c10d.scatter_": ("placement", None, None, None),
        "c10d.broadcast_": ("placement", None, None, None),
    }

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            entry = ops.get(str(func._overloadpacket))
            if entry is not None:
                kind, tensor, group, result = entry
                if kind == "placement":
                    self.ops.append((kind, 0, 0, False))
                else:
                    g = size(group(args))
                    self.ops.append((
                        kind, result(nbytes(tensor(args)), g)
                        if tensor(args).dim() else 0, g,
                        torch._C._current_autograd_node() is not None))
            return out

    return Log()


def collective_totals(ops, ring_bytes) -> dict:
    """A collective log's ops and ring bytes by kind, leaving out input
    placement and 0-dim collectives (metrics, the aux loss, the gradient
    norm): (counts, bytes) of the whole and of the forward."""
    out = {}
    for part in ("all", "forward"):
        counts, moved = {}, {}
        for kind, result, g, backward in ops:
            if kind == "placement" or not result or (
                    part == "forward" and backward):
                continue
            counts[kind] = counts.get(kind, 0) + 1
            moved[kind] = moved.get(kind, 0.0) + ring_bytes(kind, result, g)
        out[part] = {"counts": counts, "bytes": moved}
    return out


def gloo_write_inputs(np, out_dir: str, models: dict, ckpt_save) -> dict:
    """The rehearsal's inputs: ``models`` (a GLOO_MODELS label -> its
    parameters as a NumPy tree), the tokens and prompts drawn here, and
    ``ckpt_save(path)``, which writes the dense model's parameters as the
    checkpoint at step 1 under ``path``. Returns the inputs."""
    import pickle

    rng = np.random.default_rng(0)
    inputs = {
        "models": models,
        "tokens": rng.integers(0, GLOO_BASE["vocab_size"],
                               (GLOO_BATCH, GLOO_SEQ)).astype(np.int32),
        "prompts": rng.integers(0, GLOO_BASE["vocab_size"],
                                (GLOO_BATCH, GLOO_PROMPT)).astype(np.int32),
    }
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ckpt_save(os.path.join(out_dir, "ckpt"))
    return inputs


def gloo_start(out_dir: str) -> "subprocess.Popen":
    """Start the rehearsal's processes on ``out_dir``'s inputs."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.gloo_spawn({out_dir!r})")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=out_dir)


def gloo_results(proc, out_dir: str, timeout: float) -> dict:
    """Wait for the rehearsal (killing it at ``timeout``), raise on a
    failure, and return what rank 0 measured."""
    import pickle

    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0,
          f"the gloo rehearsal exited {proc.returncode}: {err[-4000:]}")
    with open(os.path.join(out_dir, "results.pkl"), "rb") as f:
        return pickle.load(f)


def gloo_spawn(out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(gloo_rank, args=(out_dir,), nprocs=GLOO_PROCS)


def gloo_rank(rank: int, out_dir: str) -> None:
    """One rank of the rehearsal; rank 0 writes ``results.pkl``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "pg"),
        rank=rank, world_size=GLOO_PROCS)
    try:
        out = gloo_measure(np, torch, out_dir)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
            pickle.dump(out, f)


def gloo_measure(np, torch, out_dir: str) -> dict:
    import pickle

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import ring_bytes
    from repro_torch.models import (
        abstract_cache,
        cache_logical_axes,
        forward,
        init_cache,
        init_params,
        loss_fn,
        moe,
    )
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.layers import (
        Sharder,
        meshed,
        tree_leaves_with_path,
        tree_map,
    )
    from repro_torch.optim import adamw_init
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import (
        make_rules,
        param_shardings,
        place,
        placements,
        tree_shardings,
    )
    from repro_torch.train import make_serve_step, make_train_step
    from repro_torch.train.step import place_input

    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_host_mesh(model=GLOO_MODEL, device="cpu")
    mesh41 = make_host_mesh(model=1, device="cpu")
    train = make_rules("train")
    tokens = torch.from_numpy(inputs["tokens"])
    labels = torch.roll(tokens, -1, 1)
    batch = {"tokens": tokens, "labels": labels}
    out = {"mesh": tuple(mesh.shape), "mesh41": tuple(mesh41.shape),
           "torch": torch.__version__}
    models = {label: params_from_jax(tree, gloo_model_config(label), "cpu")
              for label, tree in inputs["models"].items()}

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def max_abs(a, b) -> float:
        other = dict(tree_leaves_with_path(b))
        return max(float((full(t) - full(other[k])).abs().max())
                   for k, t in tree_leaves_with_path(a))

    def meshed_forward(cfg, params, m, toks):
        shd = Sharder(m, train)
        with torch.no_grad(), meshed(shd):
            return full(forward(params, cfg, toks, shd)[0])

    # each model's meshed forward, and the unmeshed one
    out["forward"], out["unmeshed"] = {}, {}
    for label, params in models.items():
        cfg = gloo_model_config(label)
        out["forward"][label] = meshed_forward(cfg, place(
            params, param_shardings(cfg, train, mesh)), mesh, tokens).numpy()
        with torch.no_grad():
            out["unmeshed"][label] = forward(params, cfg, tokens)[0].numpy()

    # the expert-parallel all-to-all against dispatch, forward and
    # gradient, on the same mesh
    cfg_a, cfg_d = gloo_model_config("moe"), gloo_model_config(
        "moe-dispatch")
    moe_params = init_params(cfg_d, torch.Generator().manual_seed(0))
    placed = {id(m): place(moe_params, param_shardings(cfg_d, train, m))
              for m in (mesh, mesh41)}
    calls = []
    a2a = moe.moe_apply_alltoall
    moe.moe_apply_alltoall = lambda *a: (calls.append(1), a2a(*a))[1]
    try:
        ld = meshed_forward(cfg_d, placed[id(mesh)], mesh, tokens)
        la = meshed_forward(cfg_a, placed[id(mesh)], mesh, tokens)
        out["a2a_calls"] = len(calls)
        out["a2a_err"] = float((ld - la).abs().max())

        def grads(cfg):
            shd = Sharder(mesh, train)
            pp = placed[id(mesh)]
            with meshed(shd):
                leaves = [t.detach().requires_grad_(True)
                          for _, t in tree_leaves_with_path(pp)]
                it = iter(leaves)
                live = tree_map(lambda _: next(it), pp)
                # the cross-entropy alone: the aux loss of the all-to-all
                # is the mean of each token slice's, as the reference's
                # is, not dispatch's over all the tokens
                loss = loss_fn(live, cfg, place_input(shd, "tokens", tokens,
                                                      "cpu"),
                               place_input(shd, "labels", labels, "cpu"),
                               shd, aux_coeff=0.0)[0]
                return {k: full(g) for (k, _), g in zip(
                    tree_leaves_with_path(pp),
                    torch.autograd.grad(loss, leaves))}

        ga, gd = grads(cfg_a), grads(cfg_d)
        # the all-to-all path's gradient at the other remats: the same bits
        out["a2a_remat_equal"] = {
            remat: all(torch.equal(g, ga[k]) for k, g in grads(
                cfg_a.scaled(remat=remat)).items())
            for remat in ("dots", "full")}
        out["a2a_grad_norm_sq"] = sum(float((g.float() ** 2).sum())
                                      for g in ga.values())
        out["a2a_grad_rel"] = {
            "/".join(k): float((ga[k] - gd[k]).abs().max()
                               / max(float(gd[k].norm()), 1e-30))
            for k in gd}
        # where the reference takes dispatch: model = 1, and a local token
        # count (2 // 2 x 3 = 3) that does not divide by model = 2
        calls.clear()
        out["model1_err"] = float((meshed_forward(
            cfg_a, placed[id(mesh41)], mesh41, tokens) - ld).abs().max())
        out["model1_calls"] = len(calls)
        odd = tokens[:2, :3]
        out["odd_err"] = float((meshed_forward(
            cfg_a, placed[id(mesh)], mesh, odd) - ld[:2, :3]).abs().max())
        out["odd_calls"] = len(calls)
    finally:
        moe.moe_apply_alltoall = a2a
    out["applies"] = {
        "2x2": moe.alltoall_applies(cfg_a, mesh, tokens.shape),
        "4x1": moe.alltoall_applies(cfg_a, mesh41, tokens.shape),
        "odd": moe.alltoall_applies(cfg_a, mesh, odd.shape),
        "dispatch": moe.alltoall_applies(cfg_d, mesh, tokens.shape)}

    # one train step of the dense model, meshed against unmeshed (the
    # all-to-all's aux loss is not dispatch's, so its step is not held to
    # the unmeshed one)
    out["train"] = {}
    for label, cfg, params in (("dense", gloo_model_config("dense"),
                                models["dense"]),):
        p1, _, m1 = make_train_step(cfg, warmup_steps=0)(
            params, adamw_init(params), batch)
        pp = place(params, param_shardings(cfg, train, mesh))
        p2, o2, m2 = make_train_step(cfg, mesh, train, warmup_steps=0)(
            pp, adamw_init(pp), batch)
        params2 = dict(tree_leaves_with_path(p2))
        out["train"][label] = {
            "param_max_abs": max_abs(p1, p2),
            "lr": float(m1["lr"]),
            "loss": (float(m1["loss"]), float(m2["loss"])),
            "grad_norm": (float(m1["grad_norm"]), float(m2["grad_norm"])),
            "moments_placed": all(
                m.placements == params2[k].placements
                for k, m in tree_leaves_with_path(o2.mu)),
            "step": int(o2.step),
            "params_placed": all(
                t.placements == q.placements for (_, t), (_, q)
                in zip(tree_leaves_with_path(p2), tree_leaves_with_path(pp)))}
        # the same meshed step at remat="full": the same bits, and the
        # collectives its backward's recompute issues again
        log = collective_log(torch)
        with log:
            p3, _, m3 = make_train_step(cfg.scaled(remat="full"), mesh, train,
                                        warmup_steps=0)(pp, adamw_init(pp),
                                                        batch)
        out["remat_full"] = {
            "params_equal": all(torch.equal(full(t), full(params2[k]))
                                for k, t in tree_leaves_with_path(p3)),
            "metrics_equal": all(torch.equal(m3[k], m2[k])
                                 for k in ("loss", "grad_norm")),
            "collectives": collective_totals(log.ops, ring_bytes)}

    # greedy tokens, meshed against unmeshed
    out["serve"] = {}
    prompts = inputs["prompts"]
    for label, params in models.items():
        cfg = gloo_model_config(label)
        want = ServeEngine(cfg, params, GLOO_MAX_LEN, device="cpu").generate(
            prompts, GLOO_NEW)
        got = ServeEngine(cfg, place(params, param_shardings(
            cfg, make_rules("decode"), mesh)), GLOO_MAX_LEN,
            mesh=mesh).generate(prompts, GLOO_NEW)
        out["serve"][label] = (want.tokens, got.tokens)

    # the checkpoint onto two meshes, and one the port saves across them
    cfg, params = gloo_model_config("dense"), models["dense"]
    ck = Checkpointer(os.path.join(out_dir, "ckpt"))
    out["ckpt"] = {}
    for name, m in (("4x1", mesh41), ("2x2", mesh)):
        shardings = param_shardings(cfg, train, m)
        got = ck.restore(1, params, shardings=shardings)
        want = dict(tree_leaves_with_path(shardings))
        out["ckpt"][name] = {
            "/".join(k): (t.full_tensor().numpy(),
                          t.placements == placements(want[k].spec, m),
                          t.device_mesh is m)
            for k, t in tree_leaves_with_path(got)}
    port = Checkpointer(os.path.join(out_dir, "port_ckpt"))
    port.save(3, got)
    back = port.restore(3, params,
                        shardings=param_shardings(cfg, train, mesh41))
    out["ckpt"]["port 2x2 -> 4x1"] = {
        "/".join(k): (t.full_tensor().numpy(), True, True)
        for k, t in tree_leaves_with_path(back)}

    # the collectives of each step (every rank issues the same)
    out["collectives"] = {}
    for step, label in GLOO_COLLECTIVE_CASES:
        cfg = gloo_model_config(label)
        params = moe_params if label.startswith("moe") else models[label]
        log = collective_log(torch)
        if step == "decode":
            decode = make_rules("decode", cfg.decode_rule_overrides)
            pd = place(params, param_shardings(cfg, decode, mesh))
            cache = place(init_cache(cfg, GLOO_BATCH, GLOO_SEQ, "cpu"),
                          tree_shardings(
                              cache_logical_axes(cfg, GLOO_BATCH, GLOO_SEQ),
                              decode, mesh,
                              abstract_cache(cfg, GLOO_BATCH, GLOO_SEQ)))
            serve = make_serve_step(cfg, mesh, decode)
            with torch.no_grad(), log:
                serve(pd, cache, tokens[:, :1], GLOO_PROMPT)
        elif step == "forward":
            pp = place(params, param_shardings(cfg, train, mesh))
            shd = Sharder(mesh, train)
            with torch.no_grad(), meshed(shd), log:
                loss_fn(pp, cfg, place_input(shd, "tokens", tokens, "cpu"),
                        place_input(shd, "labels", labels, "cpu"), shd)
        else:
            pp = place(params, param_shardings(cfg, train, mesh))
            step_fn = make_train_step(cfg, mesh, train, warmup_steps=0)
            opt = adamw_init(pp)
            with log:
                step_fn(pp, opt, batch)
        out["collectives"][step, label] = collective_totals(log.ops,
                                                            ring_bytes)
    return out


def shard_float32_check(np, torch, mesh, card: str) -> dict:
    """qwen2-0.5b x2 float32: the meshed forward (train rules) and decode
    over the prompt (decode rules) against the unmeshed ones on the
    card."""
    from repro_torch.models import (
        abstract_cache,
        cache_logical_axes,
        decode_step,
        forward,
        init_cache,
        init_params,
    )
    from repro_torch.models.layers import Sharder, meshed
    from repro_torch.sharding import (
        make_rules,
        param_shardings,
        place,
        tree_shardings,
    )

    cfg = float32_config(LM_ARCH, num_layers=TRAIN_CHECK_LAYERS)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (SHARD_CHECK_BATCH, SHARD_CHECK_PROMPT)).astype(
            np.int32)).to(DEV)
    train, decode = make_rules("train"), make_rules("decode")
    b, p = tokens.shape
    with torch.no_grad():
        want = forward(params, cfg, tokens)[0]
        shd = Sharder(mesh, train)
        with meshed(shd):
            got = forward(place(params, param_shardings(cfg, train, mesh)),
                          cfg, tokens, shd)[0].full_tensor()
        scale = float(want.abs().max())
        fwd_err = float((got - want).abs().max())
        placed = place(params, param_shardings(cfg, decode, mesh))
        cache = init_cache(cfg, b, p, DEV)
        mcache = place(init_cache(cfg, b, p, DEV), tree_shardings(
            cache_logical_axes(cfg, b, p), decode, mesh,
            abstract_cache(cfg, b, p)))
        shd = Sharder(mesh, decode)
        dec_err = 0.0
        for i in range(p):
            step = tokens[:, i:i + 1]
            w, cache = decode_step(params, cfg, cache, step, i)
            with meshed(shd):
                g, mcache = decode_step(placed, cfg, mcache, step, i, shd)
            dec_err = max(dec_err, float((g.full_tensor() - w).abs().max()))
    bound = LM_REL_BOUND * scale
    check(fwd_err <= bound, f"shard [{LM_ARCH} x{TRAIN_CHECK_LAYERS}]: "
                            f"meshed forward differs by {fwd_err} > {bound}")
    check(dec_err <= bound, f"shard [{LM_ARCH} x{TRAIN_CHECK_LAYERS}]: "
                            f"meshed decode differs by {dec_err} > {bound}")
    del params, placed, cache, mcache, want, got
    free_card(torch)
    print(f"shard [{LM_ARCH} x{TRAIN_CHECK_LAYERS} float32]: on the (1, 1) "
          f"mesh, forward (train rules) against unmeshed max abs "
          f"{fwd_err:.3e}, decode over {p} positions (decode rules, the "
          f"cache written into its local shard) {dec_err:.3e}; bound "
          f"{bound:.3e} ({LM_REL_BOUND:g} of max|logit| {scale:.3f}); {card}",
          flush=True)
    return {"forward_max_abs": fwd_err, "decode_max_abs": dec_err,
            "bound": bound}


def shard_serve_leg(np, torch, mesh, card: str) -> dict:
    """qwen2-0.5b at full depth in bfloat16: ``ServeEngine(mesh=...)``
    against the unmeshed engine, greedy tokens equal, decode ms a step of
    each (CUDA events, median), and the reckoned per-device parameter
    bytes against the placed local shards."""
    from repro_torch.launch.dryrun import param_bytes_per_device
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves_with_path
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import make_rules, param_shardings, place

    cfg = lm_config(LM_ARCH)
    decode = make_rules("decode", cfg.decode_rule_overrides)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    placed = place(params, param_shardings(cfg, decode, mesh))
    reckoned = param_bytes_per_device(cfg, decode, mesh)
    local = sum(t.to_local().numel() * t.to_local().element_size()
                for _, t in tree_leaves_with_path(placed))
    check(local == reckoned, f"shard: {local} placed parameter bytes, "
                             f"{reckoned} reckoned")
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    max_len = LM_PROMPT + SHARD_SERVE_NEW
    engines = {"unmeshed": (ServeEngine(cfg, params, max_len, device=DEV),
                            params),
               "meshed": (ServeEngine(cfg, placed, max_len, mesh=mesh),
                          placed)}
    out = {"param_bytes_reckoned": reckoned, "param_bytes_placed": local}
    tokens = {}
    for name, (eng, p) in engines.items():
        eng.generate(prompts, 4)          # warm-up
        t0 = time.perf_counter()
        tokens[name] = eng.generate(prompts, SHARD_SERVE_NEW).tokens
        gen_s = time.perf_counter() - t0
        with torch.no_grad():
            logits, cache = eng._prefill(p, torch.from_numpy(prompts).to(DEV))
            cache = eng._decode_cache(cache)
            tok = eng._sample(logits, 0.0, None)
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(SHARD_SERVE_NEW + 1)]
            marks[0].record()
            for i in range(SHARD_SERVE_NEW):
                logits, cache = eng._serve(p, cache, tok, LM_PROMPT + i)
                tok = eng._sample(logits, 0.0, None)
                marks[i + 1].record()
            marks[-1].synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        out[name] = {"generate_s": gen_s,
                     "decode_ms": statistics.median(step_ms),
                     "decode_step_ms": step_ms}
        del cache, logits
    check(np.array_equal(tokens["meshed"], tokens["unmeshed"]),
          "shard: the meshed engine's greedy tokens differ from the "
          "unmeshed engine's")
    ratio = out["meshed"]["decode_ms"] / out["unmeshed"]["decode_ms"]
    out["decode_ratio"] = ratio
    del engines, params, placed
    free_card(torch)
    print(f"shard [{LM_ARCH} {cfg.param_dtype}]: ServeEngine(mesh=...) on "
          f"the (1, 1) mesh, batch {LM_BATCH}, prompt {LM_PROMPT}, "
          f"{SHARD_SERVE_NEW} new tokens: greedy tokens equal to the "
          f"unmeshed engine's; decode {out['meshed']['decode_ms']:.3f} ms a "
          f"step meshed against {out['unmeshed']['decode_ms']:.3f} unmeshed "
          f"(median, CUDA events; {ratio:.2f}x, DTensor's dispatch); "
          f"generate {out['meshed']['generate_s']:.3f} s against "
          f"{out['unmeshed']['generate_s']:.3f} s; parameter bytes on the "
          f"device {local:,}, as reckoned; {card}", flush=True)
    return out


def shard_moe_and_train(np, torch, mesh, card: str) -> dict:
    """phi3.5-moe x2 float32 under the mesh against unmeshed (with
    ``moe_impl="alltoall"``: model = 1, so the path is dispatch, as in
    the reference), then one meshed train step of qwen2-0.5b x2 against
    the unmeshed one."""
    from repro_torch.models import forward, init_params, moe
    from repro_torch.models.layers import Sharder, meshed
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import make_rules, param_shardings, place
    from repro_torch.train import make_train_step
    from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig

    train = make_rules("train")
    cfg = float32_config(LM_MOE_ARCH, num_layers=LM_FAMILY_LAYERS,
                         moe_impl="alltoall")
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (SHARD_CHECK_BATCH, SHARD_CHECK_PROMPT)).astype(
            np.int32)).to(DEV)
    applies = moe.alltoall_applies(cfg, mesh, tuple(tokens.shape))
    check(not applies, "shard: the all-to-all path on a model = 1 mesh")
    calls = []
    a2a = moe.moe_apply_alltoall
    moe.moe_apply_alltoall = lambda *a: (calls.append(1), a2a(*a))[1]
    try:
        with torch.no_grad():
            want = forward(params, cfg, tokens)[0]
            shd = Sharder(mesh, train)
            with meshed(shd):
                got = forward(place(params, param_shardings(cfg, train,
                                                             mesh)),
                              cfg, tokens, shd)[0].full_tensor()
    finally:
        moe.moe_apply_alltoall = a2a
    check(not calls, "shard: moe_apply_alltoall ran on a model = 1 mesh")
    moe_err = float((got - want).abs().max())
    moe_bound = LM_REL_BOUND * float(want.abs().max())
    check(moe_err <= moe_bound, f"shard [{LM_MOE_ARCH}]: meshed forward "
                                f"differs by {moe_err} > {moe_bound}")
    del params, want, got
    free_card(torch)
    print(f"shard [{LM_MOE_ARCH} x{LM_FAMILY_LAYERS} float32]: "
          f"moe_impl=alltoall on the (1, 1) mesh takes dispatch (model = 1, "
          f"as the reference does); meshed forward against unmeshed max abs "
          f"{moe_err:.3e} (bound {moe_bound:.3e}); {card}", flush=True)

    cfg = float32_config(TRAIN_ARCH, num_layers=TRAIN_CHECK_LAYERS)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    batch = TokenDataset(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_CHECK_SEQ,
        global_batch=TRAIN_CHECK_BATCH)).batch(0)
    p1, _, m1 = make_train_step(cfg, warmup_steps=0)(
        params, adamw_init(params), batch)
    placed = place(params, param_shardings(cfg, train, mesh))
    p2, _, m2 = make_train_step(cfg, mesh, train, warmup_steps=0)(
        placed, adamw_init(placed), batch)
    lr = float(m1["lr"])
    param_err = tree_max_abs(p1, p2)
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(
        float(m1["loss"]))
    check(param_err <= TRAIN_PARAM_LR_SHARE * lr,
          f"shard: the meshed train step's parameters differ by "
          f"{param_err} > {TRAIN_PARAM_LR_SHARE * lr}")
    check(loss_rel <= TRAIN_REL_BOUND,
          f"shard: the meshed train step's loss differs by {loss_rel}")
    del params, placed, p1, p2
    free_card(torch)
    print(f"shard [{TRAIN_ARCH} x{TRAIN_CHECK_LAYERS} float32]: one meshed "
          f"train step against the unmeshed one: parameters max abs "
          f"{param_err:.3e} (bound {TRAIN_PARAM_LR_SHARE * lr:.3e}, "
          f"{TRAIN_PARAM_LR_SHARE:g} of lr), loss relative {loss_rel:.3e}; "
          f"{card}", flush=True)
    return {"moe_max_abs": moe_err, "moe_bound": moe_bound,
            "moe_path": "dispatch", "train_param_max_abs": param_err,
            "train_param_bound": TRAIN_PARAM_LR_SHARE * lr,
            "train_loss_rel": loss_rel}


def shard_phase(np, torch, card: str) -> dict:
    """Phase 10: the LM dry run and the meshed LM paths on a one-rank
    mesh, then the gloo rehearsal on the host alone, every kernel launch
    counter set to 0 just before (they launch none of the nine
    kernels)."""
    t_phase = time.perf_counter()
    modules = reset_kernel_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    shard_card_legs(np, torch, card, report)
    report["gloo"] = shard_gloo_leg(np, torch)
    launches = check_no_kernel_launched(modules, "sharding")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10 (sharding, LM dry run): {report['seconds']:.1f} s; "
          f"the meshed paths launched none of the nine kernels "
          f"{json.dumps(launches)}", flush=True)
    return report


def shard_gloo_leg(np, torch) -> dict:
    """The gloo rehearsal on the host's CPU and its torch, after the
    card's legs: each meshed result against the port's unmeshed one (the
    tests hold the same run against the JAX package), and the collectives
    each step issued beside ``dryrun.reckon_collectives``."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import reckon_collectives
    from repro_torch.models import init_params
    from repro_torch.models.layers import tree_leaves_with_path, tree_map
    from repro_torch.sharding import AbstractMesh, make_rules

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        params = {label: init_params(gloo_model_config(label),
                                     torch.Generator().manual_seed(0))
                  for label in GLOO_MODELS}
        gloo_write_inputs(
            np, out_dir, {label: tree_map(lambda t: t.numpy(), p)
                          for label, p in params.items()},
            lambda path: Checkpointer(path).save(1, params["dense"]))
        got = gloo_results(gloo_start(out_dir), out_dir, GLOO_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for label in GLOO_MODELS:
        check(np.allclose(got["forward"][label], got["unmeshed"][label],
                          atol=GLOO_FWD_ATOL, rtol=GLOO_FWD_RTOL),
              f"shard: the gloo rehearsal's meshed {label} forward differs "
              f"from the unmeshed one")
        want, tokens = got["serve"][label]
        check(np.array_equal(want, tokens), f"shard: the gloo rehearsal's "
                                            f"meshed {label} greedy tokens "
                                            f"differ")
    grad_rel = max(got["a2a_grad_rel"].values())
    check(got["a2a_calls"] == 2 and got["a2a_err"] < GLOO_A2A_BOUND
          and np.isfinite(got["a2a_grad_norm_sq"])
          and got["a2a_grad_norm_sq"] > 0 and grad_rel <= GLOO_GRAD_REL,
          f"shard: the all-to-all against dispatch: {got['a2a_calls']} "
          f"calls, {got['a2a_err']}, gradient {grad_rel}")
    check(got["applies"] == {"2x2": True, "4x1": False, "odd": False,
                             "dispatch": False}
          and got["model1_calls"] == got["odd_calls"] == 0
          and max(got["model1_err"], got["odd_err"]) < GLOO_A2A_BOUND,
          f"shard: the all-to-all where the reference takes dispatch: "
          f"{got['applies']}")
    for label, t in got["train"].items():
        check(t["step"] == 1 and t["moments_placed"] and t["params_placed"]
              and t["param_max_abs"] <= TRAIN_PARAM_LR_SHARE * t["lr"],
              f"shard: the gloo rehearsal's meshed {label} train step: {t}")
    full = got["remat_full"]
    check(full["params_equal"] and full["metrics_equal"]
          and all(got["a2a_remat_equal"].values()),
          f"shard: the gloo rehearsal's meshed steps at other remats differ: "
          f"dense at full {full['params_equal']}, {full['metrics_equal']}; "
          f"the all-to-all's gradient {got['a2a_remat_equal']}")
    dense = {"/".join(k): t.numpy()
             for k, t in tree_leaves_with_path(params["dense"])}
    for name, leaves in got["ckpt"].items():
        check(set(leaves) == set(dense) and all(
            np.array_equal(full, dense[k]) and placed and on_mesh
            for k, (full, placed, on_mesh) in leaves.items()),
            f"shard: the checkpoint restored {name} differs")
    # the collectives against the reckoning (a reading, not a check: the
    # tests hold torch 2.13's to it)
    mesh = AbstractMesh(got["mesh"], ("data", "model"))
    reading = {}
    for (step, label), m in got["collectives"].items():
        cfg = gloo_model_config(label)
        kind = "decode" if step == "decode" else "train"
        shape = ShapeConfig("t", kind, GLOO_SEQ, GLOO_BATCH)
        rules = make_rules(kind, cfg.decode_rule_overrides
                           if kind == "decode" else None)
        r = reckon_collectives(cfg, shape, mesh, rules)
        if step == "train":
            reading[f"{step} {label}"] = {
                "measured_bytes": sum(m["all"]["bytes"].values()),
                "reckoned_bytes": r["total"]}
        else:
            want = {k: (r["forward"]["counts"][k], r["forward"]["bytes"][k])
                    for k in r["forward"]["counts"]
                    if r["forward"]["counts"][k]}
            have = {k: (m["all"]["counts"][k], m["all"]["bytes"][k])
                    for k in m["all"]["counts"]}
            reading[f"{step} {label}"] = {"equal": have == want,
                                          "measured": have}
    # the dense step at remat="full": its recompute's collectives on top
    reading["train dense remat=full"] = {
        "measured_bytes": sum(full["collectives"]["all"]["bytes"].values()),
        "reckoned_bytes": reading["train dense"]["reckoned_bytes"]}
    print(f"shard: the gloo rehearsal ({GLOO_PROCS} processes, mesh "
          f"{got['mesh']}, torch {got['torch']}) in {seconds:.1f} s: dense "
          f"and MLA forward against unmeshed within atol {GLOO_FWD_ATOL:g} "
          f"rtol {GLOO_FWD_RTOL:g}, greedy tokens equal; the all-to-all "
          f"against dispatch {got['a2a_err']:.3e}, its gradient within "
          f"{grad_rel:.3e} of each leaf's norm, the same bits at remat "
          f"dots and full; the dense train step within "
          f"{TRAIN_PARAM_LR_SHARE:g} of lr, the same bits at remat full; the "
          f"checkpoint restored onto (4, 1) and (2, 2); collectives "
          f"against the reckoning {json.dumps(reading)}", flush=True)
    return {"seconds": seconds, "a2a_err": got["a2a_err"],
            "a2a_grad_rel": grad_rel, "torch": got["torch"],
            "collectives": reading}


def shard_card_legs(np, torch, card: str, report: dict) -> None:
    """Phase 10's legs on the card: the dry run, then a one-rank process
    group's (1, 1) mesh."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    # every LM cell of the sweep, reckoned: nothing allocated
    total = torch.cuda.get_device_properties(0).total_memory
    before = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        failed = dryrun.run_lm_cells(out)
        sweep_s = time.perf_counter() - t0
        recs = [json.load(open(p)) for p in sorted(glob.glob(
            os.path.join(out, "*.json")))]
    check(not failed and recs and all(r["ok"] and r["reckoned"]
                                      for r in recs),
          f"shard: {failed} dry-run cells failed")
    check(torch.cuda.memory_allocated() == before,
          "shard: the dry run allocated on the card")
    over = sorted(f"{r['arch']} x {r['shape']} x {r['mesh']}" for r in recs
                  if r["memory"]["argument_size_in_bytes"] > total)
    report["dryrun"] = {"cells": len(recs), "seconds": sweep_s,
                        "over_total_memory": over, "total_memory": total}
    print(f"shard: the LM dry run reckoned {len(recs)} cells, every one ok, "
          f"in {sweep_s:.2f} s, memory_allocated unchanged; per-device "
          f"argument bytes above the card's {total:,} B: {len(over)} cells "
          f"{json.dumps(over)}; {card}", flush=True)

    # a one-rank process group and its (1, 1) mesh
    with tempfile.TemporaryDirectory() as tmp:
        if DEV == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            SHARD_BACKEND, store=dist.FileStore(os.path.join(tmp, "pg"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_host_mesh(device=DEV)
            check(tuple(mesh.shape) == (1, 1)
                  and mesh.mesh_dim_names == ("data", "model")
                  and mesh.device_type == DEV,
                  f"shard: make_host_mesh gave {mesh}")
            print(f"shard: {SHARD_BACKEND} process group of one rank, "
                  f"make_host_mesh() = {tuple(mesh.shape)} "
                  f"{mesh.mesh_dim_names} on {mesh.device_type}", flush=True)
            report["float32"] = shard_float32_check(np, torch, mesh, card)
            report["serve"] = shard_serve_leg(np, torch, mesh, card)
            report.update(shard_moe_and_train(np, torch, mesh, card))
        finally:
            dist.destroy_process_group()


def lowering_phase(np, torch, card: str, serve_masks, scene) -> dict:
    """Phase 7: ``Engine.lower`` and compile on the card, allocating
    nothing; each cell run once against its plan (launches, output types,
    peak memory); the workload's dry run; the data pipeline at the serving
    width; the five examples as processes. Returns each kernel's launches
    in the phase (counted from zero; the examples launch in their own
    processes)."""
    from repro_torch.data.pipeline import (
        Prefetcher,
        anyres_select,
        filter_empty_tiles,
        ychg_stats,
    )
    from repro_torch.configs.ychg_modis import config as workload_config
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.engine import ops as engine_ops
    from repro_torch.examples.satellite_roi import tile_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels import ccl as kccl
    from repro_torch.kernels import denoise as kdn
    from repro_torch.kernels import ychg_colscan as kc
    from repro_torch.kernels import ychg_fused as kf
    from repro_torch.kernels import ychg_packed as kp
    from repro_torch.launch.compilecache import enable_compile_cache
    from repro_torch.launch.dryrun import run_ychg_cells
    from repro_torch.launch.serve import export_pythonpath

    t_phase = time.perf_counter()
    modules = (kf, kc, kdn, kccl, kp)
    for module in modules:
        module.reset_launch_counts()

    def counts() -> dict:
        return {k: v for m in modules for k, v in m.LAUNCHES.items()}

    def allocated() -> int:
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def requested() -> tuple:
        """Bytes the tensors asked of the allocator: now and at the peak."""
        stats = torch.cuda.memory_stats()
        return (stats.get("requested_bytes.all.current", 0),
                stats.get("requested_bytes.all.peak", 0))

    shapes = {"serving batch": (SERVE_BATCH, SERVE_RES, SERVE_RES),
              "scene": (1, SCENE_RES, SCENE_RES),
              "tall strip": (1, TALL_MASKS * SERVE_RES, SERVE_RES)}
    engines = {(op, backend): Engine(EngineConfig(
        backend=backend, stream_vmem_budget=STREAM_VMEM_BUDGET), op=op)
        for _, op, backend in LOWER_CELLS}

    # lowering and compiling allocate nothing: first cold, each kernel
    # cell's sources built by nvcc into an empty directory, then cached
    built_in = _build.BUILD_DIR
    compiled = {}
    with tempfile.TemporaryDirectory() as cold_dir:
        enable_compile_cache(cold_dir)
        for source in ("ychg_fused", "ychg_colscan", "ccl", "denoise"):
            _build._LIBS.pop(source, None)
        try:
            for temp in ("cold", "cached"):
                for label, op, backend in LOWER_CELLS:
                    before = allocated()
                    t0 = time.perf_counter()
                    lowered = engines[op, backend].lower(shapes[label])
                    t1 = time.perf_counter()
                    c = lowered.compile()
                    t2 = time.perf_counter()
                    after = allocated()
                    check(after == before,
                          f"lower [{label}, {op}, {backend}] allocated "
                          f"{after - before} bytes on the card")
                    compiled[label, op, backend] = c
                    if backend in ("fused", "cuda") and op == "ychg":
                        route = "splith" if label == "tall strip" else "full"
                        check(c.route == route,
                              f"lower [{label}, {op}, {backend}] routes "
                              f"{c.route}, not {route}")
                    cost = c.cost_analysis()
                    print(f"lower: {op} [{backend}] {label} "
                          f"{list(shapes[label])} uint8 ({temp}): lower "
                          f"{(t1 - t0) * 1e3:.3f} ms, compile "
                          f"{(t2 - t1) * 1e3:.3f} ms (nvcc "
                          f"{json.dumps(c.build_seconds)}), route "
                          f"{c.route}, launches "
                          f"{json.dumps(cost['launches'])}, bytes "
                          f"{cost['bytes accessed']:.0f} (kernels "
                          f"{cost['kernel bytes']}, ops {cost['op bytes']}); "
                          f"memory_allocated +0", flush=True)
        finally:
            _build.BUILD_DIR = built_in

    # the lowering predicts the run: launches, output types, peak memory
    inputs = {"serving batch": torch.from_numpy(
        np.stack(serve_masks[:SERVE_BATCH])).to(DEV)}
    inputs["tall strip"] = inputs["serving batch"][:TALL_MASKS].reshape(
        shapes["tall strip"])
    inputs["scene"] = torch.from_numpy(scene).to(DEV)[None]
    measure_peak = DEV == "cuda"   # a CPU keeps no allocator statistics
    for label, op, backend in LOWER_CELLS:
        c = compiled[label, op, backend]
        mem = c.memory_analysis()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        base, asked = allocated(), requested()[0]
        res = engines[op, backend].analyze_batch(
            inputs[label]).block_until_ready()
        peak = torch.cuda.max_memory_allocated() - base
        asked_peak = requested()[1] - asked
        delta = {k: n - before[k] for k, n in counts().items()
                 if n != before[k]}
        check(delta == c.cost_analysis()["launches"],
              f"run [{label}, {op}, {backend}] launched {delta}, the "
              f"lowering said {c.cost_analysis()['launches']}")
        for f in engine_ops.get_op(op).fields:
            want, got = getattr(c.out_info, f), getattr(res, f)
            check(tuple(got.shape) == want.shape and got.dtype == want.dtype,
                  f"run [{label}, {op}, {backend}] field {f} is "
                  f"{got.dtype} {tuple(got.shape)}, out_info "
                  f"{want.dtype} {want.shape}")
        rounded = hi = None
        if mem.temp_size_in_bytes is not None:
            blocks = [-(-a.nbytes // ALLOC_ROUND) * ALLOC_ROUND
                      for a in c.lowered.plan.allocations]
            rounded = sum(blocks)
            hi = rounded + sum(ALLOC_UNSPLIT for n in blocks
                               if n > ALLOC_UNSPLIT)
        if measure_peak and (op, backend) in PEAK_CHECKED:
            check(mem.output_size_in_bytes <= peak <= hi,
                  f"run [{label}, {op}, {backend}] peak {peak} B above the "
                  f"stack, outside [{mem.output_size_in_bytes}, {hi}]")
            most = mem.output_size_in_bytes + mem.temp_size_in_bytes
            check(mem.output_size_in_bytes <= asked_peak <= most,
                  f"run [{label}, {op}, {backend}] requested peak "
                  f"{asked_peak} B, outside [{mem.output_size_in_bytes}, "
                  f"{most}]")
        peak_text = (f"{peak} B (requested {asked_peak} B)" if measure_peak
                     else "not measured")
        print(f"run: {op} [{backend}] {label}: launches {json.dumps(delta)} "
              f"as lowered, fields as out_info; peak above the stack "
              f"{peak_text} against output "
              f"{mem.output_size_in_bytes} B, output + temp "
              f"{mem.output_size_in_bytes + (mem.temp_size_in_bytes or 0)} B"
              f" (temp {mem.temp_size_in_bytes}), each tensor rounded up to "
              f"{ALLOC_ROUND} B {rounded}, with the allocator's unsplit "
              f"remainders {hi}"
              + ("; checked" if measure_peak and (op, backend) in PEAK_CHECKED
                 else ""), flush=True)
        del res
    del inputs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the workload's dry run: every resolution at its batch, nothing
    # allocated (8 x 21000^2 is 3.5 GB)
    before = allocated()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        failed = run_ychg_cells(out_dir, max_res=DRYRUN_MAX_RES, device=DEV)
        records = [json.loads(Path(p).read_text()) for p in
                   glob.glob(os.path.join(out_dir, "*.json"))]
    dry_s = time.perf_counter() - t0
    check(allocated() == before, "the dry run allocated on the card")
    wl = workload_config()
    want_res = sorted(r for r in wl.resolutions if r <= DRYRUN_MAX_RES)
    check(failed == 0 and all(r["ok"] for r in records)
          and sorted(r["resolution"] for r in records) == want_res
          and all(r["batch"] == wl.batch for r in records),
          f"dry run: {failed} failed cells, "
          f"{[(r['resolution'], r['ok']) for r in records]}")
    for r in sorted(records, key=lambda r: r["resolution"]):
        print(f"dryrun: b{r['batch']} {r['resolution']}^2 [{r['backend']}, "
              f"route {r['route']}]: build s {json.dumps(r['build_s'])}, "
              f"bytes {r['cost']['bytes_accessed']:.0f}, bound "
              f"{r['bound_ms']:.4f} ms, launches {json.dumps(r['kernels'])}, "
              f"argument {r['memory']['argument_size_in_bytes']} B never "
              f"allocated", flush=True)
    print(f"dryrun: {len(records)} cells ok in {dry_s:.2f} s; "
          f"memory_allocated unchanged; {card}", flush=True)

    # the pipeline at the serving width: one fused launch a batch, each
    # batch's stats equal to the torch engine's on the card
    fused = Engine(EngineConfig(backend="fused"))
    plain = Engine(EngineConfig(backend="torch"))
    mask = serve_masks[0]
    n_batches = n_tiles = n_kept = 0
    t0 = time.perf_counter()
    for batch in Prefetcher(tile_stream(mask, PIPELINE_TILE), depth=2):
        launched = kf.LAUNCHES["ychg_fused_full"]
        stats = ychg_stats(batch, engine=fused)
        kept = filter_empty_tiles(batch, stats=stats)
        check(kf.LAUNCHES["ychg_fused_full"] - launched == 1,
              "pipeline: a batch took other than one ychg_fused_full launch")
        n_batches += 1
        n_tiles += len(batch)
        n_kept += len(kept)
    pipe_s = time.perf_counter() - t0
    for batch in tile_stream(mask, PIPELINE_TILE):
        got, want = (ychg_stats(batch, engine=fused),
                     ychg_stats(batch, engine=plain))
        check(all(got[k].dtype == want[k].dtype
                  and np.array_equal(got[k], want[k]) for k in want),
              "pipeline: fused stats differ from the torch engine's")
    picks = anyres_select(mask, ANYRES_TILE, ANYRES_K, engine=fused)
    check(picks == anyres_select(mask, ANYRES_TILE, ANYRES_K, engine=plain),
          "pipeline: anyres_select differs from the torch engine's ranking")
    print(f"pipeline: {SERVE_RES}^2 snowfield in {PIPELINE_TILE}^2 tiles, "
          f"{n_batches} batches of up to {SERVE_BATCH} through Prefetcher -> "
          f"ychg_stats [fused] -> filter_empty_tiles: {n_tiles} tiles, kept "
          f"{n_kept}, one ychg_fused_full launch a batch, stats equal to the "
          f"torch engine's; {n_tiles / pipe_s:.1f} tiles/s; anyres_select "
          f"tile {ANYRES_TILE} k {ANYRES_K} {picks} equal; {card}",
          flush=True)

    # the examples, as a user runs them, all five at once
    export_pythonpath()
    flag = ["--device", "cpu"] if DEV == "cpu" else []
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *flag],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        out, err = outs.get(name, ("", ""))
        check(proc.returncode == 0,
              f"example {name} exited {proc.returncode}: {err[-2000:]}")
        last = out.strip().splitlines()[-1] if out.strip() else ""
        print(f"example: {name} exit 0; last line: {last}", flush=True)
    print(f"examples: all {len(EXAMPLES)} exited 0 in "
          f"{time.perf_counter() - t0:.1f} s (run together)", flush=True)

    launches = counts()
    for name in ("ychg_fused_full", "ychg_fused_splith", "ychg_colscan_full",
                 "ychg_colscan_splith", "ychg_diff", "ccl", "denoise"):
        check(launches[name] > 0, f"phase 7 launched {name} no time")
    print(f"phase 7 (lower, dry run, pipeline, examples): "
          f"{time.perf_counter() - t_phase:.1f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


def keyhash_leg(np, torch, card: str) -> dict:
    """The service's digest kernel (``kernels.keyhash``) against its plain
    version, hashlib's tree node by node: uint8 masks at each bucket side,
    float32 and int64 masks, and lengths at the tree's edges, each bit for
    bit. At each side, the wrapper's time by CUDA events (launch, the 16
    bytes back, the stream's synchronisation), the kernel's device time
    from a torch.profiler trace, the plain version's host time, the
    bound, and the pageable copy that brings the mask to the card (the
    service's ``cache.key_copy``)."""
    from repro_torch.kernels import keyhash as kkh
    from repro_torch.launch.roofline import bound_ms

    kkh.reset_launch_counts()
    rng = np.random.default_rng(20130611)
    rows = []
    for side in KEYHASH_SIDES:
        m = (rng.random((side, side)) < 0.5).astype(np.uint8)
        x = torch.from_numpy(m).to(DEV)
        want = kkh.digest_host(m)
        check(kkh.launch(x) == want,
              f"keyhash differs from hashlib's tree at {side}^2 uint8")
        t0 = time.perf_counter()
        kkh.digest_host(m)
        plain_ms = (time.perf_counter() - t0) * 1e3
        device_ms, seen = kernel_device_ms(lambda: kkh.launch(x),
                                           ("keyhash_kernel",))
        if seen != 20:
            # a trace of these launches, each waiting for its stream, once
            # lost 5 of its 20 kernel records on the card: trace again
            print(f"keyhash: the trace saw {seen} of 20 launches at "
                  f"{side}^2; traced again", flush=True)
            device_ms, seen = kernel_device_ms(lambda: kkh.launch(x),
                                               ("keyhash_kernel",))
        check(seen == 20, f"the trace saw {seen} keyhash launches, want 20")
        row = {"shape": [side, side], "ms": time_ms(lambda: kkh.launch(x)),
               "device_ms": device_ms, "plain_ms": plain_ms,
               "copy_ms": time_ms(lambda: torch.from_numpy(m).to(DEV),
                                  samples=5, reps=2)}
        row["bound_ms"], row["bound_by"] = bound_ms(*kkh.work(m.nbytes))
        rows.append(row)
        print(f"time: keyhash {side}^2 uint8 {row['ms']:.4f} ms through "
              f"its wrapper, {device_ms:.4f} ms on the device, "
              f"{100 * row['bound_ms'] / device_ms:.1f}% of its bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); plain "
              f"{plain_ms:.1f} ms on the host; the copy onto the card "
              f"{row['copy_ms']:.3f} ms; on {card}", flush=True)
        del x
    for dtype in (np.float32, np.int64):
        m = (rng.random((KEYHASH_WIDE_SIDE,) * 2) * 2**40).astype(dtype)
        check(kkh.launch(torch.from_numpy(m).to(DEV)) == kkh.digest_host(m),
              f"keyhash differs from hashlib's tree on {np.dtype(dtype)}")
    for n in KEYHASH_LENGTHS:
        b = rng.integers(0, 256, n, dtype=np.uint8)
        check(kkh.launch(torch.from_numpy(b).to(DEV)) == kkh.digest_host(b),
              f"keyhash differs from hashlib's tree at {n} bytes")
    out = {"rows": rows, "launches": kkh.LAUNCHES["keyhash"],
           "lengths": list(KEYHASH_LENGTHS)}
    print("keyhash: " + json.dumps(out), flush=True)
    return out


def check_keyed(label: str, hits: int, misses: int, on_device: int,
                on_host: int, pinned: int, pageable: int,
                launched=None) -> int:
    """Every cache probe of a service (its hits and misses) keyed where its
    engine says: on the card when DEV is CUDA (one ``keyhash`` launch a
    probe, where the launches are counted in this process, none on the
    host, and every copy onto the card staged through page-locked memory,
    none falling back to a pageable copy), on the host otherwise (no copy).
    Returns the probes."""
    probes = hits + misses
    want = probes if DEV == "cuda" else 0
    check(probes > 0 and on_device == want and on_host == probes - want
          and launched in (None, want) and pinned == want and pageable == 0,
          f"{label}: {probes} probes, {on_device} keyed on the card, "
          f"{on_host} on the host, {launched} keyhash launches, copies "
          f"{pinned} staged and {pageable} pageable; want {want} on the "
          f"card, each copy staged")
    return probes


def metrics_keyed(label: str, m, launched: int) -> int:
    """:func:`check_keyed` on a service's metrics snapshot."""
    return check_keyed(label, m.cache_hits, m.cache_misses, m.keys_on_device,
                       m.keys_on_host, m.key_copies_pinned,
                       m.key_copies_pageable, launched)


def main() -> int:
    # cuBLAS is deterministic with this workspace setting, which phase 9's
    # resume check needs under torch.use_deterministic_algorithms; it must
    # be in the environment before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.engine import ops as engine_ops
    from repro_torch.fleet import (
        FleetRouter,
        FleetSupervisor,
        HashRing,
        RouterConfig,
        RouterThread,
    )
    from repro_torch.fleet.router import routing_key
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.kernels import _build
    from repro_torch.kernels import ccl as kccl
    from repro_torch.kernels import denoise as kdn
    from repro_torch.kernels import keyhash as kkh
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ychg_colscan as kc
    from repro_torch.kernels import ychg_fused as kf
    from repro_torch.kernels import ychg_packed as kp
    from repro_torch.launch.roofline import (
        bound,
        bound_ccl,
        bound_colscan,
        bound_denoise,
        bound_diff,
        bound_finish,
        bound_pack_rows,
        bound_packed_colscan,
        bound_packed_fused,
    )
    from repro_torch.launch.serve import (
        check_metrics_page,
        derived_masks,
        export_pythonpath,
        op_smoke,
        overload_over_wire,
        overload_pass,
        pipeline_pass,
        serve_passes,
        slo_smoke,
    )
    from repro_torch.obs import parse_prom_text
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
    from repro_torch.sharding import make_batch_mesh

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
    sources = ["ychg_fused", "ychg_colscan", "denoise", "ccl", "ychg_packed",
               "keyhash"]
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

    # the service's digest kernel against its plain version, timed
    keyhash_leg(np, torch, card)
    free()

    # 4. the main path, counted from zero
    for module in (kf, kc, kdn, kccl, kp, kkh):
        module.reset_launch_counts()
    # probes of the services below, each keyed on the card (checked leg by
    # leg against the keyhash launches the leg made)
    keyed = {}
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
        k0 = kkh.LAUNCHES["keyhash"]
        report = serve_passes(Engine(config), serve_masks[:SERVE_BATCH],
                              serve_masks[SERVE_BATCH:], op=op)
        check(report.backend == want_backend,
              f"{op} service backend {report.backend!r}")
        label = f"{op}[{want_backend}]"
        keyed[f"serve {label}"] = metrics_keyed(
            f"serve {label}", report.metrics, kkh.LAUNCHES["keyhash"] - k0)
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

    k0 = kkh.LAUNCHES["keyhash"]
    prep = pipeline_pass(Engine(), float_masks, ("denoise", "ychg"))
    keyed["serve denoise+ychg"] = metrics_keyed(
        "serve denoise+ychg", prep.metrics, kkh.LAUNCHES["keyhash"] - k0)
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
    k0 = kkh.LAUNCHES["keyhash"]
    admitted, shed = overload_pass(engine, burst, max_batch=SERVE_BATCH)
    # every submit is keyed before admission, the shed ones too
    launched = kkh.LAUNCHES["keyhash"] - k0
    want = len(burst) if DEV == "cuda" else 0
    check(launched == want, f"overload: {launched} keyhash launches for a "
          f"burst of {len(burst)}, want {want}")
    keyed["overload"] = len(burst)
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
    k0 = kkh.LAUNCHES["keyhash"]
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
        keyed["frontend"] = metrics_keyed(
            "frontend", svc.metrics(), kkh.LAUNCHES["keyhash"] - k0)
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

    # launch.serve --op-smoke on the card: every op over /v1/{op} equal to
    # its reference, /v1/pipeline equal to its stages, the 404 and /metrics
    t0 = time.perf_counter()
    try:
        op_smoke(argparse.Namespace(res=FRONTEND_RES, batch=SERVE_BATCH,
                                    device=None))
    except SystemExit as exc:
        raise SmokeFailure(f"launch.serve --op-smoke: {exc}") from None
    print(f"op smoke: launch.serve --op-smoke at {FRONTEND_RES}^2 passed "
          f"on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    free()

    launches = {**kf.LAUNCHES, **kc.LAUNCHES, **kdn.LAUNCHES, **kccl.LAUNCHES,
                **kp.LAUNCHES, **kkh.LAUNCHES}
    for name in KERNELS:
        check(launches[name] > 0, f"the main path launched {name} no time")
    # the legs checked above, the wire's overload leg and the op smoke
    check(launches["keyhash"] >= (sum(keyed.values()) if DEV == "cuda"
                                  else 0),
          f"the main path launched keyhash {launches['keyhash']} times, "
          f"fewer than its checked legs' probes {json.dumps(keyed)}")
    print(f"keyed on the main path: {launches['keyhash']} keyhash launches; "
          f"every probe of these legs keyed "
          f"{'on the card' if DEV == 'cuda' else 'on the host'}: "
          f"{json.dumps(keyed)}", flush=True)
    calls = {op: {b: registry.call_count(b, op) for b in
                  registry.backend_names(op)} for op in registry.registered_ops()}
    print(f"launches on the main path: {json.dumps(launches)}; backend "
          f"calls: {json.dumps(calls)}", flush=True)

    # 5. the engine's batch mesh and the worker fleet, counted from zero
    t_phase = time.perf_counter()
    for module in (kf, kc, kdn, kccl, kp):
        module.reset_launch_counts()
    registry.reset_call_counts()
    mesh_kernels = {"ychg_fused_full": kf, "ychg_fused_splith": kf,
                    "ccl": kccl, "denoise": kdn}

    def same_fields(got, want, label):
        check(set(got) == set(want), f"{label}: fields {sorted(got)}")
        for f, w in want.items():
            g = got[f]
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"{label}: field {f} is {g.dtype} {tuple(g.shape)}, want "
                  f"{w.dtype} {tuple(w.shape)}")
            if g.is_floating_point():   # bit for bit
                g, w = g.view(torch.int32), w.view(torch.int32)
            check(torch.equal(g, w), f"{label}: field {f} differs")

    def op_fields(op, res):
        return {f: getattr(res, f) for f in engine_ops.get_op(op).fields}

    def host_ms(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn().block_until_ready()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    mesh_x = torch.from_numpy(stack).to(DEV)
    unmeshed = Engine()
    one_card = make_batch_mesh()
    repeated = make_batch_mesh(devices=[DEV] * MESH_REPEAT)
    legs = [
        (f"Engine().with_mesh(make_batch_mesh()) {one_card!r}",
         unmeshed.with_mesh(one_card), mesh_x, "ychg_fused_full"),
        (f"a mesh naming the card {MESH_REPEAT} times, B = "
         f"{MESH_RAGGED_B} (padded to a multiple of {MESH_REPEAT})",
         unmeshed.with_mesh(repeated), mesh_x[:MESH_RAGGED_B],
         "ychg_fused_full"),
        ("the meshed engine with_config(stream_vmem_budget=0)",
         unmeshed.with_mesh(one_card).with_config(stream_vmem_budget=0),
         mesh_x, "ychg_fused_splith"),
    ]
    # launches of the meshed calls alone (the unmeshed references and
    # their timing excluded)
    mesh_launches = dict.fromkeys(mesh_kernels, 0)
    mesh_rows = []
    for label, eng, xs, ychg_kernel in legs:
        row = {"leg": label, "shape": list(xs.shape)}
        for op, kernel in (("ychg", ychg_kernel), ("ccl", "ccl"),
                           ("denoise", "denoise")):
            check(eng.resolve_backend(op=op) == MESH_BACKENDS[op],
                  f"mesh leg [{label}] resolves {op} to "
                  f"{eng.resolve_backend(op=op)!r}")
            want = op_fields(op, unmeshed.analyze_batch(xs, op=op))
            before = {k: m.LAUNCHES[k] for k, m in mesh_kernels.items()}
            got = op_fields(op, eng.analyze_batch(
                xs, op=op).block_until_ready())
            check(mesh_kernels[kernel].LAUNCHES[kernel] > before[kernel],
                  f"mesh leg [{label}] op {op} launched no {kernel}")
            same_fields(got, want, f"mesh leg [{label}] op {op}")
            del got, want
            row[op] = {"kernel": kernel, "meshed_ms": host_ms(
                lambda: eng.analyze_batch(xs, op=op))}
            for k, m in mesh_kernels.items():
                mesh_launches[k] += m.LAUNCHES[k] - before[k]
            row[op]["unmeshed_ms"] = host_ms(
                lambda: unmeshed.analyze_batch(xs, op=op))
            free()
        mesh_rows.append(row)
        print(f"mesh: {label} on {row['shape']} uint8 equals Engine() for "
              f"ychg, ccl and denoise (every field, dtype included); host "
              f"ms meshed / unmeshed (median of 3): "
              + ", ".join(f"{op} [{row[op]['kernel']}] "
                          f"{row[op]['meshed_ms']:.3f} / "
                          f"{row[op]['unmeshed_ms']:.3f}"
                          for op in ("ychg", "ccl", "denoise"))
              + f"; {card}", flush=True)
    print(f"mesh: launches in the mesh legs {json.dumps(mesh_launches)}",
          flush=True)
    del mesh_x
    free()

    # the fleet: worker processes on the card behind the router
    buckets = (FRONTEND_RES, FRONTEND_BIG_RES)
    fe_timed = [np.ascontiguousarray(m[-FRONTEND_RES:, -FRONTEND_RES:])
                for m in serve_masks[:SERVE_BATCH]]
    fe_timed_big = np.ascontiguousarray(
        serve_masks[SERVE_BATCH + 2][-FRONTEND_BIG_RES:, -FRONTEND_BIG_RES:])
    requests = [("/v1/ychg", fe_big, "ychg", None),
                ("/v1/ccl", fe_ccl, "ccl", None),
                ("/v1/denoise", fe_noisy[0], "denoise", None),
                ("/v1/pipeline", fe_noisy[1], None, ["denoise", "ychg"])]
    ref_cfg = ServiceConfig(bucket_sides=buckets, max_batch=SERVE_BATCH)
    with YCHGService(Engine(), ref_cfg) as ref_svc:
        want_batch = [ref_svc.submit(m).result(timeout=600).to_host()
                      for m in fe_batch]
        want_req = [(ref_svc.submit_pipeline(m, stages) if stages
                     else ref_svc.submit(m, op=op)).result(
                         timeout=600).to_host()
                    for _, m, op, stages in requests]
        # the direct front end, for the wire times beside the router's
        with ServerThread(ref_svc) as srv, \
                YCHGClient("127.0.0.1", srv.port) as client:
            t0 = time.perf_counter()
            direct_items = list(client.analyze_batch(fe_timed))
            t_direct_batch = time.perf_counter() - t0
            t0 = time.perf_counter()
            direct_big = client.analyze(fe_timed_big, op="ychg")
            t_direct_big = time.perf_counter() - t0
    direct = {it.id: it.result for it in direct_items}

    def wire_same(got, want, label):
        check(set(got) == set(want), f"{label}: fields {sorted(got)}")
        for f, w in want.items():
            check(got[f].dtype == w.dtype and got[f].shape == w.shape
                  and got[f].tobytes() == w.tobytes(),
                  f"{label}: field {f} is not byte-identical")

    def counter(page, name, **labels):
        return sum(s.value for s in page.samples
                   if s.name == name and dict(s.labels) == labels)

    export_pythonpath()
    sup = FleetSupervisor(2, worker_args=[
        "--buckets", ",".join(str(b) for b in buckets),
        "--max-batch", str(SERVE_BATCH), "--device", DEV])
    try:
        links = sup.start()
        spawn_s = dict(sup.spawn_seconds)
        router = FleetRouter(links, RouterConfig(
            bucket_sides=buckets, max_batch=SERVE_BATCH,
            health_interval_s=3600.0), supervisor=sup)
        with RouterThread(router) as rt, \
                YCHGClient("127.0.0.1", rt.port) as client:
            items = list(client.analyze_batch(fe_batch))
            check(sorted(it.id for it in items) == list(range(SERVE_BATCH))
                  and all(it.ok for it in items),
                  f"fleet /v1/analyze_batch: "
                  f"{[(it.id, it.error) for it in items]}")
            for it in items:
                wire_same(it.result, want_batch[it.id],
                          f"fleet /v1/analyze_batch mask {it.id}")
            for (path, m, op, stages), want in zip(requests, want_req):
                got = (client.pipeline(m, stages) if stages
                       else client.analyze(m, op=op))
                wire_same(got, want, f"fleet {path}")
            served, worker_keys = {}, {}
            for link in links:
                with YCHGClient(link.host, link.http_port) as wc:
                    wpage = parse_prom_text(wc.metrics_text())
                served[link.name] = counter(wpage, "ychg_completed_total")
                # each worker keyed every probe on the card
                worker_keys[link.name] = check_keyed(
                    f"fleet worker {link.name}",
                    *(counter(wpage, f"ychg_{name}_total") for name in (
                        "cache_hits", "cache_misses", "keys_on_device",
                        "keys_on_host", "key_copies_pinned",
                        "key_copies_pageable")))
            check(all(n > 0 for n in served.values()),
                  f"fleet: a worker served nothing: {served}")
            page = parse_prom_text(client.metrics_text())
            dispatches = {op: counter(
                page, "ychg_engine_dispatch_seconds_count", op=op,
                backend=backend) for op, backend in FLEET_BACKENDS.items()}
            check(all(n > 0 for n in dispatches.values()),
                  f"fleet: rolled-up dispatches {dispatches} miss a kernel "
                  f"backend ({FLEET_BACKENDS})")
            print(f"fleet: 2 worker processes on {DEV} behind the router "
                  f"(spawned in " + ", ".join(
                      f"{n} {s:.2f} s" for n, s in spawn_s.items())
                  + f"): /v1/analyze_batch of {SERVE_BATCH} x "
                  f"{FRONTEND_RES}^2, /v1/ychg {FRONTEND_BIG_RES}^2, "
                  f"/v1/ccl, /v1/denoise and /v1/pipeline at "
                  f"{FRONTEND_RES}^2 byte-identical to an in-process "
                  f"Service(Engine()); completed per worker "
                  f"{json.dumps(served)}; rolled-up dispatches "
                  f"{json.dumps(dispatches)}; probes per worker, every one "
                  f"keyed {'on the card' if DEV == 'cuda' else 'on the host'}"
                  f" {json.dumps(worker_keys)}", flush=True)

            t0 = time.perf_counter()
            items = list(client.analyze_batch(fe_timed))
            t_fleet_batch = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = client.analyze(fe_timed_big, op="ychg")
            t_fleet_big = time.perf_counter() - t0
            wire_same(got, direct_big, "fleet /v1/ychg (timed)")
            for it in items:
                check(it.ok, f"fleet timed batch: {it.error}")
                wire_same(it.result, direct[it.id],
                          f"fleet timed batch mask {it.id}")
            px = SERVE_BATCH * FRONTEND_RES ** 2
            big_px = FRONTEND_BIG_RES ** 2
            print(f"fleet: wire through the router against the direct front "
                  f"end (fresh masks, both cold): /v1/analyze_batch of "
                  f"{SERVE_BATCH} x {FRONTEND_RES}^2 "
                  f"{t_fleet_batch * 1e3:.1f} ms "
                  f"({px / t_fleet_batch / 1e6:.1f} Mpx/s) against "
                  f"{t_direct_batch * 1e3:.1f} ms "
                  f"({px / t_direct_batch / 1e6:.1f} Mpx/s); /v1/ychg "
                  f"{FRONTEND_BIG_RES}^2 {t_fleet_big * 1e3:.1f} ms "
                  f"({big_px / t_fleet_big / 1e6:.1f} Mpx/s) against "
                  f"{t_direct_big * 1e3:.1f} ms "
                  f"({big_px / t_direct_big / 1e6:.1f} Mpx/s); {card}",
                  flush=True)

            victim = fe_batch[0]
            owner = HashRing([l.name for l in links],
                             router.config.replicas).node_for(
                                 routing_key(victim))
            owner_link = next(l for l in links if l.name == owner)
            owner_link.process.kill()
            owner_link.process.wait(timeout=30)
            wire_same(client.analyze(victim), want_batch[0], "fleet reroute")
            page = parse_prom_text(client.metrics_text())
            rerouted = counter(page, "ychg_fleet_rerouted_total")
            check(rerouted >= 1, "fleet: killed the owner but "
                                 "ychg_fleet_rerouted_total never moved")
            t0 = time.perf_counter()
            asyncio.run_coroutine_threadsafe(
                router.check_workers(), rt._loop).result(timeout=300)
            restart_s = time.perf_counter() - t0
            health = client.health()
            check(all(health["workers"].values()),
                  f"fleet: restart left workers down: {health['workers']}")
            wire_same(client.analyze(victim), want_batch[0], "fleet peering")
            peer_hits = counter(parse_prom_text(client.metrics_text()),
                                "ychg_cache_peer_hits_total")
            check(peer_hits >= 1,
                  f"fleet: the restarted owner served the repeat mask "
                  f"without a sibling-cache hit (peer hits {peer_hits})")
            print(f"fleet: killed {owner}, the repeat rerouted to the "
                  f"survivor byte-identical (ychg_fleet_rerouted_total "
                  f"{rerouted:.0f}); {owner} restarted in {restart_s:.2f} s "
                  f"and served the repeat from the survivor's cache "
                  f"(ychg_cache_peer_hits_total {peer_hits:.0f}), "
                  f"byte-identical; {card}", flush=True)
    finally:
        sup.stop()
    free()

    t0 = time.perf_counter()
    slo_smoke(argparse.Namespace(res=SLO_RES, batch=SLO_BATCH, device=DEV))
    print(f"slo: priority, deadline and quota legs passed on {DEV} "
          f"({SLO_BATCH} x {SLO_RES}^2 requests, a backlog of "
          f"{4 * SLO_BATCH} x {2 * SLO_RES}^2) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    free()
    phase5_s = time.perf_counter() - t_phase
    print(f"phase 5 (mesh, fleet, slo): {phase5_s:.1f} s", flush=True)

    # 6. for information: one engine call on the device-resident serving
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

    # 7. Engine.lower, the dry run, the pipeline and the examples
    slice_launches = lowering_phase(np, torch, card, serve_masks, scene)
    free()

    # 8. LM serving
    lm = lm_phase(np, torch, card)
    free()

    # 9. training
    train = train_phase(np, torch, card)
    free()

    # 10. sharding and the LM dry run
    shard = shard_phase(np, torch, card)
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
            "mesh_launches": mesh_launches.get(name, 0),
            "lower_phase_launches": slice_launches[name],
            "device_ms": main_row.get("device_ms"),
            "entry_point_ms": main_row.get("entry_point_ms"),
            "cases": stats[name]["cases"],
            "exact": name != "denoise" or float_outputs["differing"] == 0,
            "shape": main_row["shape"],
            "timings": timings[name],
        })
        if name == "ychg_diff":
            kernels[-1]["batch_entry"] = batch_entry
    print("lm: " + json.dumps(lm), flush=True)
    print("train: " + json.dumps(train), flush=True)
    print("shard: " + json.dumps(shard), flush=True)
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
