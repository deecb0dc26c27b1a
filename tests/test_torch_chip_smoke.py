"""CPU rehearsal of ``chip_smoke.py``: its whole control flow, on the CPU, at
tiny sizes, with the plain versions standing in for the kernel launches.

The rehearsal runs in a subprocess, since it patches ``torch.cuda`` and the
kernel modules: the card's probes answer as if one card were present, every
``launch`` runs its plain version and counts itself, the kernel wrappers
route through those launches, and ``Engine()`` lands on the CPU while
resolving backends as it would on the card. It shows that every phase runs
and that the main path reaches all nine kernels; it says nothing about the
kernels themselves, which only a run on the card can check. Phase 5's
meshes list the CPU, and its fleet workers are real worker processes run
with ``--device cpu`` (so their ops resolve to the ``torch`` backends).
Phase 7 lowers and runs its cells on the CPU (the memory probes answer 0,
and the peak is not measured there), dry-runs the workload with the
``torch`` backend, and runs the five examples as processes with
``--device cpu``. Phase 8 runs the LM checks on the reduced configs (the
card and the CPU both the CPU): qwen2, MLA, RWKV, MoE, the hybrid, int8
weights and the two serving legs, and the LM CLI and example with
``--device cpu``. Phase 9 trains the reduced qwen2 (one step at each
remat, and against itself, gradient accumulation, ``TrainLoop`` with its
checkpoint and resume, on a dataset of 4 patterns, which a 256-token
vocabulary can learn in 20 steps; each remat timed), jamba's and rwkv's
reduced configs at each remat, and runs the train CLI and example with
``--device cpu``. Phase 10 reckons the LM dry run and runs the meshed
paths on a one-rank gloo group's (1, 1) CPU mesh, on the reduced
configs, and the gloo rehearsal's four processes.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

REHEARSAL = textwrap.dedent("""
    import os, sys, time
    import torch

    # the processes the script starts run side by side on the CPU here, and
    # beside the suite's other workers: two threads each, this one too, so
    # that their thread pools do not fight for the cores
    os.environ["OMP_NUM_THREADS"] = "2"
    torch.set_num_threads(2)

    sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda i=0: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda: None
    torch.cuda.current_stream = lambda *a: type("S", (), {"cuda_stream": 0})
    torch.cuda.memory_allocated = lambda *a: 0
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.memory_stats = lambda *a: {}
    torch.cuda.get_device_properties = lambda *a: type(
        "Props", (), {"total_memory": 80 * 2**30})

    class Event:
        def __init__(self, enable_timing=False):
            self.t = 0.0
        def record(self, *a):
            self.t = time.perf_counter()
        def synchronize(self):
            pass
        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    torch.cuda.Event = Event

    import chip_smoke as cs
    from repro_torch.engine import engine as em
    from repro_torch.kernels import _build, ccl, denoise, ychg_fused as kf
    from repro_torch.kernels import ychg_colscan as kc
    from repro_torch.kernels import ychg_packed as kp

    cs.DEV = "cpu"
    cs.SERVE_RES, cs.SCENE_RES = 64, 120
    cs.SCENE_HYPEREDGES, cs.SCENE_BLOCK_H = 50, 16
    cs.FRONTEND_RES, cs.FRONTEND_BIG_RES = 32, 64
    cs.PACKED_SNOW_RES = 64
    cs.SCAN_MAX_SEGMENTS, cs.SCAN_LONG_SEGMENTS = 8, (5, 9)
    cs.BULK_TILE_H, cs.BULK_STACK = 32, 2
    cs.RESUME_H, cs.RESUME_W, cs.RESUME_TILE_H = 64, 96, 16
    cs.card_line = lambda: "CPU rehearsal, 0 W"
    cs.ptx_float_ops = lambda source: {"add.rn.ftz.f32": 1}
    # no trace of a card here: the launches as if seen, the step-2 kernel
    # once a mask of the serving batch
    cs.kernel_device_ms = lambda fn, names, calls=20: (
        0.001, calls * (8 if "diff_kernel<true>" in names else 1))
    cs.PACKED_MAX_SEGMENTS, cs.PACKED_LONG_SEGMENTS = 4, (3, 5)
    cs.FLEET_BACKENDS = {"ychg": "torch", "ccl": "torch", "denoise": "torch"}
    cs.SLO_RES, cs.SLO_BATCH = 32, 2
    cs.KEYHASH_SIDES, cs.KEYHASH_WIDE_SIDE = (16, 32, 64), 48
    cs.KEYHASH_LENGTHS = (0, 1, 4095, 4097, 128 * 4096 + 1)
    cs.PIPELINE_TILE, cs.ANYRES_TILE = 16, 32
    cs.STREAM_VMEM_BUDGET = 16384   # the 320-row tall strip takes split-H
    cs.LM_SMOKE = True              # phase 8 on the reduced configs
    cs.LM_CHECK_PROMPT, cs.LM_CHECK_NEW = 16, 8
    cs.LM_PROMPT, cs.LM_NEW = 16, 8
    cs.TRAIN_PATTERNS, cs.TRAIN_SEQ = 4, 64   # phase 9 on the reduced qwen2
    cs.SHARD_BACKEND = "gloo"       # phase 10's one-rank group on the CPU
    import repro_torch.sharding as shard
    every_device = shard.make_batch_mesh
    shard.make_batch_mesh = lambda axis_name="data", devices=None: (
        every_device(axis_name, devices=["cpu"] if devices is None
                     else devices))
    _build.build = lambda names: {n: 0.0 for n in names}

    class NoLibrary:  # the C entry points timed alone do nothing here
        def __getattr__(self, name):
            return lambda *args: 0

    _build.load = lambda name, signatures: NoLibrary()

    def counted(launches, name, plain):
        def launch(x, *a, **k):
            launches[name] += 1
            return plain(x, *a, **k)
        return launch

    kf.launch_full = counted(kf.LAUNCHES, "ychg_fused_full",
                             kf.ychg_fused_full_plain)
    kf.launch_splith = counted(
        kf.LAUNCHES, "ychg_fused_splith",
        lambda x, block_h=2048: kf.ychg_fused_splith_plain(x, block_h))
    kf.ychg_fused_full = lambda x: kf.launch_full(x)
    kf.ychg_fused_splith = lambda x, block_h=2048: kf.launch_splith(
        x, block_h=block_h)
    kc.launch_full = counted(kc.LAUNCHES, "ychg_colscan_full",
                             kc.colscan_full_plain)
    kc.launch_splith = counted(
        kc.LAUNCHES, "ychg_colscan_splith",
        lambda x, block_h=2048: kc.colscan_splith_plain(x, block_h))
    kc.launch_diff = counted(kc.LAUNCHES, "ychg_diff", kc.diff_plain)
    kc.ychg_colscan_full = lambda x: kc.launch_full(x)
    kc.ychg_colscan_splith = lambda x, block_h=2048: kc.launch_splith(
        x, block_h=block_h)
    kc.ychg_diff = lambda r: kc.launch_diff(r)

    def launch_analyze(x, block_h=None):
        b = x.shape[0]
        if block_h is None:
            kc.LAUNCHES["ychg_colscan_full"] += b
        elif x.shape[1]:
            kc.LAUNCHES["ychg_colscan_splith"] += b
        kc.LAUNCHES["ychg_diff"] += b
        return kc.analyze_plain(x, block_h)

    kc.launch_analyze = launch_analyze
    kc.ychg_colscan_analyze = lambda x, block_h=None: kc.launch_analyze(
        x, block_h=block_h)
    denoise.launch = counted(denoise.LAUNCHES, "denoise",
                             denoise.denoise_plain)
    denoise.denoise_kernel = lambda s: denoise.DenoiseSummary(
        denoise.launch(s))
    ccl.launch = counted(ccl.LAUNCHES, "ccl", ccl.ccl_fixpoint_plain)
    ccl.ccl_fixpoint = lambda s: ccl.launch(s)
    kp.launch_colscan = counted(kp.LAUNCHES, "ychg_packed_colscan",
                                kp.packed_colscan_plain)
    kp.launch_fused = counted(kp.LAUNCHES, "ychg_packed_fused",
                              kp.packed_fused_plain)
    kp.ychg_packed_colscan = lambda p: kp.launch_colscan(p)
    kp.ychg_packed_fused = lambda p: kp.launch_fused(p)
    from repro_torch.kernels import keyhash as kkh
    kkh.launch = counted(kkh.LAUNCHES, "keyhash", kkh.digest)

    em._default_device = lambda: torch.device("cpu")
    init = em.Engine.__init__

    def on_cpu_as_on_the_card(self, *a, **k):
        init(self, *a, **k)
        self.platform = "cuda"

    em.Engine.__init__ = on_cpu_as_on_the_card
    sys.exit(cs.main())
""")


def test_chip_smoke_rehearsal_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", REHEARSAL, str(ROOT)],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "CPU rehearsal", "count": 1}}
    assert lines[-2] == "CPU rehearsal, 0 W"
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == [
        "ychg_fused_full", "ychg_fused_splith", "ychg_colscan_full",
        "ychg_colscan_splith", "ychg_diff", "denoise", "ccl",
        "ychg_packed_colscan", "ychg_packed_fused"]
    for k in kernels:
        assert k["launches"] > 0 and k["max_abs_err"] == 0, k["name"]
        assert k["library_ms"] is None and k["bound_by"] == "bytes"
    assert "serve denoise+ychg: 8 served results equal" in out.stdout
    keyhash = json.loads(next(line for line in lines if line.startswith(
        "keyhash: "))[len("keyhash: "):])
    assert [r["shape"] for r in keyhash["rows"]] == [[16, 16], [32, 32],
                                                     [64, 64]]
    # 3 sides (a check, and the events' 2 + 75 calls; the trace answers
    # here without a call), 2 wide dtypes, 5 lengths
    assert keyhash["launches"] == 3 * (1 + 77) + 2 + 5
    assert "time: keyhash 64^2 uint8 " in out.stdout
    # a CPU engine's services key on the host: the main path's legs each
    # checked, and no launch of the kernel there
    keyed = json.loads(next(line for line in lines if line.startswith(
        "keyed on the main path: 0 keyhash launches; every probe of these "
        "legs keyed on the host: ")).split("on the host: ")[1])
    assert set(keyed) == {"serve ychg[fused]", "serve ychg[cuda]",
                          "serve ccl[cuda]", "serve denoise[cuda]",
                          "serve denoise+ychg", "overload", "frontend"}
    assert all(n > 0 for n in keyed.values())
    assert "serve ychg[cuda]: 24 served results equal" in out.stdout
    assert "as op ccl gives 50 components" in out.stdout
    assert "via the two-kernel split-H engine gives 50" in out.stdout
    assert "frontend: loopback HTTP over the cuda engine" in out.stdout
    assert "paper: 120^2 (striped scene): serial" in out.stdout
    assert "engine: one analyze_batch of the 8 x 64^2 serving" in out.stdout
    assert ("scene: 120^2 through packed_analyze and packed_colscan equals "
            "Engine().analyze (50 hyperedges)") in out.stdout
    assert ("BulkJob on the 120^2 memmap granule (4 strips of 32 rows in 2 "
            "device batches of up to 2) is bit-identical") in out.stdout
    assert "SceneRunner.analyze_scene (analyze_stream)" in out.stdout
    assert ("2 synthetic 64 x 96 granules killed at stack 3, newest "
            "checkpoint truncated, resumed with a warning") in out.stdout
    assert "% of packed_analyze" in out.stdout
    for case in ("serpentine", "all-foreground", "checkerboard"):
        assert f"exact: ccl [{case} 1 x 64^2]" in out.stdout
    assert "time: ccl passes [8, 64, 64] uint8: local " in out.stdout
    assert "time: ccl passes [1, 64, 64] uint8: local " in out.stdout
    assert "% of the whole op" in out.stdout
    for label in ("int64", "uint64"):
        assert (f"exact: Engine() on a {label} (2, 300, 517) mask equals it "
                "on its low 32 bits") in out.stdout
    assert "ychg_fused_full against ychg_fused_splith" in out.stdout
    assert out.stdout.count("C entry point alone") == 8
    assert "time: ychg_fused_splith [1, 320, 64] uint8" in out.stdout
    assert "time: ychg_fused_full [1, 320, 64] uint8" in out.stdout
    assert "the two step-1 routes on the tall strip [320, 64]" in out.stdout
    assert ("time: ychg_colscan_analyze [8, 64, 64] uint8 (16 launches, one "
            "host call): through kops.analyze_batch") in out.stdout
    assert "pdl: ychg_colscan_analyze's C call on [8, 64, 64]" in out.stdout
    assert ("against plain stream order (ychg_colscan_analyze_stream_order)"
            in out.stdout)
    assert ("time: ychg_diff on the main path (diff_kernel<true>, the batch "
            "entry's step 2) [64] int32") in out.stdout
    assert "16 launches from one host call" in out.stdout
    diff = next(k for k in kernels if k["name"] == "ychg_diff")
    assert diff["batch_entry"]["launches"] == 16
    assert len(diff["batch_entry"]["pdl_ms"]) == 2
    assert [t["kernel"] for t in diff["timings"]] == [
        "diff_kernel<true>, the batch entry's step 2",
        "diff_kernel<false>, off the main path"]
    assert diff["shape"] == [64] and diff["ms"] == 0.001
    for name in ("ychg_packed_colscan", "ychg_packed_fused"):
        packed = next(k for k in kernels if k["name"] == name)
        assert packed["device_ms"] == 0.001, name
        assert [t["shape"] for t in packed["timings"]] == [[15, 120],
                                                           [8, 64]]
        for t in packed["timings"]:
            assert t["device_ms"] == 0.001 and "entry_point_ms" in t, name
        assert f"time: {name} [15, 120] uint8: " in out.stdout
    assert "exact: ychg_packed_colscan equals its plain version on" in (
        out.stdout)
    for leg in ("Engine().with_mesh(make_batch_mesh()) BatchMesh("
                "axis_name='data', devices=('cpu',)) on [8, 64, 64]",
                "a mesh naming the card 3 times, B = 5 (padded to a "
                "multiple of 3) on [5, 64, 64]",
                "the meshed engine with_config(stream_vmem_budget=0) on "
                "[8, 64, 64]"):
        assert f"mesh: {leg} uint8 equals Engine() for ychg, ccl" in (
            out.stdout), leg
    assert "ychg [ychg_fused_splith] " in out.stdout
    mesh = json.loads(out.stdout.split("mesh: launches in the mesh legs ")[1]
                      .splitlines()[0])
    assert all(n > 0 for n in mesh.values()), mesh
    assert ("fleet: 2 worker processes on cpu behind the router"
            in out.stdout)
    assert ("byte-identical to an in-process Service(Engine()); completed "
            "per worker") in out.stdout
    assert "every one keyed on the host {" in out.stdout
    assert "fleet: wire through the router against the direct" in out.stdout
    assert "rerouted to the survivor byte-identical" in out.stdout
    assert "served the repeat from the survivor's cache" in out.stdout
    for line in ("slo smoke: interactive wire request overtook",
                 "slo smoke: wire shed counted",
                 "slo smoke: 100ms deadline shed",
                 "slo smoke: tenant quota admitted",
                 "slo: priority, deadline and quota legs passed on cpu",
                 "phase 5 (mesh, fleet, slo): "):
        assert line in out.stdout, line
    for k in kernels:
        want = k["name"] in ("ychg_fused_full", "ychg_fused_splith", "ccl",
                             "denoise")
        assert (k["mesh_launches"] > 0) == want, k["name"]
    for name in ("ychg_fused_full", "ychg_fused_splith", "ychg_colscan_full",
                 "ychg_colscan_splith", "ychg_diff", "ccl", "denoise"):
        k = next(k for k in kernels if k["name"] == name)
        assert k["lower_phase_launches"] > 0, name
    assert out.stdout.count("memory_allocated +0") == 22
    assert out.stdout.count(" as lowered, fields as out_info") == 11
    assert ("lower: ychg [fused] tall strip [1, 320, 64] uint8 (cold): "
            in out.stdout)
    assert "route splith, launches {\"ychg_fused_splith\": 1}" in (
        out.stdout)
    assert out.stdout.count("dryrun: b8 ") == 8
    assert "dryrun: 8 cells ok" in out.stdout
    assert "pipeline: 64^2 snowfield in 16^2 tiles, 2 batches" in out.stdout
    for name in ("quickstart", "satellite_roi", "roi_pipeline",
                 "roi_service_http", "roi_scene_bulk"):
        assert f"example: {name} exit 0" in out.stdout, name
    assert "phase 7 (lower, dry run, pipeline, examples): " in out.stdout
    assert ("op smoke: launch.serve --op-smoke at 32^2 passed on the card"
            in out.stdout)
    assert "op smoke: /v1/pipeline denoise+ychg == the stages" in out.stdout
    for label in ("qwen2-0.5b", "minicpm3-4b x2", "rwkv6-3b x2",
                  "phi3.5-moe-42b-a6.6b x2", "jamba-v0.1-52b x8",
                  "jamba-v0.1-52b x8 bfloat16", "qwen2-0.5b int8"):
        assert f"lm [{label}]: " in out.stdout, label
    for arch in ("qwen2-0.5b", "rwkv6-3b"):
        assert (f"lm [{arch} bfloat16]: ServeEngine.generate batch 8"
                in out.stdout), arch
    assert "experts equal in 2 MoE layers" in out.stdout
    assert "(dropless)" in out.stdout
    for name in ("serve --workload lm", "examples.serve_lm"):
        assert f"lm: {name} exit 0" in out.stdout, name
    assert "the LM path launched none of the nine kernels" in out.stdout
    lm = json.loads(next(line for line in lines
                         if line.startswith("lm: {"))[4:])
    for arch in ("qwen2-0.5b", "rwkv6-3b"):
        assert lm[f"{arch} bfloat16"]["decode_bound_ms"] > 0, arch
    for label in ("qwen2-0.5b", "minicpm3-4b x2", "rwkv6-3b x2",
                  "phi3.5-moe-42b-a6.6b x2"):
        assert lm[label]["forward_max_abs"] <= lm[label]["bound"], label
    assert lm["phi3.5-moe-42b-a6.6b x2"]["moe_layers"] == 2
    for label in ("jamba-v0.1-52b x8", "qwen2-0.5b int8"):
        assert lm[label]["decode_max_abs"] <= lm[label]["bound"], label
    assert lm["qwen2-0.5b int8"]["int8_params"] > 0
    assert "train [qwen2-0.5b x2 float32]: " in out.stdout
    assert "TrainLoop batch 8 x 64, 20 steps" in out.stdout
    for name in ("launch.train", "examples.train_lm"):
        assert f"train: {name} exit 0" in out.stdout, name
    assert "training launched none of the nine kernels" in out.stdout
    train = json.loads(next(line for line in lines
                            if line.startswith("train: {"))[7:])
    assert train["loop"]["resume_bit_equal"]
    assert train["loop"]["losses"][-1] < train["loop"]["losses"][0]
    assert len(train["loop"]["step_ms"]) == 20
    assert (train["float32"]["param_max_abs"]
            <= train["float32"]["param_bound"])
    # the remat legs: bit for bit at every remat (the rehearsal's "card"
    # and CPU are both the CPU), each remat timed, rwkv trained at its
    # smoke depth
    for leg in ("float32", "hybrid"):
        assert train[leg]["bit_equal"] and train[leg]["remats"] == [
            "none", "dots", "full"], leg
    assert "train remat [jamba-v0.1-52b smoke float32, ssm_chunk 4]" \
        in out.stdout
    assert sorted(k for k in train["remat"] if k != "seconds") == [
        "dots", "full", "none"]
    assert train["loop"]["remat"] == "none"    # the smoke config's own
    rwkv = train["rwkv"]
    assert sorted(rwkv["runs"]) == ["full", "none"] and rwkv["depth"] == 2
    # the first step's loss is a forward from the same weights; later ones
    # follow gradients whose embedding rows the CPU adds in thread order
    assert (rwkv["runs"]["full"]["losses"][0]
            == rwkv["runs"]["none"]["losses"][0])
    assert rwkv["kept"]["stepwise"] > rwkv["kept"]["chunked"] > 0
    assert "shard: the LM dry run reckoned 64 cells, every one ok" in (
        out.stdout)
    assert ("shard: gloo process group of one rank, make_host_mesh() = "
            "(1, 1) ('data', 'model') on cpu") in out.stdout
    for line in ("shard [qwen2-0.5b x2 float32]: on the (1, 1) mesh",
                 "ServeEngine(mesh=...) on the (1, 1) mesh",
                 "greedy tokens equal to the unmeshed engine's",
                 "moe_impl=alltoall on the (1, 1) mesh takes dispatch",
                 "one meshed train step against the unmeshed one",
                 "the meshed paths launched none of the nine kernels"):
        assert line in out.stdout, line
    assert "shard: the gloo rehearsal (4 processes, mesh (2, 2)" in (
        out.stdout)
    shard = json.loads(next(line for line in lines
                            if line.startswith("shard: {"))[7:])
    assert shard["dryrun"]["cells"] == 64
    assert shard["float32"]["forward_max_abs"] <= shard["float32"]["bound"]
    assert (shard["serve"]["param_bytes_placed"]
            == shard["serve"]["param_bytes_reckoned"])
    assert shard["moe_path"] == "dispatch"
    assert shard["train_param_max_abs"] <= shard["train_param_bound"]
    assert shard["gloo"]["a2a_grad_rel"] <= 1e-5
    assert all(r["equal"] for case, r in shard["gloo"]["collectives"].items()
               if not case.startswith("train")), shard["gloo"]
    split = next(k for k in kernels if k["name"] == "ychg_fused_splith")
    assert [t["shape"] for t in split["timings"]] == [
        [1, 120, 120], [8, 64, 64], [1, 320, 64]]
