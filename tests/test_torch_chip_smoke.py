"""CPU rehearsal of ``chip_smoke.py``: its whole control flow, on the CPU, at
tiny sizes, with the plain versions standing in for the kernel launches.

The rehearsal runs in a subprocess, since it patches ``torch.cuda`` and the
kernel modules: the card's probes answer as if one card were present, every
``launch`` runs its plain version and counts itself, the kernel wrappers
route through those launches, and ``Engine()`` lands on the CPU while
resolving backends as it would on the card. It shows that every phase runs
and that the main path reaches all seven kernels; it says nothing about the
kernels themselves, which only a run on the card can check.
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
    import sys, time
    import torch

    sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda i=0: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda: None
    torch.cuda.current_stream = lambda *a: type("S", (), {"cuda_stream": 0})

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

    cs.DEV = "cpu"
    cs.SERVE_RES, cs.SCENE_RES = 64, 120
    cs.SCENE_HYPEREDGES, cs.SCENE_BLOCK_H = 50, 16
    cs.FRONTEND_RES, cs.FRONTEND_BIG_RES = 32, 64
    cs.card_line = lambda: "CPU rehearsal, 0 W"
    cs.ptx_float_ops = lambda source: {"add.rn.ftz.f32": 1}
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
    denoise.launch = counted(denoise.LAUNCHES, "denoise",
                             denoise.denoise_plain)
    denoise.denoise_kernel = lambda s: denoise.DenoiseSummary(
        denoise.launch(s))
    ccl.launch = counted(ccl.LAUNCHES, "ccl", ccl.ccl_fixpoint_plain)
    ccl.ccl_fixpoint = lambda s: ccl.launch(s)

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
        "ychg_colscan_splith", "ychg_diff", "denoise", "ccl"]
    for k in kernels:
        assert k["launches"] > 0 and k["max_abs_err"] == 0, k["name"]
        assert k["library_ms"] is None and k["bound_by"] == "bytes"
    assert "serve denoise+ychg: 8 served results equal" in out.stdout
    assert "serve ychg[cuda]: 24 served results equal" in out.stdout
    assert "as op ccl gives 50 components" in out.stdout
    assert "via the two-kernel split-H engine gives 50" in out.stdout
    assert "frontend: loopback HTTP over the cuda engine" in out.stdout
    assert "paper: 120^2 (striped scene): serial" in out.stdout
    assert "engine: one analyze_batch of the 8 x 64^2 serving" in out.stdout
