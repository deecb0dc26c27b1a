"""The port stands alone: no module of ``repro_torch`` (the examples
included), not ``chip_smoke.py``, and not a fleet worker run as ``python
-m repro_torch.fleet.worker``, imports JAX or anything of the JAX package
``repro``; importing a module runs nothing and leaves the environment as
it was."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_repro():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch

        names = ["repro_torch"] + [
            m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert {"repro_torch.frontend.server", "repro_torch.frontend.client",
                "repro_torch.kernels.ychg_colscan",
                "repro_torch.core.serial",
                "repro_torch.kernels.ychg_packed",
                "repro_torch.data.scenes",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.scene.granule", "repro_torch.scene.result",
                "repro_torch.scene.runner",
                "repro_torch.scene.bulk",
                "repro_torch.sharding.ychg", "repro_torch.fleet.hashring",
                "repro_torch.fleet.peering", "repro_torch.fleet.router",
                "repro_torch.fleet.worker",
                "repro_torch.launch.compilecache",
                "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                "repro_torch.launch.mesh", "repro_torch.launch.analytic",
                "repro_torch.sharding.logical",
                "repro_torch.data.pipeline", "repro_torch.core.regions",
                "repro_torch.core.api", "repro_torch.engine.lowering",
                "repro_torch.kernels.plan",
                "repro_torch.examples.quickstart",
                "repro_torch.examples.satellite_roi",
                "repro_torch.examples.roi_pipeline",
                "repro_torch.examples.roi_service_http",
                "repro_torch.examples.roi_scene_bulk",
                "repro_torch.examples.serve_lm",
                "repro_torch.configs.base", "repro_torch.configs.archs",
                "repro_torch.configs.qwen2_0_5b",
                "repro_torch.configs.minicpm3_4b",
                "repro_torch.data.synthetic", "repro_torch.models.layers",
                "repro_torch.models.mlp", "repro_torch.models.attention",
                "repro_torch.models.model", "repro_torch.models.convert",
                "repro_torch.train.step",
                "repro_torch.serve.engine", "repro_torch.models.moe",
                "repro_torch.models.ssm", "repro_torch.models.rwkv",
                "repro_torch.models.quant", "repro_torch.optim",
                "repro_torch.optim.adamw", "repro_torch.train.loop",
                "repro_torch.launch.train",
                "repro_torch.examples.train_lm"} <= set(names), names
        sys.path.insert(0, sys.argv[1])
        import chip_smoke  # its main() runs only as a script

        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 100  # every module was imported


def test_importing_dryrun_leaves_the_environment_alone():
    """The JAX package's dry run sets ``XLA_FLAGS`` when imported; the
    port's sets nothing."""
    script = textwrap.dedent("""
        import os
        before = dict(os.environ)
        import repro_torch.launch.dryrun
        assert dict(os.environ) == before
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_fleet_worker_run_as_a_module_imports_no_jax():
    """``python -m repro_torch.fleet.worker`` runs up to its handshake (its
    engine, service, peered cache and servers built), drains on SIGTERM,
    and has imported nothing of JAX or of ``repro`` on the way."""
    script = textwrap.dedent("""
        import os, runpy, signal, sys

        class StopAtHandshake:
            def __init__(self, out):
                self.out = out
            def write(self, text):
                self.out.write(text)
                if text.startswith("WORKER READY"):
                    os.kill(os.getpid(), signal.SIGTERM)
                return len(text)
            def flush(self):
                self.out.flush()

        sys.stdout = StopAtHandshake(sys.stdout)
        sys.argv = ["repro_torch.fleet.worker", "--device", "cpu",
                    "--buckets", "16"]
        runpy.run_module("repro_torch.fleet.worker", run_name="__main__",
                         alter_sys=True)
        assert "repro_torch.fleet.peering" in sys.modules
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("WORKER READY rpc=") and lines[-1] == "clean"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Where no CUDA device is visible the smoke script exits non-zero and
    prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
