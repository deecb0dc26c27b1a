"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package ``repro``."""

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
                "repro_torch.scene.bulk"} <= set(names), names
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
    assert int(out.stdout.strip()) >= 46  # every module was imported


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
