"""``launch.serve --op-smoke``, the port's multi-op loopback assert, with
``--device cpu``: as a user runs it (a subprocess), in-process with a
reference made to disagree (the leg must fail and name the field), and
its wire results against the JAX package's references on the same seeded
inputs (exact for ychg and ccl; denoise's float32 image within
``test_torch_denoise.assert_denoise_matches``, 1 ulp in at most 1 in
10^4 outputs).
"""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine.ops import get_op as jget_op  # noqa: E402
from repro_torch.data import modis  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.engine import ops as engine_ops  # noqa: E402
from repro_torch.frontend import ServerThread, YCHGClient  # noqa: E402
from repro_torch.launch.serve import op_smoke  # noqa: E402
from repro_torch.service import ServiceConfig, YCHGService  # noqa: E402
from test_torch_denoise import assert_denoise_matches  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = argparse.Namespace(res=32, batch=2, device="cpu")


def test_op_smoke_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "ychg", "--res", "64", "--batch", "4", "--op-smoke", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=240,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines == [
        "op smoke: /v1/ccl bit-identical to its reference on cpu",
        "op smoke: /v1/denoise bit-identical to its reference on cpu",
        "op smoke: /v1/ychg bit-identical to its reference on cpu",
        "op smoke: /v1/pipeline denoise+ychg == the stages issued as "
        "separate requests",
        "op smoke: unknown op answered 404 naming the registry; dispatch "
        "histogram carries one op= label per op"]


@pytest.mark.parametrize("op,field", [("ccl", "n_components"),
                                      ("ychg", "n_hyperedges")])
def test_op_smoke_fails_on_a_disagreeing_reference(monkeypatch, op, field):
    spec = engine_ops.get_op(op)

    def off_by_one(stack):
        s = spec.reference(stack)
        return dataclasses.replace(s, **{field: getattr(s, field) + 1})

    monkeypatch.setitem(engine_ops._OPS, op, dataclasses.replace(
        spec, reference=off_by_one))
    with pytest.raises(SystemExit, match=f"op smoke \\[{op}\\]: field "
                                         f"'{field}' not bit-identical"):
        op_smoke(ARGS)


def test_op_smoke_in_process(capsys):
    op_smoke(ARGS)
    out = capsys.readouterr().out
    assert out.count("bit-identical to its reference on cpu") == 3


def test_wire_results_match_the_jax_references():
    rng = np.random.default_rng(11)
    inputs = {"ychg": modis.snowfield(48, seed=0),
              "ccl": modis.snowfield(48, seed=1),
              "denoise": rng.random((48, 48)).astype(np.float32)}
    cfg = ServiceConfig(bucket_sides=(48,), max_batch=2)
    with YCHGService(Engine(device="cpu"), cfg) as svc, \
            ServerThread(svc) as srv, \
            YCHGClient("127.0.0.1", srv.port) as client:
        for op, x in inputs.items():
            got = client.analyze(x, op=op)
            spec = jget_op(op)
            want = spec.from_summary(spec.reference(jnp.asarray(x)[None]),
                                     False).to_host()
            assert set(got) == set(want), op
            for f, w in want.items():
                w = np.asarray(w)
                if op == "denoise":
                    assert_denoise_matches(got[f], w, True)
                else:
                    assert got[f].dtype == w.dtype, (op, f)
                    np.testing.assert_array_equal(got[f], w)
