"""The port's yCHG dry run against the JAX package's.

``run_ychg_cells`` of both packages at ``max_res=500`` lowers and compiles
the workload's cells (JAX on its ``jax`` backend, the port on ``torch``
on the CPU) and writes one record a cell: the same files, ``ok``, batch,
resolution and argument bytes. The port's record adds the kernels'
launches and the roofline's bound. The JAX module sets ``XLA_FLAGS`` when
it is imported, so it is imported with the environment restored after;
the port's module touches nothing (``tests/test_torch_isolation.py``).
"""

import json
import os
from pathlib import Path
from unittest import mock

import pytest

pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402


def _records(directory):
    return {p.name: json.loads(p.read_text())
            for p in sorted(Path(directory).glob("*.json"))}


def test_ychg_cells_match_jax(tmp_path):
    with mock.patch.dict(os.environ):
        from repro.launch import dryrun as jax_dryrun
    assert jax_dryrun.run_ychg_cells(str(tmp_path / "jax"), max_res=500) == 0
    assert dryrun.run_ychg_cells(str(tmp_path / "torch"), max_res=500,
                                 device="cpu") == 0
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "torch")
    assert list(got) == list(want) == [
        "ychg__ychg-modis__b8_res250.json", "ychg__ychg-modis__b8_res500.json"]
    for name, w in want.items():
        g = got[name]
        for key in ("workload", "batch", "resolution", "ok"):
            assert g[key] == w[key], (name, key)
        assert (g["memory"]["argument_size_in_bytes"]
                == w["memory"]["argument_size_in_bytes"]
                == 8 * g["resolution"] ** 2)
        assert (w["backend"], g["backend"], g["device"]) == (
            "jax", "torch", "cpu")
        assert g["kernels"] == {} and g["route"] is None
        assert g["bound_ms"] == pytest.approx(
            g["cost"]["bytes_accessed"] / 3.35e12 * 1e3)


def test_ychg_cells_on_the_card_route_plan(tmp_path, monkeypatch):
    """Off the CPU the section's own ``auto`` resolves to ``fused``: with
    the engine's device type answered as the card's, every cell of the
    workload up to 21000^2 at B = 8 plans one ``ychg_fused_full`` launch on
    the full-column route, and nothing is allocated (the 21000^2 cell's
    stack is 3.5 GB)."""
    from repro_torch.engine import engine as em

    init = em.Engine.__init__

    def on_cpu_as_on_the_card(self, *a, **k):
        init(self, *a, **{**k, "device": "cpu"})
        self.platform = "cuda"

    monkeypatch.setattr(em.Engine, "__init__", on_cpu_as_on_the_card)
    assert dryrun.run_ychg_cells(str(tmp_path), max_res=21000) == 0
    recs = _records(tmp_path)
    assert len(recs) == 8
    for r in recs.values():
        assert (r["backend"], r["route"]) == ("fused", "full")
        assert r["kernels"] == {"ychg_fused_full": 1}
        res = r["resolution"]
        assert r["cost"]["kernel_bytes"] == (8 * res * res + 8 * res * 13
                                             + 8 * 8)
    big = recs["ychg__ychg-modis__b8_res21000.json"]
    assert big["memory"]["argument_size_in_bytes"] == 3_528_000_000
    assert big["bound_ms"] == pytest.approx(1.0542, abs=1e-4)


def test_main_without_ychg_names_the_lm_slice(tmp_path, capsys):
    """Without ``--ychg`` the command reckons the LM cells (it exited
    naming Queue A 6 until the LM sweep was ported): one cell here."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--device", "cpu", "--arch", "qwen2-0.5b", "--shape",
                     "train_4k", "--mesh", "single", "--out",
                     str(tmp_path)])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "[OK] qwen2-0.5b x train_4k x single (reckoned)" in out
    rec = _records(tmp_path)["qwen2-0.5b__train_4k__single.json"]
    assert rec["ok"] and rec["reckoned"] and rec["chips"] == 256


def test_main_ychg_on_the_cpu(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--ychg", "--device", "cpu", "--ychg-max-res", "250",
                     "--out", str(tmp_path)])
    assert exc.value.code == 0
    assert "[OK] ychg__ychg-modis__b8_res250" in capsys.readouterr().out
