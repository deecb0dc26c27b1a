"""The harness on the CPU: each cell end to end at a small size, the
result's line, the files it is driven by, and what a run loads."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from bench import devtrace, harness, roofline  # noqa: E402
from bench.drivers import open_loop  # noqa: E402
from bench.tests.small import SECONDS, small  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(cell, trace=False, seed=2**33 + 17, **kw):
    return harness.run_cell(cell, seed, SECONDS, trace, device="cpu",
                            overrides=small(cell), spec=SPEC, **kw)


# a run's --seed may run past 32 bits
@pytest.mark.parametrize("seed", [2**33 + 17, 2**31 + 11])
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_cpu(cell, seed):
    line = _run(cell, seed=seed)
    assert line["correct"], line["checks"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert "breakdown" not in line
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
    assert set(line["metrics"]) == want
    assert line["attempted"] > 0 and line["failed"] == 0
    for m in line["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    assert line["device"]["platform"] == "cpu"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_programs_layers(cell):
    line = _run(cell, trace=True)
    assert line["correct"]
    # no card, so nothing of the device is read, and nothing invented
    layer = {m["name"] for m in harness.cell_metrics(SPEC, cell, True)
             if m["source"] != "device_trace"}
    assert set(line["metrics"]) == layer
    assert "busy_s" not in line["device"] and "breakdown" not in line


def test_a_new_cell_and_metric_need_only_new_files(tmp_path, monkeypatch):
    data = tmp_path / "bench"
    for kind in ("configs", "workloads", "layer_metrics", "end_to_end"):
        shutil.copytree(ROOT / "bench" / kind, data / kind)
    wl = json.loads((data / "workloads" / "serve8k.closed.json").read_text())
    wl["traffic"] = "closed_loop.48"
    wl["params"].update(small("serve8k.closed")["workload"]["params"],
                        res=48)
    (data / "workloads" / "serve48.closed.json").write_text(json.dumps(wl))
    (data / "layer_metrics" / "svc.crop_ms.json").write_text(json.dumps({
        "source": "service_stage", "stage": "crop", "scale": 1000.0,
        "unit": "ms", "layer": "service", "moves": "mpx_per_s"}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "serve48.closed",
                              "config": "modis-serve",
                              "traffic": "closed_loop.48", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "mpx_per_s":
            m["workloads"].append("serve48.closed")
    spec["per_layer"].append({"name": "svc.crop_ms", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "service", "moves": "mpx_per_s",
                              "workloads": ["serve48.closed"]})
    monkeypatch.setattr(harness, "BENCH", data)
    over = {"config": small("serve8k.closed")["config"]}
    line = harness.run_cell("serve48.closed", 5, SECONDS, True,
                            device="cpu", overrides=over, spec=spec)
    assert line["correct"]
    assert line["metrics"]["svc.crop_ms"]["value"] > 0
    line = harness.run_cell("serve48.closed", 5, SECONDS, False,
                            device="cpu", overrides=over, spec=spec)
    assert set(line["metrics"]) == {"mpx_per_s", "setup_s"}


def test_benchmark_json_names_its_files_and_keeps_the_rules():
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    pairs = set()
    for w in SPEC["workloads"]:
        f = json.loads((ROOT / "bench" / "workloads" /
                        f"{w['name']}.json").read_text())
        assert (f["config"], f["traffic"]) == (w["config"], w["traffic"])
        assert f["why"] == w["why"] and len(w["why"]) <= 200
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "bench" / "drivers" / f"{f['driver']}.py").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + list(configs)
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        f = json.loads((ROOT / "bench" / "end_to_end" /
                        f"{m['name']}.json").read_text())
        assert f["stat"] in harness.STATS
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        f = json.loads((ROOT / "bench" / "layer_metrics" /
                        f"{m['name']}.json").read_text())
        assert (f["unit"], f["layer"], f["moves"]) == (
            m["unit"], m["layer"], m["moves"])
        assert m["moves"] in e2e
        assert (ROOT / "bench" / "sources" / f"{f['source']}.py").is_file()
    for cell in (w["name"] for w in SPEC["workloads"]):
        assert len(harness.cell_metrics(SPEC, cell, False)) >= 2
        assert harness.cell_metrics(SPEC, cell, True)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "3", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())
    assert "CUDA" in out.stderr


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        "from bench import harness\n"
        "from bench.tests.small import SECONDS, small\n"
        "line = harness.run_cell('serve8k.open', 9, SECONDS, True, "
        "device='cpu', overrides=small('serve8k.open'))\n"
        "assert line['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "repro_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded(["repro_torch.engine", "reprox",
                                     "numpy", "jax_like"]) == []
    assert harness.forbidden_loaded(["repro.core", "jaxlib", "flax.nn",
                                     "repro_torch"]) == ["flax", "jaxlib",
                                                         "repro"]


def test_statistics_of_the_window():
    w = harness.Window(t0=0.0, t1=2.0, pixels=4_000_000, attempted=4,
                       failed=0, latencies_s=[0.4, 0.1, 0.3, 0.2])
    assert harness.STATS["rate"](w, {"scale": 1e-6}, 0) == 2.0
    assert harness.STATS["quantile"](w, {"q": 0.5, "scale": 1e3}, 0) == \
        pytest.approx(200.0)
    assert harness.STATS["quantile"](w, {"q": 0.95}, 0) == 0.4
    w.latencies_s.append(math.inf)
    assert harness.STATS["quantile"](w, {"q": 0.95}, 0) is None
    assert harness.STATS["setup"](w, {}, 7.5) == 7.5


@pytest.mark.parametrize("seed", [2**40 + 9, 2**31 + 11, 2**64 + 3])
def test_every_seed_offers_the_same_arrivals_in_another_order(seed):
    a = open_loop.due_offsets(200, 8.0, 25.0, 1)
    b = open_loop.due_offsets(200, 8.0, 25.0, seed)
    assert a[-1] == pytest.approx(25.0) and b[-1] == pytest.approx(25.0)
    ga, gb = sorted(a[1:] - a[:-1]), sorted(b[1:] - b[:-1])
    assert not all(x == pytest.approx(y) for x, y in zip(a, b))
    assert sorted([a[0], *ga]) == pytest.approx(sorted([b[0], *gb]))


def test_device_trace_busy_gaps_and_names():
    ops = [("k1", "kernel", 1.0, 1.5), ("copy", "gpu_memcpy", 1.25, 2.0),
           ("k1", "kernel", 3.0, 3.5)]
    spans = [("scene.read", 2.0, 3.0, {}), ("job", 0.0, 4.0, {})]
    dev = devtrace.DeviceTrace(0.0, 4.0, ops, spans)
    assert dev.busy_s == pytest.approx(1.5)
    assert dev.kernel_s == pytest.approx(1.0)
    assert dev.gaps() == [(0.0, 1.0), (2.0, 3.0), (3.5, 4.0)]
    bd = dev.breakdown()
    assert bd["device_ops"][0] == ["k1", 1.0]
    assert bd["idle_gaps"][0] == ["job", 1.0]
    assert bd["idle_gaps"][1] == ["scene.read", 1.0]


def test_roofline_counts_the_ops_bytes_once():
    nbytes, ops = roofline.ychg_work(8, 8192, 8192, 1)
    assert nbytes == 8 * 8192 * 8192 + 8 * 8192 * 17 + 8 * 8
    assert roofline.least_s(nbytes, ops) == pytest.approx(
        nbytes / roofline.PEAK_BYTES_PER_S)
