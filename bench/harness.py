"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything that belongs to one cell, configuration, metric or traffic mix
is data, found by its name:

  BENCHMARK.json                 the cells, and the metrics each reports
  bench/workloads/<cell>.json    configuration, traffic driver, its params
  bench/configs/<config>.json    the deployment: what the driver builds
  bench/drivers/<driver>.py      a traffic driver (``Driver(ctx)``)
  bench/end_to_end/<metric>.json an end-to-end metric: a statistic of the
                                 window's records (``STATS`` below)
  bench/layer_metrics/<m>.json   a per-layer metric: the source it reads
  bench/sources/<source>.py      a reader (``read(spec, obs)``)

A driver sets up its system and data, warms the cell's shapes, runs the
window and, after the program's state is freed, checks what the window
produced against ``bench/reference``. The harness times set-up, traces the
window when asked, and prints the result's line.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level module names the port must not load in a measured run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# traces the flight recorder keeps in a traced run: more than a window of
# 51 s makes (about 33,000 requests at 650 a second)
TRACE_CAPACITY = 200_000


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def find(kind: str, name: str) -> dict:
    """The data file ``bench/<kind>/<name>.json``."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"bench: no {kind} named {name!r} ({path})")
    return load_json(path)


def deep_merge(base: Any, over: Any) -> Any:
    if isinstance(base, dict) and isinstance(over, dict):
        out = dict(base)
        for k, v in over.items():
            out[k] = deep_merge(base.get(k), v) if k in base else v
        return out
    return over


def cell_entry(spec: dict, cell: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise SystemExit(f"bench: BENCHMARK.json has no cell {cell!r}")


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; an entry with a
    ``workloads`` list applies to those cells, one without it to every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


# ------------------------------------------------------------- records


@dataclasses.dataclass
class Window:
    """What a driver's measured window did, in monotonic seconds."""

    t0: float                     # first request due / job started
    t1: float                     # end of the work the rate is taken over
    pixels: int                   # real mask pixels whose results came back
    attempted: int
    failed: int
    latencies_s: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Observations:
    """What the per-layer readers read. Each field is None where the
    cell's system or this run does not have it."""

    window: Window
    service_before: Any = None    # ServiceMetrics at the window's start
    service_after: Any = None     # ... once every result of it is back
    max_batch: Optional[int] = None
    spans: Optional[List[tuple]] = None   # (name, t0, t1, meta) in window
    dispatched: Optional[List[tuple]] = None  # ((B, H, W), itemsize)
    device: Any = None            # bench.devtrace.DeviceTrace


def _rate(window: Window, m: dict, setup_s: float) -> Optional[float]:
    span = window.t1 - window.t0
    if span <= 0 or window.pixels <= 0:
        return None
    return window.pixels * m.get("scale", 1.0) / span


def _quantile(window: Window, m: dict, setup_s: float) -> Optional[float]:
    """Nearest-rank quantile over every request of the window; a failed or
    missing request is infinite, so a tail that reaches one is None."""
    lat = sorted(window.latencies_s)
    if not lat:
        return None
    rank = min(len(lat), max(1, math.ceil(m["q"] * len(lat))))
    v = lat[rank - 1]
    return v * m.get("scale", 1.0) if math.isfinite(v) else None


def _setup(window: Window, m: dict, setup_s: float) -> float:
    return setup_s


STATS: Dict[str, Callable[[Window, dict, float], Optional[float]]] = {
    "rate": _rate, "quantile": _quantile, "setup": _setup}


# --------------------------------------------------------------- context


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    torch: Any
    device: str
    seed: int
    workload: dict        # bench/workloads/<cell>.json (with overrides)
    config: dict          # bench/configs/<config>.json (with overrides)
    tmp: str              # a fresh directory under TMPDIR, removed after
    trace: bool
    control: bool         # the reference in the program's place
    log: Callable[[str], None]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line(torch) -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    import subprocess

    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({type(e).__name__})"
    return f"card: {name} | {out.splitlines()[0] if out else 'no reading'}"


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each name compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN_MODULES))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: Optional[dict] = None,
             control: bool = False, t_start: Optional[float] = None,
             spec: Optional[dict] = None) -> dict:
    """Run ``cell`` once and return the result's line as a dict.

    ``device`` "cpu" and ``overrides`` (merged into the workload's
    ``params`` and the configuration) serve the CPU tests; the command
    line always runs on the card at the sizes in the files.
    """
    t_start = time.monotonic() if t_start is None else t_start
    overrides = overrides or {}
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    entry = cell_entry(spec, cell)
    wl = deep_merge(find("workloads", cell), overrides.get("workload", {}))
    cfg = deep_merge(find("configs", wl["config"]), overrides.get("config",
                                                                  {}))
    metrics = cell_metrics(spec, cell, trace)

    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: torch.cuda.is_available() is false; "
                             "this benchmark runs only on a CUDA card")
        if torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(
                f"bench: cell {cell} needs {entry['chips']} cards, "
                f"{torch.cuda.device_count()} visible")
        print(card_line(torch), flush=True)
    recorder = None
    if trace:
        from repro_torch import obs

        obs.configure(capacity=TRACE_CAPACITY)
        recorder = obs.recorder()

    driver_mod = importlib.import_module(f"bench.drivers.{wl['driver']}")
    tmp_root = tempfile.mkdtemp(prefix="bench-")
    ctx = Context(torch=torch, device=device, seed=seed, workload=wl,
                  config=cfg, tmp=tmp_root, trace=trace, control=control,
                  log=_log)
    driver = driver_mod.Driver(ctx)
    try:
        driver.setup()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if trace:
            from bench import devtrace

            recorder.clear()
            prof = devtrace.Recorder(torch, device)
            prof.start()
        t_window = time.monotonic()
        setup_s = t_window - t_start
        obsv = driver.window(seconds)
        if prof is not None:
            prof.stop()
            obsv.spans = spans_in(recorder.traces(), obsv.window)
        memory_peak = (torch.cuda.max_memory_allocated()
                       if device == "cuda" else 0)
        if prof is not None:
            obsv.device = prof.read(obsv)
        window = obsv.window
        driver.collect()
        driver.close()
        checks = driver.check()
    finally:
        driver.close()
        shutil.rmtree(tmp_root, ignore_errors=True)

    values: Dict[str, dict] = {}
    for m in metrics:
        if trace:
            lm = find("layer_metrics", m["name"])
            src = importlib.import_module(f"bench.sources.{lm['source']}")
            v = src.read(lm, obsv)
        else:
            em = find("end_to_end", m["name"])
            v = STATS[em["stat"]](window, em, setup_s)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": entry["chips"] if device == "cuda" else 1,
           "memory_peak_bytes": int(memory_peak)}
    line: Dict[str, Any] = {"correct": correct,
                            "attempted": window.attempted,
                            "failed": window.failed,
                            "metrics": values, "device": dev}
    if trace and obsv.device is not None:
        dev["busy_s"] = obsv.device.busy_s
        dev["window_s"] = obsv.device.window_s
        line["breakdown"] = obsv.device.breakdown()
    line["checks"] = checks
    return line


def print_result(line: dict) -> None:
    """The numbers compared, beside their limits, as the last lines on
    standard error; then the result as the last line on standard out."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def spans_in(traces, window: Window) -> List[tuple]:
    """(name, t0, t1, meta) of every recorded span that overlaps the
    window."""
    return [(name, s0, s1, meta) for tr in traces
            for name, s0, s1, meta in tr.spans()
            if s1 >= window.t0 and s0 <= window.t1]


def count_dispatch(engine: Any, sink: List[tuple]) -> None:
    """Note in ``sink`` the shape and item size of every stack that
    ``engine.analyze_batch`` is handed from now on (traced runs only)."""
    inner = engine.analyze_batch

    def analyze_batch(stack, **kw):
        size = (stack.element_size() if hasattr(stack, "element_size")
                else stack.dtype.itemsize)
        sink.append((tuple(stack.shape), size))
        return inner(stack, **kw)

    engine.analyze_batch = analyze_batch
