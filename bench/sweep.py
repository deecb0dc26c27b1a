"""Find the knee of an open-loop cell: the highest rate without a growing
backlog.

    python3 bench/sweep.py --workload serve8k.open --seed <n> --seconds <s> --rates 4,6,8

One process sets the cell up once, then offers each rate for ``--seconds``
in turn, each window with requests of its own, and prints a JSON line a
rate: the rate offered, Mpx/s, p50 and p95 latency, and the median
latency of the window's last fifth of requests over its first fifth (a
backlog that grows shows as a ratio well above 1). Answers are not checked
here; ``bench/run.py`` checks them.
"""

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

from run import prepare

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    prepare()
    import torch

    from bench import harness
    from bench.drivers import open_loop

    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA card")
    print(harness.card_line(torch), flush=True)
    wl = harness.find("workloads", args.workload)
    cfg = harness.find("configs", wl["config"])
    ctx = harness.Context(torch=torch, device="cuda", seed=args.seed,
                          workload=wl, config=cfg,
                          tmp=str(ROOT / "build" / "sweep"), trace=False,
                          control=False, log=harness._log)
    drv = open_loop.Driver(ctx)
    drv.setup()
    print(f"setup_s {time.monotonic() - T_START:.3f}", flush=True)
    try:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            wl["params"]["rate"] = rate
            drv.index_base = (k + 1) * 10**7
            obs = drv.window(args.seconds)
            drv.serving.results = {}
            w = obs.window
            lat = w.latencies_s
            fifth = max(1, len(lat) // 5)
            finite = [x for x in lat if math.isfinite(x)]
            first = statistics.median(lat[:fifth])
            last = statistics.median(lat[-fifth:])
            q = sorted(lat)
            print(json.dumps({
                "rate": rate, "requests": len(lat),
                "answered": len(finite),
                "mpx_per_s": w.pixels * 1e-6 / (w.t1 - w.t0),
                "p50_ms": q[len(q) // 2] * 1e3,
                "p95_ms": q[min(len(q) - 1, math.ceil(0.95 * len(q)) - 1)]
                * 1e3,
                "last_over_first": last / first if first > 0 else None,
            }), flush=True)
    finally:
        drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
