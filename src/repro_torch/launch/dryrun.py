"""Dry run: lower and compile every yCHG cell of the workload.

The port's counterpart of ``repro.launch.dryrun``'s yCHG part
(``run_ychg_cells``, ``--ychg``). For each resolution of
``configs/ychg_modis.py`` it lowers the workload's batched path with
``Engine.lower`` and compiles it, without allocating the stack: on the
card the compile builds the route's CUDA kernels, and the cell's output
shapes, bytes, launches and memory come from the shape alone. One JSON
record a cell, ``ychg__<workload>__b<batch>_res<res>.json``, as the JAX
package writes it, plus the kernels' launches and the roofline's bound.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --ychg [--device cpu]
      [--ychg-max-res 21000] [--out results/dryrun]

The rest of the JAX module (the LM architecture sweep over production
meshes) comes with the LM slice (ROADMAP Queue A 6); without ``--ychg``
this command says so and exits non-zero. Importing this module sets
nothing in the environment.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.launch import roofline


def run_ychg_cells(out_dir: str, max_res: int = 2000,
                   device: Optional[str] = None) -> int:
    """Engine-driven yCHG dry run: lower and compile the workload's batched
    path per resolution without allocating a single stack.

    Uses the ``engine`` section of ``configs/ychg_modis.py``: on the CPU
    with backend ``torch`` (the JAX package's ``jax``), on the card
    (``device`` None or ``"cuda"``) with the section's own ``auto``, which
    resolves to ``fused``, so the kernels are built. Returns the number of
    failed cells.
    """
    from repro_torch.configs.ychg_modis import config as ychg_config
    from repro_torch.engine import Engine

    wl = ychg_config()
    on_cpu = device is not None and str(device) == "cpu"
    cfg = (wl.engine.to_engine_config(backend="torch") if on_cpu
           else wl.engine.to_engine_config())
    engine = Engine(cfg, device=device)
    os.makedirs(out_dir, exist_ok=True)
    n_fail = 0
    for res in [r for r in wl.resolutions if r <= max_res]:
        tag = f"ychg__{wl.name}__b{wl.batch}_res{res}"
        rec: Dict[str, Any] = {
            "workload": wl.name,
            "backend": engine.resolve_backend(),
            "device": str(engine.device),
            "batch": wl.batch,
            "resolution": res,
        }
        t0 = time.monotonic()
        try:
            lowered = engine.lower((wl.batch, res, res))
            rec["lower_s"] = time.monotonic() - t0
            t1 = time.monotonic()
            compiled = lowered.compile()
            rec["compile_s"] = time.monotonic() - t1
            rec["build_s"] = compiled.build_seconds
            cost = roofline.cost_dict(compiled)
            mem = compiled.memory_analysis()
            rec["route"] = compiled.route
            rec["cost"] = {
                "flops": float(cost.get("flops", 0.0)),
                "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
                "kernel_bytes": cost["kernel bytes"],
                "op_bytes": cost["op bytes"],
            }
            rec["kernels"] = cost["launches"]
            rec["memory"] = {
                k: getattr(mem, k)
                for k in ("argument_size_in_bytes", "output_size_in_bytes",
                          "temp_size_in_bytes")
            }
            terms = roofline.terms(flops_global=rec["cost"]["flops"],
                                   bytes_global=rec["cost"]["bytes_accessed"],
                                   operation=cost["operation"])
            rec["roofline"] = terms
            rec["bound_ms"] = max(terms["compute_s"], terms["memory_s"]) * 1e3
            rec["ok"] = True
            print(f"[OK] {tag}: route={rec['route']} flops="
                  f"{rec['cost']['flops']:.3g} bytes="
                  f"{rec['cost']['bytes_accessed']:.3g} bound="
                  f"{rec['bound_ms']:.4f}ms launches={rec['kernels']}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
            n_fail += 1
            print(f"[FAIL] {tag}: {rec['error']}", flush=True)
        rec["total_s"] = time.monotonic() - t0
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return n_fail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Lower and compile the yCHG workload's cells without "
                    "allocating them.")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--ychg", action="store_true",
                    help="dry-run the yCHG engine cells (configs/ychg_modis "
                         "engine section)")
    ap.add_argument("--ychg-max-res", type=int, default=2000)
    ap.add_argument("--device", default=None,
                    help="'cpu' to lower on the CPU; default: the card")
    args = ap.parse_args(argv)
    if not args.ychg:
        raise SystemExit(
            "the LM architecture sweep is not ported yet (ROADMAP Queue A "
            "6, the LM substrate); pass --ychg for the yCHG cells")
    raise SystemExit(1 if run_ychg_cells(args.out, max_res=args.ychg_max_res,
                                         device=args.device) else 0)


if __name__ == "__main__":
    main()
