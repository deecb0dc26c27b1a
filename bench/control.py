"""Read a cell's compared numbers over several seeds in one process: the
program's, or the control's (the reference in the program's place, bent
as the configuration's ``control`` says), at the cell's own size.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--program]

One JSON line a seed: the seed, ``correct`` and the checks beside their
limits. The benchmark's own runs never run the control; this is how the
limits' upper readings are taken on the card.
"""

import argparse
import json
import sys
import time

from run import prepare


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", action="store_true",
                    help="run the program instead of the control")
    args = ap.parse_args()
    prepare()
    from bench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                control=not args.program)
        print(json.dumps({"seed": seed, "control": not args.program,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"],
                          "metrics": line["metrics"],
                          "run_s": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
