"""Run one cell of the benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card's line, then, as its last line, the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` when
traced) and ``checks``, the numbers compared beside their limits. Exits
non-zero, printing no result, where no CUDA card is visible, where the
cell asks for more cards than there are, or where the run loaded JAX or
the JAX package.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare() -> None:
    """Keep the program's caches inside the checkout, at fixed paths, and
    put the program and the benchmark on the import path."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()
    import repro_torch  # noqa: F401  (the program under test; fails fast
    #                          in a checkout that lacks it)

    from bench import harness

    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"bench: the run loaded {found}, which the port must not "
              f"import; no result", file=sys.stderr)
        return 3
    harness.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
