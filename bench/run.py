"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: builds the cell's data and the program's
server on the card, warms up, drives the closed loop for ``--seconds``,
checks a sample of the answers against the plain reference, and prints
the compared numbers with their limits as the last lines on standard
error and one JSON object as the last line on standard output.  Without a
CUDA device, or without the program, it exits non-zero and prints no
result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from bench.harness import SetupError, forbidden_modules, run_cell
    try:
        out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START)
    except (SetupError, ImportError) as e:
        print(f"bench: no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    # the window has closed: this process must not have loaded JAX or the
    # JAX package
    found = forbidden_modules()
    if found:
        print(f"bench: no result: modules {found} were loaded",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
