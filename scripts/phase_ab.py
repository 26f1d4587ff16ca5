"""Run one phase of chip_smoke.py from several checkouts in turn, each in
a process of its own on the card, and print the phase's timings side by
side: the way to compare two commits within one machine's run, in the
order parent, change, change, parent.

    python scripts/phase_ab.py --phase lm --out ab.jsonl PARENT_DIR . . PARENT_DIR

Each ROOT is a checkout of the repository (a `git archive` of the parent
unpacked into a directory that .gitignore lists, or `.`).  The phase is
chip_smoke's `<phase>_phase()`, called with no arguments (lm, train).
Every JSON record the runs print goes to --out, tagged with its run; the
table lists, per config and case, decode_ms_per_step and prefill_s of
each run.  Exits non-zero if a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

KEYS = ("decode_ms_per_step", "prefill_s")


def run(root: str, phase: str) -> list:
    """The JSON records of one run of `phase` from the checkout `root`."""
    root = os.path.abspath(root)
    prog = (f"import sys; sys.path[:0] = [{root!r}, {root + '/src'!r}]; "
            f"import chip_smoke; chip_smoke.{phase}_phase()")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", prog], cwd=root,
                         capture_output=True, text=True, timeout=1200)
    if out.returncode:
        sys.exit(f"{root}: {phase} failed ({out.returncode}):\n"
                 f"{out.stderr[-3000:]}")
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    recs.append({"phase": "run_seconds",
                 "seconds": time.perf_counter() - t0})
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", default="lm")
    ap.add_argument("--out", required=True,
                    help="file for every record, as JSON lines")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    runs = []
    with open(args.out, "w") as f:
        for i, root in enumerate(args.roots):
            recs = run(root, args.phase)
            for r in recs:
                f.write(json.dumps({"run": i, "root": root, **r}) + "\n")
            runs.append(recs)
    rows = {}
    for i, recs in enumerate(runs):
        for r in recs:
            name = (r.get("config"), r.get("case"))
            for k in KEYS:
                if k in r:
                    rows.setdefault(name + (k,), {})[i] = r[k]
    head = " | ".join(f"{i}: {root}" for i, root in enumerate(args.roots))
    print(f"config | case | metric | {head}")
    for (cfg, case, k), vals in rows.items():
        cells = " | ".join(repr(vals.get(i)) for i in range(len(runs)))
        print(f"{cfg} | {case} | {k} | {cells}")
    print(json.dumps({"run_seconds": [r[-1]["seconds"] for r in runs]}))


if __name__ == "__main__":
    main()
