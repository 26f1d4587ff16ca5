"""Run a cell several times, one process a run, and report the spread.

    python3 bench/series.py --workload <cell> --seeds 11 12 13 --seconds 30 \
        [--trace 0|1] [--out DIR]

Each run is ``bench/run.py`` in a process of its own, one after another,
from the root of the checkout.  Its standard output and error go to
``DIR/<cell>.<seed>.<trace>.{out,err}``.  The last line printed is a JSON
summary: per metric its values, median, and the spread (the distance
between the first and third quartiles of ``statistics.quantiles(values,
n=4)``, as a share of the median), and whether every run was correct.
Each run's line also gives its host use (``getrusage`` of the child: CPU
seconds, page faults, context switches).  A seed given twice runs twice;
its second run's files end in ``.again``.
"""
import argparse
import json
import resource
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="chiprun_out/series")
    args = ap.parse_args(argv)
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    runs, seen = [], set()
    for seed in args.seeds:
        cmd = [sys.executable, str(ROOT / "bench" / "run.py"),
               "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        before = resource.getrusage(resource.RUSAGE_CHILDREN)
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        after = resource.getrusage(resource.RUSAGE_CHILDREN)
        # the run's host use: CPU seconds, page faults, context switches
        usage = {k: round(getattr(after, k) - getattr(before, k), 3)
                 for k in ("ru_utime", "ru_stime", "ru_minflt", "ru_majflt",
                           "ru_nvcsw", "ru_nivcsw")}
        stem = f"{args.workload}.{seed}.{args.trace}" \
            + (".again" if seed in seen else "")
        seen.add(seed)
        (out_dir / f"{stem}.out").write_text(p.stdout)
        (out_dir / f"{stem}.err").write_text(p.stderr)
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if p.returncode == 0 else None
        except (json.JSONDecodeError, IndexError):
            res = None
        runs.append({"seed": seed, "rc": p.returncode, "result": res})
        brief = {k: v["value"] for k, v in res["metrics"].items()} \
            if res else p.stderr[-2000:]
        print(json.dumps({"seed": seed, "rc": p.returncode,
                          "correct": res and res["correct"],
                          "metrics": brief, "usage": usage,
                          "notes": res and res.get("notes")}), flush=True)
    ok = [r["result"] for r in runs if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    summary = {"workload": args.workload, "trace": args.trace,
               "runs": len(runs), "all_correct":
               len(ok) == len(runs) and all(r["correct"] for r in ok)}
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        summary[k] = {"values": vals, "median": statistics.median(vals),
                      "spread": spread(vals)}
    print(json.dumps(summary), flush=True)
    return 0 if summary["all_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
