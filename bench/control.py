"""The control of the check: the reference with one guarantee broken, put
in the program's place, must come out not correct.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--requests N]

The configuration states exact answers under subgraph isomorphism.  The
control answers the cell's requests with the plain matcher without the
injectivity of the node assignment (homomorphisms), cut and flagged at
``max_rows`` as the server cuts, and the harness's comparison judges a
sample of them drawn from the seed as it judges a run's.  The first
``--requests`` requests of the seed's stream stand for what a run answers
(a run's ``attempted``).  One JSON line a seed, then a summary: the
smallest count of mismatched answers is the upper reading of that number.
The program is not loaded.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]


def control_run(cell, seed: int, requests: int, g=None) -> dict:
    from bench.gen.traffic import make_traffic
    from bench.harness import Reservoir, bench_graph
    from bench.reference.compare import control_rows, judge
    from bench.reference.match import TooLarge
    cfg, mix = cell.config, cell.mix
    g = bench_graph(cfg) if g is None else g
    seconds = requests / mix["per_second"] + 1
    traffic = make_traffic(g, mix, seed, seconds)
    max_rows = int(cfg["max_rows"])
    sample = Reservoir(int(mix["sample"]), seed)
    # the sample a run draws over its answered requests, as indices
    for i in range(min(requests, len(traffic.stream))):
        sample.offer(i)
    answers, samples, failed = {}, [], 0
    for i in sample.items:
        req = traffic.stream[i]
        if req.base not in answers:
            try:
                answers[req.base] = control_rows(
                    g, traffic.templates[req.base], max_rows)
            except TooLarge:
                answers[req.base] = None
        if answers[req.base] is None:
            failed += 1
            continue
        rows, cut = answers[req.base]
        inv = [0] * len(req.perm)          # back to the request's order
        for q, p in enumerate(req.perm):
            inv[p] = q
        samples.append((req, rows[:, inv], cut))
    v = judge(g, traffic.templates, samples, max_rows)
    return {"seed": seed, "failed_requests": failed,
            "mismatched_answers": v["mismatched"], "checked": v["checked"],
            "cut": v["cut"], "notes": v["notes"]}


def main(argv=None) -> int:
    from bench.harness import bench_graph, load_cell
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=1000)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    g = bench_graph(cell.config)
    outs = []
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_run(cell, seed, args.requests, g)
        out["seconds"] = time.perf_counter() - t
        outs.append(out)
        print(json.dumps(out), flush=True)
    print(json.dumps({"workload": args.workload,
                      "upper_reading": min(o["mismatched_answers"]
                                           for o in outs),
                      "readings": [o["mismatched_answers"] for o in outs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
