"""RDF query-serving driver: batched query workload through the RDF-ℏ
engine with planner statistics and throughput report, on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.query --dataset dblp --queries 20
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import Dataset, tune_thresholds, Thresholds
from ..data import DATASETS, random_query


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="dblp", choices=sorted(DATASETS))
    ap.add_argument("--scale", type=float, default=0.08)
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--size", type=int, default=6)
    ap.add_argument("--variant", default="rdf_h")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--tune", action="store_true",
                    help="grid-tune thresholds on a held-out sample first")
    args = ap.parse_args()

    g = DATASETS[args.dataset](scale=args.scale, seed=1)
    ds = Dataset.build(g, variant=args.variant)
    st = ds.stats
    print(f"dataset={args.dataset} triples={g.num_edges} "
          f"coherence={st.coherence:.3f} specialty={st.specialty:.1f}")

    thresholds = Thresholds(500, 1e5, 6.0)
    if args.tune:
        sample = [random_query(g, size=args.size, seed=5000 + i)
                  for i in range(4)]

        def cost(q, th):
            eng = ds.engine(args.variant, thresholds=th,
                            device=args.device)
            t0 = time.perf_counter()
            eng.execute(q)
            return time.perf_counter() - t0
        thresholds = tune_thresholds(cost, sample)
        print(f"tuned thresholds: iter={thresholds.tau_iter} "
              f"join={thresholds.tau_join} sel={thresholds.tau_sel}")

    eng = ds.engine(args.variant, thresholds=thresholds, device=args.device)
    queries = [random_query(g, size=args.size, seed=100 + i)
               for i in range(args.queries)]
    # warm up on one query (kernel build, NI tensor upload)
    eng.execute(queries[0])

    t0 = time.perf_counter()
    n_match = checks_on = truncated = 0
    lat = []
    for q in queries:
        t1 = time.perf_counter()
        r = eng.execute(q)
        lat.append(time.perf_counter() - t1)
        n_match += r.count
        checks_on += r.stats.used_check
        truncated += r.stats.truncated
    wall = time.perf_counter() - t0
    lat = np.asarray(lat)
    print(f"{args.queries} queries in {wall:.2f}s "
          f"({args.queries / wall:.2f} qps)")
    print(f"latency p50={np.percentile(lat, 50)*1e3:.1f}ms "
          f"p95={np.percentile(lat, 95)*1e3:.1f}ms "
          f"max={lat.max()*1e3:.1f}ms")
    print(f"matches={n_match} planner-enabled-check={checks_on}"
          f"/{args.queries} truncated={truncated}")


if __name__ == "__main__":
    main()
