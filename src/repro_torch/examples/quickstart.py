"""Quickstart: build a synthetic RDF dataset, inspect its characteristics,
and run template queries through every engine variant, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import argparse
import time

from ..core import Dataset
from ..data import dblp_like, random_query
from ..serve import QueryServer

VARIANTS = ("stwig+", "spath_ni2", "h2", "h3", "hvc", "rdf_h")


def run(device: str = "cuda", scale: float = 0.08, seed: int = 7) -> dict:
    """The quickstart on ``device``; returns each variant's match count
    and the served rounds' counts and plan-cache hits."""
    print("== 1. build a DBLP-like RDF graph ==")
    g = dblp_like(scale=scale, seed=seed)
    print(f"   {g.num_nodes} nodes, {g.num_edges} triples, "
          f"avg degree {g.avg_degree:.2f}")

    print("== 2. dataset evaluation metrics (paper §5) ==")
    # Dataset owns everything derived from the graph: stats, the NI
    # index, signatures, and a (digest, version) identity for caches
    ds = Dataset.build(g, variant="rdf_h")
    st = ds.stats
    print(f"   coherence={st.coherence:.3f}  specialty={st.specialty:.1f}  "
          f"diversity={st.diversity}")
    print("   (high coherence + low specialty + low diversity would predict "
          "little pruning benefit)")

    print("== 3. run the same query through every variant ==")
    q = random_query(g, size=6, seed=11)
    print(f"   keywords: {q.keywords}")
    counts = {}
    for variant in VARIANTS:
        # each variant gets the NI depth/shape it needs
        eng = Dataset.build(g, variant=variant).engine(variant, device=device)
        eng.execute(q)                      # uploads and kernel builds
        t0 = time.perf_counter()
        res = eng.execute(q)
        dt = time.perf_counter() - t0
        counts[variant] = res.count
        print(f"   {variant:10s} {res.count:7d} matches  {dt*1e3:8.1f} ms  "
              f"check={'on ' if res.stats.used_check else 'off'}  "
              f"join_work={res.stats.join_work + res.stats.dtree_work}")

    print("== 4. the RDF-h planner decision ==")
    eng = ds.engine("rdf_h", device=device)
    # Joins default to join_impl="auto": the cost model picks nested-loop,
    # fused sort-merge, or the radix hash join per table pair (radix wins
    # when a large probe side meets a small build side on a single-column
    # key).  Force one strategy with e.g. eng.cfg.join_impl = "radix".
    res = eng.execute(q)
    plan = res.stats.plan
    if plan:
        print(f"   complex_query={plan.complex_query} "
              f"(iters={plan.est_iterations:.0f}, joins={plan.est_join_product:.2g})")
        print(f"   max neighborhood selectivity={plan.max_selectivity:.2f} "
              f"-> use_check={plan.use_check}")

    print("== 5. serving: plan cache makes repeat templates cheap ==")
    srv = QueryServer(ds, device=device)
    served = []
    for label in ("cold", "warm", "warm"):
        t0 = time.perf_counter()
        r = srv.query(q)
        served.append(r.count)
        print(f"   {label}: {r.count} matches in "
              f"{(time.perf_counter() - t0)*1e3:8.1f} ms  "
              f"plan_cache_hit={r.stats.cache_hit}")
    pc = srv.telemetry()["plan_cache"]
    print(f"   plan cache: {pc['hits']} hits / {pc['misses']} misses")
    print("   (full repeat-template workload: "
          "python -m repro_torch.examples.serve_queries; add --snapshot "
          "PATH there to save the learned state and warm-restart a fresh "
          "server from it)")

    print("== 6. observability: EXPLAIN the plan the server learned ==")
    # srv.explain(q) renders the §4.3 check decision with its τ terms,
    # the Selinger join order, and the learned join sequence; pass
    # tracer=repro_torch.obs.Tracer() to QueryServer (or --trace PATH to
    # serve_queries) for per-query Chrome traces of every pruning
    # decision and join.
    print("\n".join("   " + line
                    for line in srv.explain(q).splitlines()[:6]))
    print("   ... (srv.explain(q) for the full report)")
    return {"variants": counts, "rdf_h": res.count, "served": served,
            "plan_cache": {k: pc[k] for k in ("hits", "misses")}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
