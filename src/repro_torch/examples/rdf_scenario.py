"""Scenario: when does signature pruning pay?  (the paper's core question)

Runs the same workload on a LUBM-like (coherent, uniform) and a DBLP-like
(hub-heavy) dataset and shows the planner choosing differently, plus a
connection-edge query evaluated through the NI index; on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.rdf_scenario
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import Dataset, instantiate_connections
from ..core.query import ConnectionEdge, QueryEdge, QueryTemplate
from ..data import dblp_like, lubm_like, random_query

N_QUERIES = 6


def workload(name, g, device: str = "cuda") -> dict:
    """Six queries through the never / always / hybrid check policies;
    returns each query's match count per policy and the prune rate."""
    ds = Dataset.build(g, variant="spath_ni2")   # d=2 NI serves all three
    st = ds.stats
    print(f"-- {name}: coherence={st.coherence:.3f} "
          f"specialty={st.specialty:.1f} diversity={st.diversity}")
    engines = {"never": ds.engine("stwig+", device=device),
               "always": ds.engine("spath_ni2", device=device),
               "hybrid": ds.engine("rdf_h", device=device)}
    tot = dict.fromkeys(engines, 0.0)
    counts = {label: [] for label in engines}
    pruned = kept = 0
    for s in range(N_QUERIES):
        q = random_query(g, size=6, seed=900 + s)
        for label, eng in engines.items():
            eng.execute(q)
            t0 = time.perf_counter()
            r = eng.execute(q)
            tot[label] += time.perf_counter() - t0
            counts[label].append(r.count)
        r = engines["always"].execute(q)
        pruned += r.stats.candidates_before - r.stats.candidates_after
        kept += r.stats.candidates_after
    rate = 100 * pruned / max(pruned + kept, 1)
    print(f"   candidate prune rate with 2-hop check: {rate:.1f}%")
    for label, t in tot.items():
        print(f"   {label:7s} {t*1e3:8.1f} ms total")
    return {"matches": counts, "pruned": pruned, "kept": kept}


def connection_query(g) -> QueryTemplate:
    """Paper Fig. 1: a paper by author A connected within 4 hops to a
    paper by author B — anchored on two real author names."""
    pa = g.predicate_id("author")
    authors = np.unique(g.dst[g.pred == pa])
    a1, a2 = (str(g.labels[authors[3]]), str(g.labels[authors[7]]))
    return QueryTemplate(
        keywords=["Paper/", a1, "Paper/", a2],
        edges=[QueryEdge(0, 1, pa), QueryEdge(2, 3, pa)],
        connections=[ConnectionEdge(0, 2, max_dist=4)],
    )


def connection_edge_demo(g, device: str = "cuda") -> int:
    print("-- connection-edge query (paper Fig. 1 style) --")
    q = connection_query(g)
    eng = Dataset.build(g, variant="h3").engine("h3", device=device)
    t0 = time.perf_counter()
    r = eng.execute(q)
    print(f"   authors: {q.keywords[1]!r} / {q.keywords[3]!r}")
    print(f"   matches={r.count} in {time.perf_counter()-t0:.2f}s "
          f"(connectivity check: {r.stats.conn_time:.2f}s)")
    if r.count:
        inst = instantiate_connections(g, r, q, max_paths=3)
        path = next(iter(inst[0].values()))[0]
        print("   one instantiated path:",
              " -> ".join(str(g.labels[n]) for n in path))
    return r.count


def run(device: str = "cuda", scale: float = 0.06) -> dict:
    out = {"lubm": workload("LUBM-like", lubm_like(scale=scale, seed=1),
                            device)}
    g = dblp_like(scale=scale, seed=1)
    out["dblp"] = workload("DBLP-like", g, device)
    out["connection"] = connection_edge_demo(g, device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
