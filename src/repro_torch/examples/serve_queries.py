"""Serving driver: repeat-template RDF query traffic through QueryServer,
on the card unless ``--device cpu`` is given.

Generates a synthetic RDF dataset, samples a pool of query templates, and
replays a zipfian mix of them (the serving assumption: the same templates
arrive over and over).  Prints per-phase latency, plan-cache hit rate,
batch dedup, and the calibration state the server learned online.

    PYTHONPATH=src python -m repro_torch.examples.serve_queries \\
        --dataset dblp --scale 0.05 --templates 6 --queries 60

Governed serving (deadlines + admission control + degradation ladder +
circuit breaker) with optional injected chaos:

    PYTHONPATH=src python -m repro_torch.examples.serve_queries \\
        --governed --deadline-ms 250 --max-pending 6 --chaos

Warm-restart durability: ``--snapshot PATH`` saves the server's learned
state (plans, calibration, governor memory) after the stream, then
"restarts" into a fresh server via ``restore_snapshot`` and replays one
query per template — every one should hit the plan cache warm:

    PYTHONPATH=src python -m repro_torch.examples.serve_queries \\
        --governed --snapshot /tmp/serve.snap

Observability: ``--trace PATH`` records every query (one trace id from
submit through batching, governor routing, each engine join and the
answer's copy to the host) and exports a Chrome trace viewable in
chrome://tracing or ui.perfetto.dev, on ``torch.profiler``'s clock
(Unix-epoch microseconds), so it overlays a profiler trace of the run;
``--explain`` prints each template's EXPLAIN report — the §4.3 check
decision with its τ terms, the Selinger join order, and the learned
join sequence with estimated-vs-observed rows:

    PYTHONPATH=src python -m repro_torch.examples.serve_queries \\
        --governed --chaos --trace /tmp/serve_trace.json --explain
"""
from __future__ import annotations

import argparse
import json
import time
from contextlib import nullcontext

import numpy as np

from ..core import Dataset, EngineConfig, Thresholds
from ..data import DATASETS, random_query
from ..serve import GovernorConfig, QueryServer, ServingError


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="dblp", choices=sorted(DATASETS))
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--templates", type=int, default=6,
                    help="distinct query templates in the pool")
    ap.add_argument("--queries", type=int, default=60,
                    help="total queries in the zipfian stream")
    ap.add_argument("--size", type=int, default=5)
    ap.add_argument("--zipf", type=float, default=1.3,
                    help="template popularity skew (higher = hotter head)")
    ap.add_argument("--no-batch", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--governed", action="store_true",
                    help="enable the resource governor (deadlines, "
                         "admission control, ladder, circuit breaker)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-execution-attempt deadline (implies "
                         "--governed)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission-control pending bound (implies "
                         "--governed)")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a persistent sort-merge kernel fault "
                         "during the stream: traffic is served exactly "
                         "through the degradation ladder (implies "
                         "--governed)")
    ap.add_argument("--delta", action="store_true",
                    help="after the stream, apply a triple delta to the "
                         "live server (apply_delta) and show warm-state "
                         "migration plus the exact-repeat result cache")
    ap.add_argument("--snapshot", metavar="PATH", default=None,
                    help="after the stream, save learned state to PATH, "
                         "restore it into a fresh server, and replay one "
                         "query per template on the warm path")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="trace every query and export a Chrome trace "
                         "(chrome://tracing / Perfetto) to PATH after "
                         "the stream, on torch.profiler's clock "
                         "(Unix-epoch microseconds): it overlays a "
                         "profiler trace of the same run")
    ap.add_argument("--explain", action="store_true",
                    help="print the EXPLAIN report (check decision, "
                         "join order, learned join sizes) for each "
                         "template after the stream")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the server's engine runs: cuda (default) "
                         "or cpu")
    return ap


def template_pool(g, templates: int, size: int) -> list:
    return [random_query(g, size=size, seed=100 + i, n_connection=i % 2,
                         d_c=3) for i in range(templates)]


def zipf_ranks(templates: int, queries: int, zipf: float,
               seed: int) -> np.ndarray:
    """The pool index of each query of the stream."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(zipf, queries), templates) - 1


def delta_triples(g, seed: int) -> tuple[list, list]:
    """(inserts, deletes) of about num_edges / 200 triples each: deletes
    whose endpoints stay mentioned afterwards (dropping a node's last
    edge would renumber ids and force a full rebuild), and inserts that
    recombine subject/object pairs within one predicate so node kinds stay
    consistent and the incremental path can run."""
    lab, prd = g.labels, g.predicates
    k = max(6, g.num_edges // 200)
    rng2 = np.random.default_rng(seed + 1)
    subj = np.bincount(g.src, minlength=g.num_nodes)
    ment = subj + np.bincount(g.dst, minlength=g.num_nodes)
    safe = np.flatnonzero((subj[g.src] >= 2) & (ment[g.src] >= 3)
                          & (ment[g.dst] >= 3))
    pick = rng2.choice(g.num_edges, size=2 * k, replace=False)
    dels = rng2.choice(safe, size=min(k, safe.size), replace=False)
    deletes = [(lab[g.src[i]], prd[g.pred[i]], lab[g.dst[i]]) for i in dels]
    inserts = [(lab[g.src[i]], prd[g.pred[i]], lab[g.dst[j]])
               for i, j in zip(pick[k:], np.roll(pick[k:], 1))
               if g.pred[i] == g.pred[j]]
    return inserts, deletes


def serve_stream(srv, stream, chunk: int = 8) -> tuple[int, dict]:
    """Submit ``stream`` in chunks (each flush one shape-batched admission
    window); the total match count and the typed errors by class."""
    matches, errors = 0, {}
    for s in range(0, len(stream), chunk):
        futs = srv.submit_many(stream[s:s + chunk], wait=True)
        for f in futs:
            try:
                matches += f.result().count
            except ServingError as e:
                kind = type(e).__name__
                errors[kind] = errors.get(kind, 0) + 1
    return matches, errors


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    governed = (args.governed or args.chaos or args.deadline_ms is not None
                or args.max_pending is not None)

    print(f"== build {args.dataset} graph (scale={args.scale}) ==")
    g = DATASETS[args.dataset](scale=args.scale, seed=1)
    ds = Dataset.build(g, variant="rdf_h")
    print(f"   {g.num_nodes} nodes, {g.num_edges} triples  "
          f"(dataset {ds.cache_key})")

    print(f"== template pool: {args.templates} templates ==")
    pool = template_pool(g, args.templates, args.size)
    stream = [pool[r] for r in zipf_ranks(args.templates, args.queries,
                                          args.zipf, args.seed)]

    srv_kw = {}
    if governed:
        srv_kw["governor"] = GovernorConfig(
            deadline_s=(args.deadline_ms / 1e3
                        if args.deadline_ms is not None else None),
            max_pending=args.max_pending)
    if args.chaos:
        # route joins through the sort-merge kernel so the injected
        # fault actually lands (tiny tables otherwise go nested)
        srv_kw["cfg"] = EngineConfig(
            check_policy="selective", d_check=2, impl="ref",
            thresholds=Thresholds(nested_join_max=1),
            join_impl="sorted", connection_impl="reach",
            device=args.device)
    else:
        srv_kw["device"] = args.device
    if args.trace is not None:
        from ..obs import Tracer
        srv_kw["tracer"] = Tracer(max_traces=args.queries + 16)
    if args.delta:
        # exact repeats after the delta should be served from stored
        # rows without touching the engine
        srv_kw["result_cache_size"] = 64
    srv = QueryServer(ds, batching=not args.no_batch,
                      calibrate=not args.no_calibrate, **srv_kw)
    print(f"== serve {args.queries} queries "
          f"(zipf alpha={args.zipf}, batching={srv.batching}, "
          f"governed={governed}, chaos={args.chaos}) ==")

    if args.chaos:
        from ..testing import Fault, FaultInjector
        injector = FaultInjector(Fault("kernel_dispatch", "raise", every=1))
    else:
        injector = nullcontext()
    with injector:
        matches, errors = serve_stream(srv, stream)

    t = srv.telemetry()
    lat, pc, b = t["latency"], t["plan_cache"], t["batch"]
    print(f"   matches={matches}  typed-errors={errors or 0}")
    print(f"   latency p50={lat['p50']*1e3:.1f}ms p99={lat['p99']*1e3:.1f}ms")
    print(f"   cold p50={lat['cold_p50']*1e3:.1f}ms ({lat['n_cold']} queries)"
          f"  warm p50={lat['warm_p50']*1e3:.1f}ms ({lat['n_warm']} queries)")
    print(f"   plan cache: {pc['hits']}/{pc['hits'] + pc['misses']} hits "
          f"({pc['hit_rate']:.0%}), {pc['entries']} entries")
    print(f"   batching: {b['queries']} queries -> {b['executions']} "
          f"executions ({b['dedup_saved']} deduped, {b['shed']} shed)")
    rc = t["reach_cache"]
    if rc is not None:
        print(f"   reach cache: {rc['entries']} entries, {rc['bytes']}B"
              f" (budget {rc['max_bytes']})")
    if t["calibration"] is not None:
        print("   calibration:", json.dumps(
            {k: round(v, 4) if isinstance(v, float) else v
             for k, v in t["calibration"].items()}))
    gov = t.get("governor")
    if gov is not None:
        print(f"   governor: shed_submit={gov['shed_submit']} "
              f"shed_flush={gov['shed_flush']} "
              f"budget_exceeded={gov['budget_exceeded']} "
              f"degraded={gov['degraded_queries']} "
              f"by_rung={gov['degraded_by_rung']} "
              f"exhausted={gov['exhausted']}")
        br = gov["breaker"]
        print(f"   breaker: trips={br['trips']} denials={br['denials']} "
              f"probes={br['probes']} recoveries={br['recoveries']} "
              f"open={br['open']}")
    out = {"matches": matches, "errors": errors,
           "plan_cache": {k: pc[k] for k in ("hits", "misses")},
           "governor": None if gov is None else
           {k: gov[k] for k in ("degraded_queries", "degraded_by_rung",
                                "exhausted")}}

    if args.trace is not None:
        info = srv.tracer.export_chrome(args.trace)
        print(f"== trace: {info['traces']} traces, {info['events']} "
              f"events -> {info['path']} (open in chrome://tracing or "
              "ui.perfetto.dev) ==")

    if args.explain:
        print("== EXPLAIN per template ==")
        for i, q in enumerate(pool):
            print(f"-- template {i} --")
            print(srv.explain(q))

    if args.delta:
        print("== delta ingest: mutate the live dataset ==")
        inserts, deletes = delta_triples(g, args.seed)
        q0 = pool[0]
        srv.query(q0)                        # warm an exact-repeat entry
        info = srv.apply_delta(inserts, deletes)
        print(f"   {len(inserts)} inserts / {len(deletes)} deletes -> "
              f"mode={info['mode']}, now {info['dataset_id']}")
        print(f"   plans kept={info['plans_kept']} "
              f"invalidated={info['plans_invalidated']} "
              f"dropped={info['plans_dropped']}; "
              f"reach entries dropped={info['reach_dropped']}; "
              f"results kept={info['results_kept']} "
              f"dropped={info['results_dropped']}")
        r1 = srv.query(q0)                   # first post-delta execution
        r2 = srv.query(q0)                   # exact repeat
        rcache = srv.telemetry()["result_cache"]
        print(f"   repeat after delta: result_cache_hit="
              f"{r2.stats.result_cache_hit} "
              f"(cache: {rcache['hits']} hits, "
              f"{rcache['entries']} entries, {rcache['bytes']}B)")
        out["delta"] = {"info": info, "matches": [r1.count, r2.count],
                        "result_cache_hit": bool(r2.stats.result_cache_hit)}

    if args.snapshot is not None:
        print(f"== snapshot round trip: {args.snapshot} ==")
        manifest = srv.save_snapshot(args.snapshot)
        print(f"   saved {manifest['plans']} plans, "
              f"{manifest['bytes']}B (format v{manifest['format_version']})")
        srv2 = QueryServer(srv.dataset, batching=not args.no_batch,
                           calibrate=not args.no_calibrate, **srv_kw)
        t0 = time.perf_counter()
        srv2.restore_snapshot(args.snapshot)
        restore_ms = (time.perf_counter() - t0) * 1e3
        warm = degraded = 0
        replay = []
        for q in pool:
            r = srv2.query(q)
            replay.append(r.count)
            warm += bool(r.stats.cache_hit)
            degraded += bool(r.stats.degraded_steps)
        pc2 = srv2.telemetry()["plan_cache"]
        print(f"   restored in {restore_ms:.1f}ms; replayed "
              f"{len(pool)} templates: plan cache {pc2['hits']} hits / "
              f"{pc2['misses']} misses, {warm} warm executions"
              + (f", {degraded} still rung-memory-degraded (the snapshot"
                 " preserves fault memory too)" if degraded else
                 " (first post-restore execution skips"
                 " prepare/plan/decide/check)"))
        out["snapshot"] = {"plans": manifest["plans"], "warm": warm,
                           "degraded": degraded, "matches": replay}
    return out


if __name__ == "__main__":
    main()
