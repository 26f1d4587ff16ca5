"""The port's example drivers (``repro_torch.examples``) on the CPU at a
small scale, held to the reference library's run of the same queries
(train_lm: a resumed run against an uninterrupted one).

Each driver function runs the port on the CPU and returns what it
counted; the test runs the same graphs, templates and streams through
``repro`` (engines and ``QueryServer``, kernels on their plain versions)
and holds the match counts — and for the governed stream the typed
errors, the ladder's counters, the delta's migration counts and the
snapshot replay — equal.
"""
import time

import numpy as np
import pytest

import repro.core as J
import repro.data as JD
import repro.serve as JS
import repro.serve.governor as JGOV
import repro_torch.serve.governor as TGOV
from repro.testing import Fault as JFault, FaultInjector as JInjector
from repro_torch.examples import (quickstart, rdf_scenario, serve_queries,
                                  train_lm)

SCALE = 0.02


def ref_count(g, variant, q, ds=None):
    ds = ds or J.Dataset.build(g, variant=variant)
    return ds.engine(variant, impl="ref").execute(q).count


def test_quickstart_matches_reference(capsys):
    got = quickstart.run(device="cpu", scale=SCALE)
    g = JD.dblp_like(scale=SCALE, seed=7)
    q = JD.random_query(g, size=6, seed=11)
    want = {v: ref_count(g, v, q) for v in quickstart.VARIANTS}
    assert got["variants"] == want
    assert got["served"] == [want["rdf_h"]] * 3
    assert got["plan_cache"] == {"hits": 2, "misses": 1}
    out = capsys.readouterr().out
    assert "== 6. observability: EXPLAIN the plan the server learned ==" \
        in out


def test_rdf_scenario_matches_reference():
    got = rdf_scenario.run(device="cpu", scale=0.03)
    for name, gen in (("lubm", JD.lubm_like), ("dblp", JD.dblp_like)):
        g = gen(scale=0.03, seed=1)
        ds = J.Dataset.build(g, variant="spath_ni2")
        for label, variant in (("never", "stwig+"), ("always", "spath_ni2"),
                               ("hybrid", "rdf_h")):
            want = [ref_count(g, variant,
                              JD.random_query(g, size=6, seed=900 + s), ds)
                    for s in range(rdf_scenario.N_QUERIES)]
            assert got[name]["matches"][label] == want, (name, label)
    g = JD.dblp_like(scale=0.03, seed=1)
    pa = g.predicate_id("author")
    authors = np.unique(g.dst[g.pred == pa])
    a1, a2 = str(g.labels[authors[3]]), str(g.labels[authors[7]])
    q = J.QueryTemplate(keywords=["Paper/", a1, "Paper/", a2],
                        edges=[J.QueryEdge(0, 1, pa), J.QueryEdge(2, 3, pa)],
                        connections=[J.ConnectionEdge(0, 2, max_dist=4)])
    assert got["connection"] == ref_count(g, "h3", q)


def _ref_stream(g, templates=6, queries=60, size=5, zipf=1.3, seed=0):
    """The reference script's template pool and zipfian stream."""
    pool = [JD.random_query(g, size=size, seed=100 + i, n_connection=i % 2,
                            d_c=3) for i in range(templates)]
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(zipf, queries), templates) - 1
    return pool, [pool[r] for r in ranks]


def test_serve_queries_matches_reference():
    got = serve_queries.main(["--device", "cpu", "--scale", str(SCALE),
                              "--queries", "30"])
    g = JD.dblp_like(scale=SCALE, seed=1)
    ds = J.Dataset.build(g, variant="rdf_h")
    eng = ds.engine("rdf_h", impl="ref")
    _, stream = _ref_stream(g, queries=30)
    assert got["matches"] == sum(eng.execute(q).count for q in stream)
    assert got["errors"] == {}


def _ref_delta(g, seed=0):
    """The reference script's delta (``examples/serve_queries.py``)."""
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


class _StoppedClock:
    """The time module as the governors see it, with time.monotonic
    stopped: a breaker's or a rung's cooldown then never runs out within
    the test, however slowly a loaded host runs it, so both stacks pass
    through the same states (a cooldown that runs out in one stack's run
    and not in the other's changes its replay's degraded count)."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def monotonic():
        return 1000.0


def test_serve_queries_governed_chaos_delta_snapshot(tmp_path, monkeypatch):
    """--governed --chaos --delta --snapshot: the persistent fault drives
    the ladder; the reference server under the same fault, delta and
    snapshot counts the same matches, errors, rungs, migrations and warm
    replays.  The governors' monotonic clock is stopped (_StoppedClock)
    in both stacks."""
    for mod in (JGOV, TGOV):
        monkeypatch.setattr(mod, "time", _StoppedClock())
    got = serve_queries.main(
        ["--device", "cpu", "--scale", str(SCALE), "--queries", "40",
         "--governed", "--chaos", "--delta",
         "--snapshot", str(tmp_path / "port.snap")])
    g = JD.dblp_like(scale=SCALE, seed=1)
    ds = J.Dataset.build(g, variant="rdf_h")
    pool, stream = _ref_stream(g, queries=40)
    kw = dict(governor=JS.GovernorConfig(deadline_s=None, max_pending=None),
              cfg=J.EngineConfig(check_policy="selective", d_check=2,
                                 impl="ref",
                                 thresholds=J.Thresholds(nested_join_max=1),
                                 join_impl="sorted",
                                 connection_impl="reach"),
              result_cache_size=64)
    srv = JS.QueryServer(ds, **kw)
    matches, errors = 0, {}
    with JInjector(JFault("kernel_dispatch", "raise", every=1)):
        for s in range(0, len(stream), 8):
            for f in srv.submit_many(stream[s:s + 8], wait=True):
                try:
                    matches += f.result().count
                except JS.ServingError as e:
                    errors[type(e).__name__] = \
                        errors.get(type(e).__name__, 0) + 1
    gov = srv.telemetry()["governor"]
    assert got["matches"] == matches and got["errors"] == errors
    assert got["governor"] == {k: gov[k] for k in
                               ("degraded_queries", "degraded_by_rung",
                                "exhausted")}
    assert got["governor"]["degraded_queries"] > 0

    srv.query(pool[0])
    info = srv.apply_delta(*_ref_delta(g))
    r1, r2 = srv.query(pool[0]), srv.query(pool[0])
    gd = got["delta"]
    for k in ("mode", "version", "plans_kept", "plans_invalidated",
              "plans_dropped", "reach_dropped", "results_kept",
              "results_dropped", "dataset_id"):
        assert gd["info"][k] == info[k], k
    assert gd["matches"] == [r1.count, r2.count]
    assert gd["result_cache_hit"] == bool(r2.stats.result_cache_hit)

    manifest = srv.save_snapshot(str(tmp_path / "ref.snap"))
    srv2 = JS.QueryServer(srv.dataset, **kw)
    srv2.restore_snapshot(str(tmp_path / "ref.snap"))
    replay = [srv2.query(q) for q in pool]
    assert got["snapshot"] == {
        "plans": manifest["plans"],
        "warm": sum(bool(r.stats.cache_hit) for r in replay),
        "degraded": sum(bool(r.stats.degraded_steps) for r in replay),
        "matches": [r.count for r in replay]}


def test_train_lm_resume_ends_where_an_uninterrupted_run_ends(tmp_path):
    """train_lm on the CPU: steps 0-8 with a checkpoint every 3 (after
    steps 3 and 6), then the same run again with --resume, which restores
    step 6 (the parameters and the AdamW state) and takes steps 7 and 8:
    its final loss is the uninterrupted run's, exactly (the CPU's
    arithmetic is deterministic)."""
    argv = ["--device", "cpu", "--arch", "qwen2-0.5b", "--steps", "9",
            "--seq", "32", "--batch", "4", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path)]
    full = train_lm.main(argv)
    assert full["start"] == 0 and full["resumed_from"] is None
    assert full["checkpoints"] == [3, 6]
    assert np.isfinite(full["final_loss"])
    resumed = train_lm.main(argv + ["--resume"])
    assert resumed["resumed_from"] == 6 and resumed["start"] == 7
    assert resumed["final_loss"] == full["final_loss"]
    assert resumed["checkpoints"] == [3, 6]


@pytest.mark.parametrize("module", [quickstart, rdf_scenario, serve_queries,
                                    train_lm])
def test_drivers_default_to_the_card(module):
    """--device defaults to the card: without CUDA a driver raises before
    it answers anything on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    argv = ["--scale", "0.01"] if module is serve_queries else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
