"""Serving tier of the port against the reference: plan cache,
fingerprints, batching, calibration (twin of ``tests/test_serve.py``).

Every test runs the reference test's scenario on both stacks
(``torch_twin.twin``): the JAX package with ``impl="ref"`` and the port
with ``impl="ref", device="cpu"``, same graph, seeds and request stream.
The reference test's own claims are asserted on each side, and the
observations — result sets, plan-cache hits and misses, batch telemetry,
calibrator state, ``budget_checks``, metrics counters — must be equal.
"""
import json

import numpy as np
import pytest

from torch_twin import (REF, PORT, mask_explain, outcome, outcomes,
                        per_stack, permute, run_stats, telemetry_view, twin)


@per_stack
def fx(S):
    g = S.graph(n_nodes=120, n_edges=360, n_preds=4, n_literals=30, seed=3)
    return g, S.pool(g, 10)


def _fresh(S, g, queries):
    eng = S.engine(g)
    return [eng.execute(q).result_set() for q in queries]


def _mk_stats(S, **kw):
    qs = S.core.QueryStats()
    for k, v in kw.items():
        setattr(qs, k, v)
    return qs


# ----------------------- canonical fingerprints ------------------------ #
def test_fingerprint_invariant_under_renumbering():
    def scenario(S):
        g, pool = fx(S)
        rng = np.random.default_rng(0)
        out = []
        for q in pool:
            fp = S.serve.template_fingerprint(q)
            for _ in range(4):
                perm = rng.permutation(q.num_nodes).tolist()
                assert S.serve.template_fingerprint(permute(S, q, perm)) \
                    == fp
            out.append(fp)
        return out
    fps = twin(scenario)
    assert len(set(fps)) == len(fps)     # distinguishes the templates


def test_fingerprint_direction_and_bidirectional_symmetry():
    def scenario(S):
        Q, E, C = (S.qmod.QueryTemplate, S.qmod.QueryEdge,
                   S.qmod.ConnectionEdge)
        fp = S.serve.template_fingerprint
        a = Q(keywords=["X/", "Y/"], edges=[E(0, 1, 2)])
        b = Q(keywords=["X/", "Y/"], edges=[E(1, 0, 2)])
        ca = Q(keywords=["X/", "Y/"], connections=[C(0, 1, 3, True)])
        cb = Q(keywords=["X/", "Y/"], connections=[C(1, 0, 3, True)])
        da = Q(keywords=["X/", "Y/"], connections=[C(0, 1, 3, False)])
        db = Q(keywords=["X/", "Y/"], connections=[C(1, 0, 3, False)])
        assert fp(a) != fp(b)
        assert fp(ca) == fp(cb)
        assert fp(da) != fp(db)
        return [fp(x) for x in (a, b, ca, cb, da, db)]
    twin(scenario)


def test_canonicalize_symmetric_templates():
    def scenario(S):
        Q, E = S.qmod.QueryTemplate, S.qmod.QueryEdge
        fp = S.serve.template_fingerprint
        sym = Q(keywords=["A/"] * 10)
        base = Q(keywords=["A/", "A/", "B/"],
                 edges=[E(0, 2, 1), E(1, 2, 1)])
        for perm in ([1, 0, 2], [2, 1, 0], [0, 2, 1]):
            assert fp(permute(S, base, perm)) == fp(base)
        return fp(sym), fp(base), S.serve.canonicalize(base)[1:]
    twin(scenario)


def test_permuted_template_hits_cache_and_remaps():
    def scenario(S):
        g, pool = fx(S)
        q = pool[1]
        srv = S.server(g)
        r = srv.query(q)
        assert r.result_set() == _fresh(S, g, [q])[0]
        qp = permute(S, q, list(reversed(range(q.num_nodes))))
        rp = srv.query(qp)
        assert rp.result_set() == _fresh(S, g, [qp])[0]
        pc = srv.telemetry()["plan_cache"]
        assert pc["hits"] >= 1 and pc["entries"] == 1
        return r.result_set(), rp.result_set(), rp.cols, telemetry_view(srv)
    twin(scenario)


# --------------------------- plan cache -------------------------------- #
def test_plan_cache_lru_eviction():
    def scenario(S):
        cache = S.serve.PlanCache(max_entries=2)

        class _PQ:
            version = 0
        a, b, c = _PQ(), _PQ(), _PQ()
        cache.put("d", "a", a)
        cache.put("d", "b", b)
        assert cache.get("d", "a") is a
        cache.put("d", "c", c)
        assert len(cache) == 2 and cache.evictions == 1
        assert cache.get("d", "b") is None
        assert cache.get("d", "a") is a and cache.get("d", "c") is c
        return cache.snapshot()
    twin(scenario)


def test_prepare_cached_revalidates_on_version_change():
    def scenario(S):
        g, pool = fx(S)
        eng = S.engine(g)
        cache = S.serve.PlanCache()
        did = S.serve.dataset_key(g)
        pq1, _, hit1 = S.serve.prepare_cached(eng, pool[0], cache, did,
                                              version=0)
        eng.execute_prepared(pq1)
        pq2, _, hit2 = S.serve.prepare_cached(eng, pool[0], cache, did,
                                              version=1)
        assert hit2 and pq2 is pq1 and pq2.version == 1
        assert pq2.executions == 1
        return hit1, hit2, did, cache.snapshot(), pq2.join_seq
    twin(scenario)


def test_revalidate_flip_resets_learned_state():
    def scenario(S):
        g, pool = fx(S)
        eng = S.engine(g)
        eng.cfg.thresholds = S.core.Thresholds(tau_iter=0.0, tau_join=0.0,
                                               tau_sel=0.0)
        pq = eng.prepare(pool[0])
        assert pq.use_check
        warm = eng.execute_prepared(pq)
        assert pq.masks is not None and pq.executions == 1
        eng.cfg.thresholds = S.core.Thresholds(tau_iter=1e18,
                                               tau_join=1e18, tau_sel=1e18)
        kept = eng.revalidate(pq, version=1)
        assert not kept and not pq.use_check
        assert pq.masks is None and pq.executions == 0 and pq.join_seq == []
        reset = eng.execute_prepared(pq)
        assert reset.result_set() == _fresh(S, g, [pool[0]])[0]
        return (kept, warm.result_set(), run_stats(warm), run_stats(reset),
                pq.join_seq)
    twin(scenario)


def test_revalidate_stable_decision_keeps_learned_state():
    def scenario(S):
        g, pool = fx(S)
        eng = S.engine(g)
        pq = eng.prepare(pool[1])
        eng.execute_prepared(pq)
        seq = list(pq.join_seq)
        kept = eng.revalidate(pq, version=3)
        assert kept and pq.version == 3 and pq.join_seq == seq
        again = eng.execute_prepared(pq)
        assert again.stats.cache_hit
        return kept, seq, run_stats(again)
    twin(scenario)


def test_reach_cache_lru_bound():
    def scenario(S):
        rc = S.core.ReachCache(max_entries=3)
        for i in range(5):
            rc.put_array(i, 1, 1, np.asarray([i], np.int32))
        assert len(rc) == 3 and rc.evictions == 2
        return (rc.get_array(0, 1, 1), rc.get_array(4, 1, 1).tolist(),
                rc.hits, rc.misses, rc.total_bytes)
    twin(scenario)


# ---------------------- serving identity grid --------------------------- #
@pytest.mark.parametrize("batching", [False, True])
@pytest.mark.parametrize("calibrate", [False, True])
def test_serving_identity_grid(batching, calibrate):
    def scenario(S):
        g, pool = fx(S)
        want = _fresh(S, g, pool)
        srv = S.server(g, batching=batching, calibrate=calibrate)
        stream = pool + pool[::-1] + pool
        refs = want + want[::-1] + want
        futs = srv.submit_many(stream, wait=True)
        for f, ref in zip(futs, refs):
            assert f.result().result_set() == ref
        t = telemetry_view(srv)
        assert t["plan_cache"]["entries"] == len(pool)
        assert t["plan_cache"]["hits"] >= len(pool)
        assert t["queries_served"] == len(stream)
        return outcomes(futs), t
    twin(scenario)


def test_warm_execution_skips_planning_and_check(monkeypatch):
    def scenario(S):
        g, pool = fx(S)
        srv = S.server(g, calibrate=False)
        cold = srv.query(pool[1])
        assert not cold.stats.cache_hit

        def _boom(*a, **k):
            raise AssertionError("planning re-entered on warm execution")
        with monkeypatch.context() as m:
            for fn in ("plan_table_joins", "plan_connections", "decide",
                       "check_interval_candidates",
                       "connection_selectivity", "endpoint_reach",
                       "choose_connection_impl"):
                m.setattr(S.engine_mod, fn, _boom)
            warm = srv.query(pool[1])
        assert warm.stats.cache_hit and warm.stats.join_retries == 0
        assert warm.result_set() == cold.result_set()
        return run_stats(cold), run_stats(warm), warm.result_set()
    twin(scenario)


def test_calibrated_thresholds_never_change_results():
    def scenario(S):
        g, pool = fx(S)
        want = _fresh(S, g, pool)
        srv = S.server(g, calibrate=True,
                       thresholds=S.core.Thresholds(tau_iter=0.1,
                                                    tau_join=0.1,
                                                    tau_sel=0.01))
        for _ in range(3):
            for q, ref in zip(pool, want):
                assert srv.query(q).result_set() == ref
        assert srv.calibrator.observed > 0
        return srv.calibrator.snapshot(), telemetry_view(srv)
    twin(scenario)


# ----------------------------- batching -------------------------------- #
def test_shape_batcher_dedups_identical_fingerprints():
    def scenario(S):
        batcher = S.serve.ShapeBatcher()
        calls = []

        def execute(item):
            calls.append(item)
            return f"r{item}"
        batcher.add(1, "fpA", 64)
        batcher.add(2, "fpA", 64)
        batcher.add(3, "fpB", 64)
        out = dict(batcher.flush(execute))
        assert out == {1: "r1", 2: "r1", 3: "r3"}
        return calls, out, batcher.telemetry.snapshot()
    twin(scenario)


def test_batched_dedup_still_remaps_columns():
    def scenario(S):
        g, pool = fx(S)
        q = pool[1]
        qp = permute(S, q, list(reversed(range(q.num_nodes))))
        srv = S.server(g, batching=True)
        f1, f2 = srv.submit_many([q, qp], wait=True)
        assert f1.result().result_set() == _fresh(S, g, [q])[0]
        assert f2.result().result_set() == _fresh(S, g, [qp])[0]
        assert srv.batcher.telemetry.executions == 1
        assert srv.batcher.telemetry.dedup_saved == 1
        return outcomes([f1, f2]), srv.batcher.telemetry.snapshot()
    twin(scenario)


def test_failed_bucket_does_not_orphan_other_futures(monkeypatch):
    def scenario(S):
        g, pool = fx(S)
        srv = S.server(g, batching=False)
        real = srv.engine.execute_prepared
        bad = S.serve.template_fingerprint(pool[0])

        def flaky(pq):
            if pq.fingerprint == bad:
                raise RuntimeError("engine exploded")
            return real(pq)
        monkeypatch.setattr(srv.engine, "execute_prepared", flaky)
        futs = srv.submit_many([pool[0], pool[1]], wait=True)
        assert all(f.done() for f in futs)
        with pytest.raises(RuntimeError, match="engine exploded"):
            futs[0].result()
        assert futs[1].result().result_set() == \
            _fresh(S, g, [pool[1]])[0]
        assert srv.query_errors == 1
        return outcomes(futs), telemetry_view(srv)
    twin(scenario)


def test_warm_replay_pins_connection_strategy():
    def scenario(S):
        g, pool = fx(S)
        srv = S.server(g, calibrate=False)
        cold = srv.query(pool[1])
        assert sum(cold.stats.conn_strategies.values()) >= 1
        srv.engine.cfg.cost_model.reach_scale = 1e9
        srv.engine.cfg.cost_model.cross_scale = 1e-9
        warm = srv.query(pool[1])
        assert warm.stats.cache_hit and warm.stats.join_retries == 0
        assert warm.stats.conn_strategies == cold.stats.conn_strategies
        assert warm.result_set() == cold.result_set()
        return run_stats(cold), run_stats(warm)
    twin(scenario)


def test_result_future_lazy_flush():
    def scenario(S):
        g, pool = fx(S)
        srv = S.server(g)
        f = srv.submit(pool[0])
        assert not f.done()
        res = f.result()
        assert f.done() and f.latency is not None
        assert res.result_set() == _fresh(S, g, [pool[0]])[0]
        return outcome(f), telemetry_view(srv)
    twin(scenario)


# ---------------------------- calibrator ------------------------------- #
def test_calibrator_join_bias_direction():
    def scenario(S):
        th, cm = S.core.Thresholds(), S.core.CostModel()
        cal = S.serve.Calibrator(th, cm, alpha=1.0)
        cal.observe(_mk_stats(S, n_estimated_joins=2,
                              join_est_log_bias=2 * np.log(10.0)))
        low = cm.join_est_scale
        assert low < 1.0
        for _ in range(20):
            cal.observe(_mk_stats(S, n_estimated_joins=1,
                                  join_est_log_bias=-np.log(1000.0)))
        assert 1.0 < cm.join_est_scale <= S.serve.Calibrator.SCALE_BOUND
        return low, cm.join_est_scale, cal.snapshot()
    twin(scenario)


def test_calibrator_tau_sel_separates_observed_selectivities():
    def scenario(S):
        def plan(sel):
            return S.planner.PlanDecision(
                use_check=True, complex_query=True, max_selectivity=sel,
                est_iterations=1e6, est_join_product=1e12)
        th, cm = S.core.Thresholds(tau_sel=0.01), S.core.CostModel()
        cal = S.serve.Calibrator(th, cm)
        seen = []
        for sel, after, hit in ((4.0, 99, False), (12.0, 10, False),
                                (4.0, 99, True)):
            cal.observe(_mk_stats(S, used_check=True, cache_hit=hit,
                                  candidates_before=100,
                                  candidates_after=after, plan=plan(sel)))
            seen.append((th.tau_sel, cal.version))
        assert seen[0][0] > 4.0 and 4.0 < seen[1][0] < 12.0
        assert seen[2][1] == seen[1][1]
        return seen
    twin(scenario)


def test_calibrator_ignores_warm_and_policy_forced_observations():
    def scenario(S):
        th, cm = S.core.Thresholds(), S.core.CostModel()
        cal = S.serve.Calibrator(th, cm, alpha=1.0)
        cal.observe(_mk_stats(S, cache_hit=True, n_estimated_joins=2,
                              join_est_log_bias=5.0, conn_est_pairs=100.0,
                              conn_connected_pairs=1, conn_reach_pairs=5,
                              conn_est_reach_pairs=500.0))
        cal.observe(_mk_stats(S, used_check=True, plan=None,
                              candidates_before=100, candidates_after=100))
        assert (cm.join_est_scale, cm.conn_sel_scale, cm.reach_scale) \
            == (1.0, 1.0, 1.0)
        assert cal.version == 0
        assert th.tau_sel == S.core.Thresholds().tau_sel
        return cal.snapshot()
    twin(scenario)


def test_cross_impl_edges_do_not_accrue_conn_predictions():
    def scenario(S):
        g, pool = fx(S)
        out = []
        for impl in ("cross", "reach"):
            eng = S.engine(g)
            eng.cfg.connection_impl = impl
            qs = eng.execute(pool[1]).stats
            assert sum(qs.conn_strategies.values()) >= 1
            out.append((qs.conn_est_pairs, qs.conn_est_reach_pairs,
                        qs.conn_strategies))
        assert out[0][:2] == (0.0, 0.0) and out[1][0] > 0.0
        return out
    twin(scenario)


def test_calibrator_join_scale_converges_and_bounds_anchor():
    def scenario(S):
        th, cm = S.core.Thresholds(), S.core.CostModel()
        cal = S.serve.Calibrator(th, cm, alpha=1.0)
        for _ in range(10):
            bias = np.log(4.0) + np.log(cm.join_est_scale)
            cal.observe(_mk_stats(S, n_estimated_joins=1,
                                  join_est_log_bias=bias))
        assert np.isclose(cm.join_est_scale, 0.25, rtol=1e-6)
        plan = S.planner.PlanDecision(
            use_check=True, complex_query=True, max_selectivity=1e9,
            est_iterations=1e6, est_join_product=1e12)
        th2 = S.core.Thresholds(tau_iter=1.0, tau_join=1.0, tau_sel=0.01)
        cal2 = S.serve.Calibrator(th2, S.core.CostModel())
        for _ in range(100):
            cal2.observe(_mk_stats(S, used_check=True, plan=plan,
                                   candidates_before=100,
                                   candidates_after=100))
        assert th2.tau_sel == \
            S.core.Thresholds().tau_sel * S.serve.Calibrator.TAU_BOUND
        return cm.join_est_scale, th2.tau_sel, cal2.snapshot()
    twin(scenario)


def test_server_does_not_mutate_caller_thresholds():
    def scenario(S):
        g, pool = fx(S)
        th = S.core.Thresholds(tau_iter=0.1, tau_join=0.1, tau_sel=0.01)
        srv = S.server(g, calibrate=True, thresholds=th)
        for _ in range(2):
            for q in pool:
                srv.query(q)
        assert (th.tau_iter, th.tau_join, th.tau_sel) == (0.1, 0.1, 0.01)
        assert srv.calibrator.thresholds is not th
        return srv.calibrator.snapshot()
    twin(scenario)


def test_dataset_key_is_content_based():
    def scenario(S):
        ga = S.graph(n_nodes=60, n_edges=150, seed=1)
        gb = S.graph(n_nodes=60, n_edges=150, seed=2)
        assert S.serve.dataset_key(ga) != S.serve.dataset_key(gb)
        return S.serve.dataset_key(ga), S.serve.dataset_key(gb)
    twin(scenario)


def test_server_rejects_cfg_plus_thresholds_impl_or_device():
    for S in (REF, PORT):
        g, _ = fx(S)
        with pytest.raises(ValueError, match="cfg"):
            S.serve.QueryServer(g, cfg=S.cfg(),
                                thresholds=S.core.Thresholds(tau_sel=0.01))
        with pytest.raises(ValueError, match="cfg"):
            S.serve.QueryServer(g, cfg=S.cfg(), impl="sorted")
    g, _ = fx(PORT)
    for device in ("cpu", "cuda"):      # the default too, when named
        with pytest.raises(ValueError, match="cfg"):
            PORT.serve.QueryServer(g, cfg=PORT.cfg(), device=device)


def test_server_runs_on_cuda_unless_asked_for_cpu():
    import torch
    g, _ = fx(PORT)
    srv = PORT.serve.QueryServer(g, impl="ref", device="cpu")
    assert srv.engine.device.type == "cpu"
    assert srv.engine.cfg.device == "cpu"
    ladder_cfg = PORT.serve.default_ladder()[2].apply(
        srv.engine.cfg, PORT.serve.GovernorConfig())
    assert ladder_cfg.device == "cpu"    # every rung keeps the device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.serve.QueryServer(g)    # the default is the card


# --------------------------- replay estimator --------------------------- #
def test_replay_estimator_replays_then_falls_back():
    def scenario(S):
        base = S.core.JoinEstimator(None, {0: 10, 1: 10})
        rep = S.core.ReplayEstimator(base, [(7, 64), (42, 128)])
        e1 = rep.edge_join(5, None, True, 3)
        e2 = rep.table_join(4, 4, (0,))
        fb = rep.table_join(4, 4, (0,))
        assert getattr(fb, "cap", None) is None
        rep2 = S.core.ReplayEstimator(base, [9])
        return (int(e1), e1.cap, int(e2), e2.cap, fb,
                base.table_join(4, 4, (0,)), rep2.table_join(4, 4, (0,)))
    twin(scenario)


# ------------------------- QueryStats.to_dict --------------------------- #
def test_query_stats_to_dict_schema_matches():
    def scenario(S):
        d = S.core.QueryStats().to_dict()
        json.dumps(d)
        return d
    twin(scenario)


def test_governor_telemetry_schema_matches(tmp_path):
    def scenario(S):
        g, _ = fx(S)
        srv = S.server(g, governor=S.serve.GovernorConfig())
        srv.query(S.query(g, size=3, seed=50))
        gov = srv.telemetry()["governor"]
        assert gov["snapshot"] is None
        json.dumps(gov)
        srv.save_snapshot(tmp_path / f"{S.name}.snap")
        snap = srv.telemetry()["governor"]["snapshot"]
        assert snap["action"] == "saved" and snap["age_s"] >= 0.0
        return telemetry_view(srv)["governor"]
    twin(scenario)


def test_query_stats_to_dict_from_execution():
    def scenario(S):
        g, pool = fx(S)
        d = S.engine(g).execute(pool[1]).stats.to_dict()
        json.dumps(d)
        assert d["plan"] is not None and "max_selectivity" in d["plan"]
        return {k: v for k, v in d.items() if not k.endswith("_time")}
    twin(scenario)


# ------------------------- brute-force anchor --------------------------- #
def test_server_matches_brute_force():
    def scenario(S):
        g, _ = fx(S)
        q = S.query(g, size=4, seed=77, n_connection=1, d_c=2)
        want = {tuple(t[c] for c in sorted(range(q.num_nodes)))
                for t in S.core.brute_force_match(g, q)}
        srv = S.server(g)
        cold, warm = srv.query(q), srv.query(q)
        assert cold.result_set() == want == warm.result_set()
        return want, run_stats(cold), run_stats(warm)
    twin(scenario)


def test_explain_after_serving_matches():
    def scenario(S):
        g, pool = fx(S)
        srv = S.server(g, calibrate=False)
        before = [mask_explain(srv.explain(q)) for q in pool]
        for q in pool:
            srv.query(q)
        return before, [mask_explain(srv.explain(q)) for q in pool]
    twin(scenario)
