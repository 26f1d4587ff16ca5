"""Statistics and planner of the port against the reference: twins of the
twelve tests of ``tests/test_stats_planner.py``, plus ``decide``,
``JoinEstimator``, ``ReplayEstimator``, ``plan_table_joins`` and
``CostModel`` on seeded inputs.

Each scenario runs on both stacks (``torch_twin.twin``) from the same
graphs and seeds, asserts the reference test's own claims on each side and
returns what it observed: the statistics, selectivities, estimates, plans
and results, held equal exactly (the host code is the same numpy, so the
floats are the same bits).
"""
import dataclasses

import numpy as np
import pytest

from torch_twin import twin


def _stats(S, name, scale=0.05, seed=1):
    return S.core.compute_stats(S.data.DATASETS[name](scale=scale, seed=seed))


def _stats_view(st) -> dict:
    """Every field of DatasetStats, arrays as lists."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, np.ndarray):
            v = (v.dtype.str, v.tolist())
        elif isinstance(v, dict):
            v = {k: (x.tolist() if isinstance(x, np.ndarray) else x)
                 for k, x in v.items()}
        out[f.name] = v
    return out


def test_metric_orderings_match_paper():
    def scenario(S):
        lubm, dblp, imdb = (_stats(S, n) for n in ("lubm", "dblp", "imdb"))
        assert lubm.coherence > dblp.coherence > 0
        assert lubm.coherence > imdb.coherence
        assert lubm.specialty < dblp.specialty
        assert lubm.specialty < imdb.specialty
        assert lubm.diversity < imdb.diversity
        return [_stats_view(s) for s in (lubm, dblp, imdb)]
    twin(scenario)


def test_predicate_selectivity_sums_to_one():
    def scenario(S):
        st = _stats(S, "dblp", seed=2)
        assert np.isclose(st.pred_selectivity.sum(), 1.0)
        return st.pred_selectivity.tolist()
    twin(scenario)


def test_literal_selectivity_decreases_with_n():
    def scenario(S):
        st = _stats(S, "dblp", seed=2)
        for table in st.literal_selectivity.values():
            vals = [table[n] for n in sorted(table)]
            assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:]))
        return {pa: dict(t) for pa, t in st.literal_selectivity.items()}
    twin(scenario)


def test_neighborhood_selectivity_nonnegative_and_grows_with_k():
    def scenario(S):
        g = S.data.DATASETS["dblp"](scale=0.05, seed=2)
        st = S.core.compute_stats(g)
        q = S.data.random_query(g, size=5, seed=42)
        out = []
        for node in range(q.num_nodes):
            s1 = S.core.neighborhood_selectivity(q, node, st, 1)
            s2 = S.core.neighborhood_selectivity(q, node, st, 2)
            assert 0 <= s1 <= s2 + 1e-9
            out.append((s1, s2))
        return out
    twin(scenario)


def _decide_inputs(S, seed=7, size=6):
    g = S.data.DATASETS["dblp"](scale=0.05, seed=2)
    st = S.core.compute_stats(g)
    q = S.data.random_query(g, size=size, seed=seed)
    iv = q.intervals(S.engine(g, "stwig+").idmap)
    sizes = {i: int(iv[i, 1] - iv[i, 0]) for i in range(q.num_nodes)}
    trees = [S.core.decompose(q, c, sizes) for c in q.components()]
    return q, trees, sizes, st


def test_planner_thresholds_gate_the_check():
    def scenario(S):
        q, trees, sizes, st = _decide_inputs(S)
        always = S.planner.decide(q, trees, sizes, st,
                                  S.core.Thresholds(0, 0, 0), k=2)
        assert always.use_check
        never = S.planner.decide(q, trees, sizes, st,
                                 S.core.Thresholds(1e18, 1e18, 1e18), k=2)
        assert not never.use_check
        return [dataclasses.asdict(d) for d in (always, never)]
    twin(scenario)


@pytest.mark.parametrize("seed", [3, 7, 11, 19])
def test_decide_matches_reference_across_thresholds(seed):
    """``decide`` under the default, a loose and a tight threshold set:
    the same decision, terms and per-node selectivities."""
    def scenario(S):
        q, trees, sizes, st = _decide_inputs(S, seed=seed)
        out = []
        for th in (S.core.Thresholds(), S.core.Thresholds(10, 1e3, 2),
                   S.core.Thresholds(1e5, 1e9, 20)):
            d = S.planner.decide(q, trees, sizes, st, th, k=2)
            out.append((dataclasses.asdict(d),
                        S.planner.decision_terms(d, th)))
        return out
    twin(scenario)


def test_engine_variants_policy():
    def scenario(S):
        g = S.data.DATASETS["lubm"](scale=0.03, seed=1)
        q = S.data.random_query(g, size=4, seed=5)
        r_never = S.engine(g, "stwig+").execute(q)
        assert not r_never.stats.used_check
        r_always = S.engine(g, "spath_ni2").execute(q)
        assert r_always.stats.used_check
        assert r_never.result_set() == r_always.result_set()
        return r_never.result_set(), r_always.stats.candidates_after
    twin(scenario)


def test_bloom_prefilter_engine_equality():
    def scenario(S):
        out = []
        for seed in range(3):
            g = S.data.random_graph(n_nodes=50, n_edges=150, n_preds=3,
                                    n_literals=15, seed=seed)
            q = S.data.random_query(g, size=4, seed=seed * 5 + 2,
                                    exact_nodes=0.5)
            want = {tuple(t[c] for c in sorted(range(q.num_nodes)))
                    for t in S.core.brute_force_match(g, q)}
            eng = S.engine(g, "spath_ni2")
            eng.cfg.use_bloom = True
            res = eng.execute(q)
            assert res.result_set() == want
            out.append((res.result_set(), res.stats.candidates_after))
        return out
    twin(scenario)


def _hub_graph(S, n_hub_edges=400, n_chain=400, n_mid=100, mid_deg=10):
    triples = [("hub/0", "pH", f"leaf/{i:04d}") for i in range(n_hub_edges)]
    triples += [(f"chain/{i:04d}", "pC", f"chain/{(i + 1) % n_chain:04d}")
                for i in range(n_chain)]
    triples += [(f"mid/{i:04d}", "pM", f"mid/{(i * mid_deg + k) % n_mid:04d}")
                for i in range(n_mid) for k in range(1, mid_deg + 1)]
    return S.core.RDFGraph.from_triples(triples, literal_objects=set())


def _hub_chain(S):
    g = _hub_graph(S)
    st = S.core.compute_stats(g)
    idmap = S.engine(g, "stwig+").idmap
    hub = np.asarray([idmap.interval("hub/")[0]])
    lo, _ = idmap.interval("chain/")
    return g, st, hub, np.arange(lo, lo + 50), g.num_nodes


def test_endpoint_reach_defaults_to_expected_reach():
    def scenario(S):
        st = _stats(S, "dblp", scale=0.03)
        out = []
        for hops in range(5):
            a = S.core.endpoint_reach(st, 10_000, hops)
            b = S.core.expected_reach(st, 10_000, hops)
            assert np.isclose(a, b)
            out.append((a, b))
        return out
    twin(scenario)


def test_endpoint_reach_separates_hubs_from_leaves():
    def scenario(S):
        g, st, hub, chain, n = _hub_chain(S)
        r_hub = S.core.endpoint_reach(st, n, 1, hub, +1)
        r_chain = S.core.endpoint_reach(st, n, 1, chain, +1)
        r_global = S.core.expected_reach(st, n, 1)
        assert r_hub > 100 * r_chain
        assert r_chain < r_global < r_hub
        return r_hub, r_chain, r_global
    twin(scenario)


def test_connection_selectivity_candidate_aware():
    def scenario(S):
        g, st, hub, chain, n = _hub_chain(S)
        sel_global = S.core.connection_selectivity(st, n, 2)
        sel_hub = S.core.connection_selectivity(st, n, 2, a_nodes=hub,
                                                b_nodes=hub)
        sel_chain = S.core.connection_selectivity(st, n, 2, a_nodes=chain,
                                                  b_nodes=chain)
        assert sel_hub > sel_global > sel_chain
        return sel_global, sel_hub, sel_chain
    twin(scenario)


def test_connection_plan_orders_selective_edge_first_on_hub_graph():
    def scenario(S):
        g, st, hub, chain, n = _hub_chain(S)
        C = S.core
        sels = [C.connection_selectivity(st, n, 2, a_nodes=hub, b_nodes=hub),
                C.connection_selectivity(st, n, 2, a_nodes=chain,
                                         b_nodes=chain)]
        feats = [C.ConnFeatures(50, 50, C.endpoint_reach(st, n, 1, hub, +1),
                                C.endpoint_reach(st, n, 1, hub, -1)),
                 C.ConnFeatures(50, 50, C.endpoint_reach(st, n, 1, chain, +1),
                                C.endpoint_reach(st, n, 1, chain, -1))]
        plan = C.plan_connections([1000, 1000, 1000], [(0, 1), (1, 2)],
                                  sels, feats=feats, num_nodes=n)
        assert plan.order[0] == 1
        sel_g = C.connection_selectivity(st, n, 2)
        assert sels[0] > sel_g > sels[1]
        return dataclasses.asdict(plan), sels, sel_g
    twin(scenario)


def test_tune_thresholds_grid():
    def scenario(S):
        class Q:
            pass

        def cost(q, th):
            return 1.0 if th.tau_sel >= 8 else 2.0
        th = S.core.tune_thresholds(cost, [Q(), Q()], grid_sel=(4.0, 8.0))
        assert th.tau_sel >= 8
        return dataclasses.asdict(th)
    twin(scenario)


# ----------------- the planner's estimators and costs ----------------- #
@pytest.mark.parametrize("scale", [1.0, 0.5, 3.0])
def test_join_estimator_matches_reference(scale):
    """JoinEstimator.edge_join / table_join on the dblp statistics, over
    seeded counts, predicates, directions and shared columns, at a
    calibrated scale (``CostModel.join_est_scale``)."""
    def scenario(S):
        st = _stats(S, "dblp", scale=0.03)
        rng = np.random.default_rng(int(scale * 10))
        sizes = {i: int(x) for i, x in
                 enumerate(rng.integers(1, 5000, 6))}
        est = S.planner.JoinEstimator(st, sizes, scale=scale)
        none = S.planner.JoinEstimator(None, sizes, scale=scale)
        out = []
        for _ in range(40):
            left, pairs = (int(x) for x in rng.integers(0, 10_000, 2))
            pred = (None if rng.random() < 0.2
                    else int(rng.integers(0, len(st.pred_selectivity))))
            outgoing = bool(rng.random() < 0.5)
            shared = tuple(sorted(int(c) for c in
                                  rng.choice(6, int(rng.integers(0, 3)),
                                             replace=False)))
            a, b = (int(x) for x in rng.integers(0, 3000, 2))
            out.append((est.edge_join(left, pred, outgoing, pairs),
                        none.edge_join(left, pred, outgoing, pairs),
                        est.table_join(a, b, shared)))
        return out
    twin(scenario)


def test_replay_estimator_replays_triples_pairs_ints_then_falls_back():
    def scenario(S):
        st = _stats(S, "dblp", scale=0.03)
        base = S.planner.JoinEstimator(st, {0: 10, 1: 20})
        rec = [(5, 8, "sorted"), (7, 16), 9]
        rep = S.planner.ReplayEstimator(base, rec)
        got = [rep.table_join(3, 4, (0,)), rep.edge_join(3, 0, True, 5),
               rep.table_join(3, 4, (1,)), rep.table_join(30, 40, (0,)),
               rep.edge_join(3, 0, False, 5)]
        out = []
        for v in got:
            out.append((int(v), getattr(v, "cap", None),
                        getattr(v, "impl", None), type(v).__name__))
        assert rep.cursor == len(rec)
        return out
    twin(scenario)


def _table_problem(rng, n):
    node_sets = [set(int(c) for c in rng.choice(6, int(rng.integers(1, 4)),
                                                replace=False))
                 for _ in range(n)]
    counts = [int(x) for x in rng.integers(1, 50_000, n)]
    sort_orders = [None if rng.random() < 0.5 else
                   tuple(sorted(s)) for s in node_sets]
    return node_sets, counts, sort_orders


@pytest.mark.parametrize("n", [1, 2, 4, 7, 11])
def test_plan_table_joins_matches_reference(n):
    """Selinger DP (n <= 10) and its greedy fallback (n = 11): the same
    order, steps, costs and greedy baseline, with and without sorted
    inputs, under two nested-join limits."""
    def scenario(S):
        st = _stats(S, "dblp", scale=0.03)
        rng = np.random.default_rng(n)
        out = []
        for trial in range(3):
            node_sets, counts, orders = _table_problem(rng, n)
            sizes = {i: int(x) for i, x in enumerate(rng.integers(1, 900, 6))}
            est = S.planner.JoinEstimator(st, sizes,
                                          scale=1.0 + 0.5 * trial)
            for nested_max in (1, 256):
                plan = S.planner.plan_table_joins(
                    node_sets, counts, est, nested_max,
                    sort_orders=orders if trial else None,
                    greedy_order=list(np.argsort(counts).tolist()))
                assert sorted(plan.order) == list(range(n))
                out.append(dataclasses.asdict(plan))
        return out
    twin(scenario)


def test_cost_model_scales_estimates_not_results():
    """Every CostModel factor moves the planner's estimates the same way
    on both stacks, and no factor changes a result."""
    def scenario(S):
        g = S.data.DATASETS["dblp"](scale=0.03, seed=1)
        q = S.data.random_query(g, size=5, seed=101, n_connection=1, d_c=3)
        out = []
        for cm in (S.core.CostModel(),
                   S.core.CostModel(join_est_scale=4.0, conn_sel_scale=0.25),
                   S.core.CostModel(reach_scale=8.0, cross_scale=0.125)):
            eng = S.engine(g, "rdf_h")
            eng.cfg.cost_model = cm
            r = eng.execute(q)
            out.append((dataclasses.asdict(cm), r.result_set(),
                        r.stats.plan_cost, r.stats.join_strategies,
                        r.stats.conn_strategies, r.stats.join_est_rows))
        assert all(o[1] == out[0][1] for o in out)
        return out
    twin(scenario)
