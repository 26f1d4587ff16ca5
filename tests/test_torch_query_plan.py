"""Twins of tests/test_query_plan.py: the port's whole-query join plan
against the reference, one twin per reference case.

Each twin builds the reference test's tables, plans, graphs and queries
on both stacks from the same numpy seeds (`torch_twin.twin`; `impl="ref"`,
the port on the CPU), asserts the reference test's own claims on each
side, and holds the two sides equal, exactly: every table's columns,
count, truncation, `sort_order` tag and rows in order; `is_sorted_by`;
`sorts_performed` and `sorts_avoided`; `CapacityOverflow.needed`; the
plans (order, estimated and greedy costs, steps) and the engine's
recorded plan costs and statistics, and the result sets.
"""
import numpy as np

from torch_twin import freeze, run_stats, table_view, twin


def rows_multiset(t):
    return sorted(tuple(int(x) for x in r) for r in t.numpy())


def tel_view(tel):
    return tel.sorts_performed, tel.sorts_avoided


# --------------------- sort-order propagation ------------------------- #
def test_sorted_join_tags_output_order():
    """Twin of test_query_plan.py::test_sorted_join_tags_output_order."""
    def scenario(S):
        rng = np.random.default_rng(0)
        a = S.table((0, 1), rng.integers(0, 40, (400, 2)))
        b = S.table((1, 2), rng.integers(0, 40, (300, 2)))
        t = S.matching.join_tables(a, b, impl="sorted")
        assert t.sort_order == (1,)
        vals = t.numpy()[:, t.cols.index(1)]
        assert (np.diff(vals) >= 0).all()
        return table_view(t)
    twin(scenario)


def test_is_sorted_by_prefix_semantics():
    """Twin of test_query_plan.py::test_is_sorted_by_prefix_semantics,
    over every key of up to three of the table's columns and one more."""
    def scenario(S):
        t = S.table((3, 5), np.zeros((4, 2)))
        t.sort_order = (5, 3)
        assert t.is_sorted_by((5,))
        assert t.is_sorted_by((5, 3))
        assert not t.is_sorted_by((3,))
        assert not t.is_sorted_by((5, 3, 7))
        keys = [(), (3,), (5,), (7,), (3, 5), (5, 3), (5, 7), (5, 3, 7),
                (3, 5, 7)]
        got = [t.is_sorted_by(k) for k in keys]
        t.sort_order = None
        got += [t.is_sorted_by(k) for k in keys]
        return got
    twin(scenario)


def test_filter_and_cross_preserve_order():
    """Twin of test_query_plan.py::test_filter_and_cross_preserve_order."""
    def scenario(S):
        rng = np.random.default_rng(1)
        a = S.table((0, 1), rng.integers(0, 30, (300, 2)))
        b = S.table((1, 2), rng.integers(0, 30, (300, 2)))
        t = S.matching.join_tables(a, b, impl="sorted")
        keep = np.zeros(t.cap, bool)
        keep[: t.count] = rng.random(t.count) < 0.5
        f = S.matching.filter_rows(t, keep)
        assert f.sort_order == t.sort_order
        vals = f.numpy()[:, f.cols.index(1)]
        assert (np.diff(vals) >= 0).all()
        c = S.table((7,), rng.integers(0, 5, (3, 1)))
        x = S.matching.cross_join(f, c)
        assert x.sort_order == f.sort_order
        return table_view(t), table_view(f), table_view(x)
    twin(scenario)


def test_single_node_table_is_sorted():
    """Twin of test_query_plan.py::test_single_node_table_is_sorted, with
    and without a pass mask."""
    def scenario(S):
        dev = {"device": "cpu"} if S.port else {}
        t = S.matching.single_node_table(4, 10, 30, None, **dev)
        assert t.sort_order == (4,)
        passed = np.arange(40) % 3 == 0
        m = S.matching.single_node_table(4, 10, 30, passed, **dev)
        assert m.sort_order == (4,)
        return table_view(t), table_view(m)
    twin(scenario)


def test_chained_joins_avoid_resort():
    """Twin of test_query_plan.py::test_chained_joins_avoid_resort."""
    def scenario(S):
        rng = np.random.default_rng(2)
        a = S.table((0, 1), rng.integers(0, 50, (500, 2)))
        b = S.table((1, 2), rng.integers(0, 50, (400, 2)))
        c = S.table((1, 3), rng.integers(0, 50, (300, 2)))
        tel = S.core.JoinTelemetry()
        t1 = S.matching.join_tables(a, b, impl="sorted", telemetry=tel)
        assert tel == S.core.JoinTelemetry(sorts_performed=2,
                                           sorts_avoided=0)
        t2 = S.matching.join_tables(t1, c, impl="sorted", telemetry=tel)
        assert tel.sorts_avoided == 1
        seen = [tel_view(tel)]
        before = tel.sorts_performed
        t3 = S.matching.join_tables(a, b, impl="sorted", telemetry=tel)
        t4 = S.matching.join_tables(t1, c, impl="sorted", telemetry=tel)
        assert tel.sorts_performed == before
        assert tel.sorts_avoided == 5
        fresh = S.matching.join_tables(S.table((0, 1), a.numpy()),
                                       S.table((1, 2), b.numpy()),
                                       impl="sorted")
        assert rows_multiset(fresh) == rows_multiset(t1)
        return seen + [tel_view(tel)] + [table_view(t) for t in
                                         (t1, t2, t3, t4, fresh)]
    twin(scenario)


def test_multi_col_key_order_permutes_to_reuse_run():
    """Twin of
    test_query_plan.py::test_multi_col_key_order_permutes_to_reuse_run."""
    def scenario(S):
        rng = np.random.default_rng(3)
        a = S.table((0, 1), rng.integers(0, 6, (400, 2)))
        d = S.table((1, 0), rng.integers(0, 6, (300, 2)))
        tel = S.core.JoinTelemetry()
        x1 = S.matching.join_tables(a, d, impl="sorted", telemetry=tel)
        assert tel.sorts_performed == 2
        x2 = S.matching.join_tables(a, d, impl="sorted", telemetry=tel)
        assert tel.sorts_performed == 2 and tel.sorts_avoided == 2
        assert rows_multiset(x1) == rows_multiset(x2)
        return tel_view(tel), table_view(x1), table_view(x2)
    twin(scenario)


def test_overflow_resume_skips_rework():
    """Twin of test_query_plan.py::test_overflow_resume_skips_rework."""
    def scenario(S):
        a = S.table((0,), np.zeros((400, 1)))
        b = S.table((0, 1), np.column_stack([np.zeros(400), np.arange(400)]))
        tel = S.core.JoinTelemetry()
        out = S.matching.planned_join(a, b, est=10, impl="sorted",
                                      telemetry=tel)
        assert out.count == 160_000
        assert tel.sorts_performed == 2
        err = None
        try:
            S.matching.join_tables(
                S.table((0,), np.zeros((300, 1))),
                S.table((0, 1), np.column_stack([np.zeros(300),
                                                 np.arange(300)])),
                impl="sorted", cap=64)
        except S.core.CapacityOverflow as e:
            err = e
        assert err is not None and err.resume is not None
        assert err.needed == 90_000
        return tel_view(tel), table_view(out), err.needed
    twin(scenario)


def test_cross_expand_xla_remainder_regression():
    """Twin of test_query_plan.py::test_cross_expand_xla_remainder_regression
    (the reference's XLA miscompile: the same shapes and pairing)."""
    def scenario(S):
        a = S.table((0, 1), np.column_stack([np.arange(10),
                                             100 + np.arange(10)]))
        b_dat = np.column_stack([200 + np.arange(200), 400 + np.arange(200),
                                 600 + np.arange(200), 800 + np.arange(200)])
        b = S.table((2, 3, 4, 5), b_dat)
        out = S.matching.cross_join(a, b)
        assert out.count == 2000
        arr = out.numpy()
        assert len({tuple(r) for r in arr}) == 2000
        np.testing.assert_array_equal(arr[1], [0, 100, 201, 401, 601, 801])
        np.testing.assert_array_equal(arr[201], [1, 101, 201, 401, 601, 801])
        return table_view(out)
    twin(scenario)


def test_cross_expand_oracle_shape_grid():
    """Twin of test_query_plan.py::test_cross_expand_oracle_shape_grid."""
    def scenario(S):
        out = []
        for na, nb in [(1, 1), (3, 7), (10, 200), (200, 10), (16, 16),
                       (13, 257), (100, 100), (1, 300), (300, 1)]:
            a = S.table((0, 1), np.column_stack(
                [np.arange(na), 1000 + np.arange(na)]))
            b = S.table((2, 3), np.column_stack(
                [2000 + np.arange(nb), 3000 + np.arange(nb)]))
            x = S.matching.cross_join(a, b)
            assert x.count == na * nb, (na, nb)
            want = np.array([[i, 1000 + i, 2000 + j, 3000 + j]
                             for i in range(na) for j in range(nb)], np.int32)
            np.testing.assert_array_equal(x.numpy(), want,
                                          err_msg=f"{(na, nb)}")
            out.append(table_view(x))
        return out
    twin(scenario)


# ----------------------- canonical result sets ------------------------ #
def test_result_set_canonical_across_join_orders():
    """Twin of
    test_query_plan.py::test_result_set_canonical_across_join_orders."""
    def scenario(S):
        rng = np.random.default_rng(4)
        a = S.table((0, 1), rng.integers(0, 10, (60, 2)))
        b = S.table((1, 2), rng.integers(0, 10, (50, 2)))
        ab = S.matching.join_tables(a, b)
        ba = S.matching.join_tables(b, a)
        assert ab.cols != ba.cols
        assert ab.result_set() == ba.result_set()
        return table_view(ab), table_view(ba), ab.result_set()
    twin(scenario)


# ------------------------- cost-based plans --------------------------- #
def test_plan_table_joins_is_permutation_and_never_worse():
    """Twin of
    test_query_plan.py::test_plan_table_joins_is_permutation_and_never_worse:
    the same plans, and the same costs of the sampled orders."""
    def scenario(S):
        P = S.planner
        rng = np.random.default_rng(5)
        out = []
        for trial in range(6):
            n = int(rng.integers(2, 6))
            node_sets = []
            for i in range(n):
                node_sets.append({i, i + 1, int(rng.integers(0, n + 1))})
            counts = [int(rng.integers(1, 10_000)) for _ in range(n)]
            cand = {q: int(rng.integers(1, 500)) for q in range(n + 2)}
            est = S.core.JoinEstimator(None, cand)
            plan = P.plan_table_joins(node_sets, counts, est, nested_max=256)
            assert sorted(plan.order) == list(range(n))
            assert plan.est_cost <= plan.greedy_cost + 1e-6
            out.append(freeze(plan))
            for _ in range(5):
                perm = list(rng.permutation(n))
                c, steps = P.simulate_join_order(perm, node_sets, counts,
                                                 est, 256)
                assert plan.est_cost <= c + 1e-6
                out.append((c, freeze(steps)))
        return out
    twin(scenario)


def test_plan_table_joins_beats_greedy_on_skew():
    """Twin of
    test_query_plan.py::test_plan_table_joins_beats_greedy_on_skew."""
    def scenario(S):
        node_sets = [{0, 1}, {1, 2}, {2, 3}]
        counts = [500, 1000, 1000]
        est = S.core.JoinEstimator(None, {0: 100, 1: 1, 2: 1000, 3: 100})
        plan = S.planner.plan_table_joins(node_sets, counts, est,
                                          nested_max=16,
                                          greedy_order=[0, 1, 2])
        assert plan.est_cost < plan.greedy_cost
        assert plan.order[0] != 0
        assert all(s.est_rows >= 0 for s in plan.steps)
        return freeze(plan)
    twin(scenario)


def test_plan_models_sort_reuse():
    """Twin of test_query_plan.py::test_plan_models_sort_reuse, with
    `_reusable` over every pair of short keys."""
    def scenario(S):
        P = S.planner
        node_sets = [{0, 1}, {1, 2}]
        counts = [5000, 5000]
        est = S.core.JoinEstimator(None, {0: 10, 1: 10, 2: 10})
        c_sorted, st_sorted = P.simulate_join_order(
            [0, 1], node_sets, counts, est, 256, sort_orders=[(1,), (1,)])
        c_unsorted, st_unsorted = P.simulate_join_order(
            [0, 1], node_sets, counts, est, 256, sort_orders=[None, None])
        assert c_sorted < c_unsorted
        assert P._reusable((1, 0), (0, 1)) and not P._reusable((0,), (0, 1))
        keys = [None, (), (0,), (1,), (0, 1), (1, 0), (0, 1, 2), (2, 1, 0)]
        reuse = [P._reusable(k, s) for k in keys
                 for s in [(0,), (1,), (0, 1), (1, 0), (0, 2)]]
        return c_sorted, c_unsorted, freeze((st_sorted, st_unsorted)), reuse
    twin(scenario)


def test_plan_connections_orders_by_selectivity():
    """Twin of
    test_query_plan.py::test_plan_connections_orders_by_selectivity."""
    def scenario(S):
        plan = S.planner.plan_connections([10, 1000, 1000], [(0, 1), (1, 2)],
                                          [0.9, 1e-4])
        assert sorted(plan.order) == [0, 1]
        assert plan.order == [1, 0]
        assert plan.est_cost < plan.greedy_cost
        return freeze(plan)
    twin(scenario)


def test_plan_connections_single_edge_trivial():
    """Twin of
    test_query_plan.py::test_plan_connections_single_edge_trivial."""
    def scenario(S):
        plan = S.planner.plan_connections([5, 7], [(0, 1)], [0.5])
        assert plan.order == [0]
        assert plan.est_cost == plan.greedy_cost
        return freeze(plan)
    twin(scenario)


# ----------------------- engine integration --------------------------- #
def test_engine_sorts_avoided_on_multi_join_template():
    """Twin of
    test_query_plan.py::test_engine_sorts_avoided_on_multi_join_template."""
    def scenario(S):
        g = S.data.DATASETS["lubm"](scale=0.03, seed=1)
        eng = S.engine(g, "stwig+")
        eng.cfg.join_impl = "sorted"
        r = eng.execute(S.query(g, size=6, seed=31))
        assert r.stats.sorts_performed > 0
        assert r.stats.sorts_avoided > 0
        assert r.stats.plan_mode == "cost"
        return r.result_set(), run_stats(r)
    twin(scenario)


def test_engine_plan_modes_identical_results():
    """Twin of test_query_plan.py::test_engine_plan_modes_identical_results."""
    def scenario(S):
        g = S.data.DATASETS["lubm"](scale=0.03, seed=1)
        q = S.query(g, size=6, seed=7)
        rs = {}
        for pm in ("cost", "greedy"):
            eng = S.engine(g, "stwig+")
            eng.cfg.plan_mode = pm
            r = eng.execute(q)
            assert r.stats.plan_mode == pm
            rs[pm] = (r.result_set(), run_stats(r))
        assert rs["cost"][0] == rs["greedy"][0]
        return rs
    twin(scenario)


def test_engine_plan_modes_identical_with_connections():
    """Twin of
    test_query_plan.py::test_engine_plan_modes_identical_with_connections."""
    def scenario(S):
        out = []
        for seed in range(3):
            g = S.graph(n_nodes=70, n_edges=220, n_preds=3, n_literals=18,
                        seed=seed)
            q = S.query(g, size=5, seed=seed + 1, n_connection=2, d_c=3)
            rs = []
            for pm in ("cost", "greedy"):
                eng = S.engine(g, "h2")
                eng.cfg.plan_mode = pm
                r = eng.execute(q)
                rs.append(r.result_set())
                out.append(run_stats(r))
            assert rs[0] == rs[1], seed
            out.append(rs[0])
        return out
    twin(scenario)


def test_engine_records_plan_costs():
    """Twin of test_query_plan.py::test_engine_records_plan_costs: the
    same plan and greedy costs, and the same statistics."""
    def scenario(S):
        g = S.data.DATASETS["lubm"](scale=0.03, seed=1)
        eng = S.engine(g, "stwig+")
        r = eng.execute(S.query(g, size=6, seed=7))
        qs = r.stats
        assert qs.plan_cost >= 0.0
        assert qs.greedy_plan_cost >= qs.plan_cost - 1e-6
        return qs.plan_cost, qs.greedy_plan_cost, run_stats(r)
    twin(scenario)
