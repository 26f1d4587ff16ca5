"""Twins of tests/test_join_engine.py: the port's sort-merge join
subsystem against the reference, one twin per reference case.

Each twin builds the reference test's tables, graphs and queries on both
stacks from the same numpy seeds (`torch_twin.twin`; `impl="ref"`, the
port on the CPU), asserts the reference test's own claims on each side
(the brute-force oracle, LIMIT semantics, the exact need carried by
`CapacityOverflow`), and holds the two sides equal, exactly: each output
table's columns, count, truncation, order tag and rows in order;
`CapacityOverflow.needed`; `resolve_join_impl` at and around every
threshold; the strategies, estimates and other statistics the engine
records, and the result sets.
"""
import numpy as np
import pytest

from torch_twin import run_stats, table_view, twin


def oracle_join(a, b):
    """Brute-force equi-join on shared cols -> sorted multiset of rows."""
    shared = [c for c in a.cols if c in b.cols]
    new = [j for j, c in enumerate(b.cols) if c not in a.cols]
    out = []
    for ra in a.numpy():
        for rb in b.numpy():
            if all(ra[a.cols.index(c)] == rb[b.cols.index(c)]
                   for c in shared):
                out.append(tuple(int(x) for x in ra)
                           + tuple(int(rb[j]) for j in new))
    return sorted(out)


def rows_multiset(t):
    return sorted(tuple(int(x) for x in r) for r in t.numpy())


# ------------------------- randomized parity -------------------------- #
@pytest.mark.parametrize("seed", range(8))
def test_join_random_parity(seed):
    """Twin of test_join_engine.py::test_join_random_parity."""
    def scenario(S):
        rng = np.random.default_rng(seed)
        na, nb = rng.integers(0, 60, 2)
        ncols = rng.integers(1, 4)
        a_cols = tuple(rng.choice(6, ncols, replace=False))
        b_cols = tuple(rng.choice(6, rng.integers(1, 4), replace=False))
        a = S.table(a_cols, rng.integers(0, 5, (na, len(a_cols))))
        b = S.table(b_cols, rng.integers(0, 5, (nb, len(b_cols))))
        want = oracle_join(a, b)
        out = []
        for impl in ("nested", "sorted", "auto"):
            t = S.matching.join_tables(a, b, impl=impl)
            assert rows_multiset(t) == want, impl
            out.append(table_view(t))
        return out
    twin(scenario)


def test_join_many_shared_cols_rank_packing():
    """Twin of test_join_engine.py::test_join_many_shared_cols_rank_packing:
    four shared columns in opposite orders (the dense-rank packing)."""
    def scenario(S):
        rng = np.random.default_rng(3)
        a = S.table((0, 1, 2, 3), rng.integers(0, 3, (80, 4)))
        b = S.table((3, 2, 1, 0), rng.integers(0, 3, (70, 4)))
        t = S.matching.join_tables(a, b, impl="sorted")
        assert rows_multiset(t) == oracle_join(a, b)
        return table_view(t)
    twin(scenario)


def test_join_self_loop_single_col():
    """Twin of test_join_engine.py::test_join_self_loop_single_col."""
    def scenario(S):
        a = S.table((0,), [[1], [2], [2], [5]])
        b = S.table((0, 1), [[2, 9], [2, 8], [5, 7], [6, 1]])
        want = oracle_join(a, b)
        out = []
        for impl in ("nested", "sorted"):
            t = S.matching.join_tables(a, b, impl=impl)
            assert rows_multiset(t) == want
            out.append(table_view(t))
        return out
    twin(scenario)


def test_join_empty_sides():
    """Twin of test_join_engine.py::test_join_empty_sides."""
    def scenario(S):
        empty = S.table((1, 2), np.zeros((0, 2)))
        full = S.table((0, 1), [[1, 2], [3, 4]])
        out = []
        for impl in ("nested", "sorted"):
            for a, b in ((full, empty), (empty, full)):
                t = S.matching.join_tables(a, b, impl=impl)
                assert t.count == 0
                out.append(table_view(t))
        return out
    twin(scenario)


def test_no_shared_cols_is_cross_join():
    """Twin of test_join_engine.py::test_no_shared_cols_is_cross_join."""
    def scenario(S):
        a = S.table((0,), [[1], [2]])
        b = S.table((1,), [[7], [8], [9]])
        t = S.matching.join_tables(a, b)
        assert t.cols == (0, 1)
        assert rows_multiset(t) == sorted(
            (int(x), int(y)) for x in [1, 2] for y in [7, 8, 9])
        x = S.matching.cross_join(a, b)
        assert rows_multiset(x) == rows_multiset(t)
        return table_view(t), table_view(x)
    twin(scenario)


# -------------------------- LIMIT semantics --------------------------- #
@pytest.mark.parametrize("impl", ["nested", "sorted"])
def test_row_limit_clamps_exactly(impl):
    """Twin of test_join_engine.py::test_row_limit_clamps_exactly: the
    same 100 rows kept, in the same order, on both sides."""
    def scenario(S):
        a = S.table((0,), np.zeros((50, 1)))
        b = S.table((0, 1), np.column_stack([np.zeros(50), np.arange(50)]))
        t = S.matching.join_tables(a, b, impl=impl, row_limit=100, chunk=8)
        assert t.count == 100
        assert t.truncated
        u = S.matching.join_tables(a, b, impl=impl, row_limit=5000, chunk=8)
        assert u.count == 2500
        assert not u.truncated
        return table_view(t), table_view(u)
    twin(scenario)


def test_row_limit_exact_boundary_not_truncated_sorted():
    """Twin of
    test_join_engine.py::test_row_limit_exact_boundary_not_truncated_sorted,
    and one row either side of the boundary."""
    def scenario(S):
        a = S.table((0,), np.zeros((10, 1)))
        b = S.table((0, 1), np.column_stack([np.zeros(10), np.arange(10)]))
        t = S.matching.join_tables(a, b, impl="sorted", row_limit=100)
        assert t.count == 100 and not t.truncated
        near = [S.matching.join_tables(a, b, impl="sorted", row_limit=n)
                for n in (99, 101)]
        assert [(x.count, x.truncated) for x in near] == \
            [(99, True), (100, False)]
        return [table_view(x) for x in [t] + near]
    twin(scenario)


# ------------------------- capacity overflow -------------------------- #
@pytest.mark.parametrize("impl", ["nested", "sorted"])
def test_capacity_overflow_carries_exact_need(impl):
    """Twin of test_join_engine.py::test_capacity_overflow_carries_exact_need:
    the same exception type and need, and the same retried table."""
    def scenario(S):
        a = S.table((0,), np.zeros((40, 1)))
        b = S.table((0, 1), np.column_stack([np.zeros(40), np.arange(40)]))
        with pytest.raises(S.core.CapacityOverflow) as ei:
            S.matching.join_tables(a, b, impl=impl, cap=64)
        assert ei.value.needed == 1600
        t = S.matching.join_tables(a, b, impl=impl,
                                   cap=S.matching._pow2(ei.value.needed))
        assert t.count == 1600
        return type(ei.value).__name__, ei.value.needed, table_view(t)
    twin(scenario)


# ------------------------- planner selection -------------------------- #
def test_resolve_join_impl_thresholds():
    """Twin of test_join_engine.py::test_resolve_join_impl_thresholds: the
    reference test's cases on each side, then a grid at and around each
    threshold (the nested-loop bound, the radix probe minimum, the
    radix-against-sort cost crossover, forced strategies, sorted runs and
    multi-column keys) equal across the sides."""
    def scenario(S):
        r = S.core.resolve_join_impl
        assert r(10, 256) == "nested"
        assert r(10, 257) == "sorted"
        assert r(5000, 3, "auto", nested_max=64) == "sorted"
        assert r(5000, 3, "nested") == "nested"
        assert r(1 << 16, 1 << 12) == "radix"
        assert r(1 << 16, 1 << 12, n_shared=2) == "sorted"
        assert r(100, 1 << 12) == "sorted"
        assert r(10, 10, "radix") == "radix"
        nmax = S.matching.DEFAULT_NESTED_MAX
        rmin = S.matching.RADIX_MIN_PROBE
        sizes = sorted({1, 3, 10, 63, 64, 65, nmax - 1, nmax, nmax + 1,
                        rmin - 1, rmin, rmin + 1, 1 << 12, 1 << 14,
                        (1 << 14) + 1, 1 << 16, (1 << 16) + 1, 1 << 20})
        # the b at which radix stops beating a sort of both sides, for
        # each probe size a (first b where it does not)
        crossover = {}
        for a in (rmin, 1 << 14, 1 << 16, 1 << 20):
            b = nmax
            while b < 1 << 24 and r(a, b) == "radix":
                b += max(1, b // 64)
            crossover[a] = b
            sizes.extend([b - 1, b, b + 1])
        grid = []
        for a in sizes:
            for b in sizes:
                for kw in ({}, {"nested_max": 64}, {"n_shared": 2},
                           {"a_sorted": True}, {"b_sorted": True},
                           {"a_sorted": True, "b_sorted": True}):
                    grid.append(r(a, b, **kw))
                for impl in ("nested", "sorted", "radix"):
                    grid.append(r(a, b, impl))
        return crossover, grid
    twin(scenario)


def test_engine_records_join_strategies_and_estimates():
    """Twin of
    test_join_engine.py::test_engine_records_join_strategies_and_estimates:
    the same strategies, estimates and other statistics."""
    def scenario(S):
        g = S.data.DATASETS["lubm"](scale=0.03, seed=1)
        eng = S.engine(g, "stwig+")
        r = eng.execute(S.query(g, size=5, seed=31))
        qs = r.stats
        assert sum(qs.join_strategies.values()) > 0
        assert qs.n_estimated_joins > 0
        assert qs.join_actual_rows >= 0 and qs.join_est_rows > 0
        return r.result_set(), run_stats(r)
    twin(scenario)


# --------------------- engine-level equivalence ----------------------- #
@pytest.mark.parametrize("variant", ["stwig+", "spath_ni2", "h2", "h3",
                                     "hvc", "rdf_h"])
def test_engine_variants_sorted_equals_nested(variant):
    """Twin of
    test_join_engine.py::test_engine_variants_sorted_equals_nested."""
    def scenario(S):
        g = S.data.DATASETS["lubm"](scale=0.025, seed=2)
        results = {}
        for ji in ("nested", "sorted", "radix"):
            eng = S.engine(g, variant)
            eng.cfg.join_impl = ji
            r = eng.execute(S.query(g, size=5, seed=77))
            results[ji] = (r.result_set(), run_stats(r))
        assert results["nested"][0] == results["sorted"][0] \
            == results["radix"][0]
        return results
    twin(scenario)


def test_engine_random_graphs_join_impl_equivalence():
    """Twin of
    test_join_engine.py::test_engine_random_graphs_join_impl_equivalence."""
    def scenario(S):
        out = []
        for seed in range(3):
            g = S.graph(n_nodes=60, n_edges=200, n_preds=3, n_literals=15,
                        seed=seed)
            q = S.query(g, size=4, seed=seed * 3 + 1)
            rs = []
            for ji in ("nested", "sorted", "radix", "auto"):
                eng = S.engine(g)
                eng.cfg.join_impl = ji
                r = eng.execute(q)
                rs.append(r.result_set())
                out.append(run_stats(r))
            assert rs[0] == rs[1] == rs[2] == rs[3]
            out.append(rs[0])
        return out
    twin(scenario)
