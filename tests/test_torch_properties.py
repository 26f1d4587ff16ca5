"""Property twins (hypothesis): the four property suites of the reference
— ``test_core_properties.py``, ``test_query_plan_properties.py``,
``test_reach_join_properties.py`` and ``test_fused_join_properties.py`` —
run on both stacks from the same drawn inputs.

The strategies draw what the reference's strategies draw (the same seeds,
sizes and ranges); each example then builds its graph, tables and queries
on each stack from those numbers, asserts the reference property on each
side and holds the two sides' observations equal, exactly (result sets,
rows in order, NI entries, order tags).  ``max_examples`` is the
reference's in every test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from torch_twin import twin  # noqa: E402


def mk_table(S, cols, data):
    data = np.asarray(data, np.int32).reshape(-1, len(cols))
    cap = S.matching._pow2(len(data))
    rows = np.full((cap, len(cols)), -1, np.int32)
    rows[: len(data)] = data
    rows = torch.as_tensor(rows) if S.port else jnp.asarray(rows)
    return S.matching.Table(cols=tuple(int(c) for c in cols), rows=rows,
                            count=len(data))


def view(t) -> tuple:
    return (t.cols, t.count, t.sort_order, np.asarray(t.rows).tolist())


def rows_multiset(t):
    return sorted(tuple(int(x) for x in r) for r in t.numpy())


def brute(S, g, q) -> set:
    return {tuple(t[c] for c in sorted(range(q.num_nodes)))
            for t in S.core.brute_force_match(g, q)}


# ------------------------ test_core_properties ------------------------ #
@st.composite
def small_graph(draw):
    """The parameters of the reference's ``small_graph``."""
    seed = draw(st.integers(0, 10_000))
    n = draw(st.integers(10, 60))
    e = draw(st.integers(n, 4 * n))
    return dict(n_nodes=n, n_edges=e, n_preds=3, n_literals=max(3, n // 5),
                seed=seed)


@settings(max_examples=15, deadline=None)
@given(small_graph(), st.text(alphabet="Rl/it 0123456789", max_size=4))
def test_idmap_prefix_interval(gkw, prefix):
    def scenario(S):
        g = S.graph(**gkw)
        lo, hi = S.core.IDMap(g).interval(prefix)
        labels = g.labels
        assert all(str(s).startswith(prefix) for s in labels[lo:hi])
        outside = np.concatenate([labels[:lo], labels[hi:]])
        assert not any(str(s).startswith(prefix) for s in outside)
        return int(lo), int(hi)
    twin(scenario)


@settings(max_examples=10, deadline=None)
@given(small_graph(), st.integers(1, 3))
def test_ni_index_exact_khop(gkw, d_max):
    def scenario(S):
        g = S.graph(**gkw)
        ni = S.core.build_ni_index(g, d_max=d_max)
        indptr, nbr, _ = g.out_csr
        rng = np.random.default_rng(0)
        for n in rng.integers(0, g.num_nodes, size=min(10, g.num_nodes)):
            dist = {int(n): 0}
            frontier = [int(n)]
            self_loop = int(n) in set(
                int(v) for v in nbr[indptr[n]:indptr[n + 1]])
            for d in range(1, d_max + 1):
                nxt = []
                for u in frontier:
                    for v in nbr[indptr[u]:indptr[u + 1]]:
                        v = int(v)
                        if v not in dist:
                            dist[v] = d
                            nxt.append(v)
                frontier = nxt
                want = sorted(v for v, dd in dist.items() if dd == d)
                if d == 1 and self_loop:
                    want = sorted(set(want) | {int(n)})
                e = ni.entries[d]
                if e.overflow[n]:
                    continue
                assert sorted(int(x) for x in e.ids[n] if x >= 0) == want
        return {k: (e.cap, e.ids.tolist(), e.overflow.tolist(),
                    np.asarray(e.count).tolist())
                for k, e in sorted(ni.entries.items())}
    twin(scenario)


@settings(max_examples=10, deadline=None)
@given(small_graph())
def test_vertex_cover_covers_all_edges(gkw):
    def scenario(S):
        g = S.graph(**gkw)
        vc = S.core.vertex_cover_2approx(g)
        assert all(vc[s] or vc[d] for s, d in zip(g.src, g.dst))
        return np.asarray(vc).tolist()
    twin(scenario)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 500), st.integers(3, 5))
def test_pruning_soundness_and_equivalence(seed, size):
    def scenario(S):
        g = S.graph(n_nodes=50, n_edges=150, n_preds=3, n_literals=15,
                    seed=seed)
        q = S.query(g, size=size, seed=seed * 7 + 1)
        want = brute(S, g, q)
        for variant in ("stwig+", "spath_ni2", "h2", "h3", "hvc"):
            assert S.engine(g, variant).execute(q).result_set() == want, \
                variant
        return want
    twin(scenario)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 300))
def test_connection_edge_equivalence(seed):
    def scenario(S):
        g = S.graph(n_nodes=40, n_edges=130, n_preds=2, n_literals=10,
                    seed=seed)
        q = S.query(g, size=4, seed=seed + 11, n_connection=1, d_c=3)
        if not q.connections:
            return None
        want = brute(S, g, q)
        for variant in ("stwig+", "h3"):
            assert S.engine(g, variant).execute(q).result_set() == want, \
                variant
        return want
    twin(scenario)


# --------------------- test_query_plan_properties --------------------- #
@st.composite
def join_problem(draw):
    """The draws of the reference's ``join_problem``: a seed, a table
    count and each table's column orientation."""
    seed = draw(st.integers(0, 10_000))
    n = draw(st.integers(3, 4))
    flips = [draw(st.booleans()) for _ in range(n)]
    return seed, flips


def _tables(S, seed, flips):
    rng = np.random.default_rng(seed)
    tables = []
    for i, flip in enumerate(flips):
        cols = (i, i + 1) if flip else (i + 1, i)
        rows = int(rng.integers(0, 40))
        tables.append(mk_table(S, cols, rng.integers(0, 6, (rows, 2))))
    return tables


@settings(max_examples=12, deadline=None)
@given(join_problem())
def test_any_join_order_same_result_set(problem):
    seed, flips = problem

    def scenario(S):
        tables = _tables(S, seed, flips)
        rng = np.random.default_rng(seed + 1)
        want, seen = None, []
        for trial in range(3):
            perm = rng.permutation(len(tables))
            acc = tables[perm[0]]
            for i in perm[1:]:
                acc = S.matching.join_tables(
                    acc, tables[i], impl="sorted" if trial % 2 else "auto")
            got = acc.result_set()
            if want is None:
                want = got
            assert got == want, f"order {perm} diverged"
            seen.append(view(acc))
        return seen
    twin(scenario)


@st.composite
def graph_and_query(draw):
    """The draws of the reference's ``graph_and_query``."""
    seed = draw(st.integers(0, 5_000))
    n = draw(st.integers(20, 60))
    e = draw(st.integers(n, 3 * n))
    size = draw(st.integers(3, 5))
    n_conn = draw(st.integers(0, 1))
    return (dict(n_nodes=n, n_edges=e, n_preds=3, n_literals=max(3, n // 5),
                 seed=seed),
            dict(size=size, seed=seed + 1, n_connection=n_conn, d_c=3))


@settings(max_examples=8, deadline=None)
@given(graph_and_query())
def test_engine_plan_order_invariance(gq):
    gkw, qkw = gq

    def scenario(S):
        g = S.graph(**gkw)
        q = S.query(g, **qkw)
        want, seen = None, []
        for pm in ("cost", "greedy"):
            for ji in ("sorted", "nested", "radix"):
                eng = S.engine(g, "rdf_h")
                eng.cfg.plan_mode = pm
                eng.cfg.join_impl = ji
                r = eng.execute(q)
                got = r.result_set()
                if want is None:
                    want = got
                assert got == want, (pm, ji)
                seen.append((r.stats.join_strategies,
                             r.stats.conn_strategies))
        return want, seen
    twin(scenario)


# -------------------- test_reach_join_properties ---------------------- #
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), d_max=st.integers(1, 3),
       d_c=st.integers(1, 5), bidir=st.booleans(),
       rows_a=st.integers(0, 70), rows_b=st.integers(1, 70))
def test_reach_join_parity_randomized(seed, d_max, d_c, bidir, rows_a,
                                      rows_b):
    def scenario(S):
        C = S.core
        rng = np.random.default_rng(seed)
        g = S.graph(n_nodes=int(rng.integers(30, 90)),
                    n_edges=int(rng.integers(80, 300)), n_preds=2, seed=seed)
        ni = C.build_ni_index(g, d_max=d_max)
        pool = rng.integers(0, g.num_nodes, max(g.num_nodes // 4, 2))
        ta = (mk_table(S, (0,), rng.choice(pool, rows_a)) if rows_a else
              C.empty_table((0,), **({"device": "cpu"} if S.port else {})))
        tb = mk_table(S, (1,), rng.choice(pool, rows_b))
        out = C.reach_join(g, ni, ta, tb, 0, 1, d_c, bidir,
                           cache=C.ReachCache())
        x = C.cross_join(ta, tb)
        rows = np.asarray(x.rows[: x.count])
        keep = C.connectivity_mask(g, ni, rows[:, 0], rows[:, 1], d_c, bidir)
        assert out.result_set() == C.filter_rows(x, keep).result_set()
        return view(out), keep.tolist()
    twin(scenario)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), d_max=st.integers(1, 2),
       d_c=st.integers(1, 4), bidir=st.booleans())
def test_reach_filter_parity_randomized(seed, d_max, d_c, bidir):
    def scenario(S):
        C = S.core
        rng = np.random.default_rng(seed)
        g = S.graph(n_nodes=int(rng.integers(30, 80)),
                    n_edges=int(rng.integers(80, 240)), n_preds=2,
                    seed=seed + 1)
        ni = C.build_ni_index(g, d_max=d_max)
        a = rng.integers(0, g.num_nodes, 40)
        b = rng.integers(0, g.num_nodes, 40)
        t = mk_table(S, (0, 1), np.stack([a, b], axis=1))
        got = C.reach_filter(g, ni, t, 0, 1, d_c, bidir)
        want = C.filter_rows(t, C.connectivity_mask(g, ni, a, b, d_c, bidir))
        assert got.result_set() == want.result_set()
        return view(got)
    twin(scenario)


# --------------------- test_fused_join_properties --------------------- #
@st.composite
def table_pair(draw):
    """The draws of the reference's ``table_pair``: the column seed, the
    column counts, the row counts and the value alphabet."""
    seed = draw(st.integers(0, 10_000))
    nca = draw(st.integers(1, 3))
    ncb = draw(st.integers(1, 3))
    na = draw(st.integers(0, 80))
    nb = draw(st.integers(0, 80))
    vmax = draw(st.sampled_from([2, 4, 9]))
    return seed, nca, ncb, na, nb, vmax


def _pair(S, seed, nca, ncb, na, nb, vmax):
    rng = np.random.default_rng(seed)
    a_cols = tuple(int(c) for c in rng.choice(4, nca, replace=False))
    rest = [c for c in range(4) if c not in a_cols]
    b_cols = (a_cols[0],) + tuple(
        int(c) for c in rng.choice(rest, min(ncb - 1, len(rest)),
                                   replace=False))
    a = mk_table(S, a_cols, rng.integers(0, vmax, (na, len(a_cols))))
    b = mk_table(S, b_cols, rng.integers(0, vmax, (nb, len(b_cols))))
    return a, b


@settings(max_examples=25, deadline=None)
@given(table_pair())
def test_all_strategies_identical(pair):
    def scenario(S):
        a, b = _pair(S, *pair)
        jt = S.matching.join_tables
        outs = [jt(a, b, impl="nested"), jt(a, b, impl="sorted", fuse=True),
                jt(a, b, impl="sorted", fuse=False), jt(a, b, impl="radix")]
        want = rows_multiset(outs[0])
        assert all(rows_multiset(o) == want for o in outs[1:])
        return [view(o) for o in outs]
    twin(scenario)


@settings(max_examples=10, deadline=None)
@given(table_pair(), st.sampled_from(["sorted", "radix"]))
def test_overflow_resume_identity(pair, impl):
    def scenario(S):
        M = S.matching
        a, b = _pair(S, *pair)
        straight = M.join_tables(a, b, impl=impl)
        want = rows_multiset(straight)
        if len(want) <= 1:
            return None
        cap = M._pow2(max(len(want) // 2, 1))
        if cap >= len(want):
            return None
        needed = None
        try:
            out = M.join_tables(a, b, impl=impl, cap=cap)
        except M.CapacityOverflow as e:
            needed = e.needed
            out = M.join_tables(a, b, impl=impl, cap=M._pow2(e.needed),
                                _resume=getattr(e, "resume", None))
        assert rows_multiset(out) == want
        return view(straight), needed, view(out)
    twin(scenario)
