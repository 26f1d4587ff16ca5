"""Reach-join subsystem of the port against the reference: twins of the
fifteen tests of ``tests/test_reach_join.py``, and the entry and byte
bounds of ``ReachCache`` and its ``invalidate_delta``.

Each scenario runs on both stacks (``torch_twin.twin``) with the same
graphs, tables and seeds; it asserts the reference test's claims on each
side (``reach_join`` / ``reach_filter`` equal the cross product filtered
by ``connectivity_mask``) and returns what it saw — output rows in order,
columns, counts, order tags, ``ReachJoinInfo`` and cache counters — which
must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import twin


def mk_table(S, cols, vals):
    vals = np.asarray(vals, np.int32).reshape(-1, len(cols))
    cap = S.matching._pow2(len(vals))
    rows = np.full((cap, len(cols)), -1, np.int32)
    rows[: len(vals)] = vals
    rows = torch.as_tensor(rows) if S.port else jnp.asarray(rows)
    return S.matching.Table(cols=tuple(cols), rows=rows, count=len(vals))


def dev(S) -> dict:
    """The device keyword of the port's table factories (they have no
    default device); the reference takes none."""
    return {"device": "cpu"} if S.port else {}


def empty(S, cols):
    return S.core.empty_table(cols, **dev(S))


def view(t) -> tuple:
    """A table as observed: columns, count, order tag, every row."""
    return (t.cols, t.count, t.sort_order, t.truncated,
            np.asarray(t.rows).tolist())


def oracle_join(S, g, ni, ta, tb, src_col, dst_col, d_c, bidir):
    x = S.core.cross_join(ta, tb)
    rows = np.asarray(x.rows[: x.count])
    keep = S.core.connectivity_mask(g, ni, rows[:, x.cols.index(src_col)],
                                    rows[:, x.cols.index(dst_col)], d_c,
                                    bidir)
    return S.core.filter_rows(x, keep)


# --------------------------- direct parity ---------------------------- #
@pytest.mark.parametrize("d_max,d_c,bidir", [
    (1, 2, False), (2, 2, False), (2, 3, True), (2, 4, False),
    (1, 3, True), (2, 5, False), (3, 5, True)])
def test_reach_join_matches_cross_filter(d_max, d_c, bidir):
    def scenario(S):
        g = S.graph(n_nodes=90, n_edges=280, n_preds=2,
                    seed=d_max * 7 + d_c)
        ni = S.core.build_ni_index(g, d_max=d_max)
        rng = np.random.default_rng(d_c)
        ta = mk_table(S, (0,), rng.integers(0, g.num_nodes, 60))
        tb = mk_table(S, (1,), rng.integers(0, g.num_nodes, 45))
        info = S.core.ReachJoinInfo()
        out = S.core.reach_join(g, ni, ta, tb, 0, 1, d_c, bidir, info=info)
        want = oracle_join(S, g, ni, ta, tb, 0, 1, d_c, bidir)
        assert out.result_set() == want.result_set()
        assert info.connected_pairs >= 0 and info.reach_pairs > 0
        return view(out), dataclasses.asdict(info)
    twin(scenario)


@pytest.mark.parametrize("d_max,d_c,bidir", [
    (2, 3, False), (2, 4, True), (1, 4, False)])
def test_reach_filter_matches_mask(d_max, d_c, bidir):
    def scenario(S):
        g = S.graph(n_nodes=70, n_edges=220, n_preds=2, seed=d_c + 40)
        ni = S.core.build_ni_index(g, d_max=d_max)
        rng = np.random.default_rng(5)
        a = rng.integers(0, g.num_nodes, 64)
        b = rng.integers(0, g.num_nodes, 64)
        t = mk_table(S, (2, 5), np.stack([a, b], axis=1))
        got = S.core.reach_filter(g, ni, t, 2, 5, d_c, bidir)
        mask = S.core.connectivity_mask(g, ni, a, b, d_c, bidir)
        want = S.core.filter_rows(t, mask)
        assert got.result_set() == want.result_set()
        return view(got), mask.tolist()
    twin(scenario)


def test_reach_join_multi_column_tables():
    def scenario(S):
        g = S.graph(n_nodes=80, n_edges=260, n_preds=2, seed=3)
        ni = S.core.build_ni_index(g, d_max=2)
        rng = np.random.default_rng(9)
        ta = mk_table(S, (0, 1), rng.integers(0, g.num_nodes, (40, 2)))
        tb = mk_table(S, (2, 3), rng.integers(0, g.num_nodes, (35, 2)))
        out = S.core.reach_join(g, ni, ta, tb, 1, 2, 3, False)
        want = oracle_join(S, g, ni, ta, tb, 1, 2, 3, False)
        assert out.cols == want.cols
        assert out.result_set() == want.result_set()
        return view(out)
    twin(scenario)


def test_reach_join_empty_sides():
    def scenario(S):
        g = S.graph(n_nodes=40, n_edges=100, n_preds=2, seed=1)
        ni = S.core.build_ni_index(g, d_max=2)
        ta = mk_table(S, (0,), np.arange(5))
        out = S.core.reach_join(g, ni, ta, empty(S, (1,)), 0, 1, 2)
        assert out.count == 0 and out.cols == (0, 1)
        out2 = S.core.reach_join(g, ni, empty(S, (0,)), ta, 0, 0, 2)
        assert out2.count == 0
        return view(out), view(out2)
    twin(scenario)


def test_connected_pair_table_is_exact_and_distinct():
    def scenario(S):
        C = S.core
        g = S.graph(n_nodes=60, n_edges=200, n_preds=2, seed=12)
        ni = C.build_ni_index(g, d_max=2)
        rng = np.random.default_rng(1)
        ta = mk_table(S, (0,), rng.integers(0, g.num_nodes, 30))
        tb = mk_table(S, (1,), rng.integers(0, g.num_nodes, 30))
        a_vals = C.distinct_column_values(ta, 0)
        b_vals = C.distinct_column_values(tb, 1)
        assert (np.diff(a_vals) > 0).all()
        cp = C.connected_pair_table(g, ni, a_vals, b_vals, 3, False, (0, 1),
                                    **dev(S))
        got = {tuple(r) for r in cp.numpy()}
        want = set()
        for a in a_vals:
            keep = C.connectivity_mask(g, ni, np.full(len(b_vals), a),
                                       b_vals, 3)
            want |= {(int(a), int(b)) for b, k in zip(b_vals, keep) if k}
        assert got == want
        assert cp.count == len(got)
        return a_vals.tolist(), b_vals.tolist(), view(cp)
    twin(scenario)


# ----------------------- capacity boundedness ------------------------- #
def test_reach_join_capacity_bounded_by_matches():
    def scenario(S):
        pow2 = S.matching._pow2
        g = S.graph(n_nodes=20_000, n_edges=40_000, n_preds=2, seed=8)
        ni = S.core.build_ni_index(g, d_max=1)
        rng = np.random.default_rng(2)
        pa = rng.choice(g.num_nodes, 1024, replace=False)
        pb = rng.choice(g.num_nodes, 1024, replace=False)
        ta = mk_table(S, (0,), rng.choice(pa, 4096))
        tb = mk_table(S, (1,), rng.choice(pb, 4096))
        info = S.core.ReachJoinInfo()
        out = S.core.reach_join(g, ni, ta, tb, 0, 1, 2, info=info)
        product = ta.count * tb.count
        assert info.peak_cap <= max(pow2(out.count), pow2(info.reach_pairs))
        assert info.peak_cap < product // 64
        assert out.cap == pow2(out.count)
        sub_a = mk_table(S, (0,), ta.numpy()[:256])
        sub_b = mk_table(S, (1,), tb.numpy()[:256])
        sub = S.core.reach_join(g, ni, sub_a, sub_b, 0, 1, 2)
        want = oracle_join(S, g, ni, sub_a, sub_b, 0, 1, 2, False)
        assert sub.result_set() == want.result_set()
        return view(out), dataclasses.asdict(info), view(sub)
    twin(scenario)


# --------------------------- reach cache ------------------------------ #
def test_reach_cache_shared_across_edges(monkeypatch):
    def scenario(S):
        C = S.core
        conn_mod = C.connectivity
        g = S.graph(n_nodes=60, n_edges=180, n_preds=2, seed=4)
        ni = C.build_ni_index(g, d_max=1)
        calls = {"n": 0}
        real = conn_mod._bfs_within

        def counting(*a, **k):
            calls["n"] += 1
            return real(*a, **k)
        monkeypatch.setattr(conn_mod, "_bfs_within", counting)
        rng = np.random.default_rng(0)
        a = rng.integers(0, g.num_nodes, 32)
        b = rng.integers(0, g.num_nodes, 32)
        cache = C.ReachCache()
        m1 = C.connectivity_mask(g, ni, a, b, 5, cache=cache)
        first = calls["n"]
        assert first > 0
        C.connectivity_mask(g, ni, a, b, 5, cache=cache)
        assert calls["n"] == first
        ta, tb = mk_table(S, (0,), a), mk_table(S, (1,), b)
        out = C.reach_join(g, ni, ta, tb, 0, 1, 5, cache=cache)
        assert calls["n"] == first
        assert out.result_set() == oracle_join(S, g, ni, ta, tb, 0, 1, 5,
                                               False).result_set()
        return (m1.tolist(), first, view(out), cache.hits, cache.misses,
                len(cache), cache.total_bytes)
    twin(scenario)


def test_engine_conn_telemetry_and_parity():
    def scenario(S):
        g = S.graph(n_nodes=120, n_edges=400, n_preds=3, seed=11)
        q = S.query(g, size=5, seed=23, n_connection=2, d_c=3)
        assert q.connections, "the sampled query has connection edges"
        results = {}
        for ci in ("reach", "cross", "auto"):
            for pm in ("cost", "greedy"):
                eng = S.engine(g, "h2")
                eng.cfg.connection_impl = ci
                eng.cfg.plan_mode = pm
                r = eng.execute(q)
                n_edges = sum(r.stats.conn_strategies.values())
                assert n_edges == len(q.connections)
                if ci != "auto":
                    assert set(r.stats.conn_strategies) == {ci}
                if ci == "reach":
                    assert r.stats.conn_reach_pairs > 0
                    assert r.stats.conn_endpoint_distinct > 0
                results[(ci, pm)] = (r.result_set(),
                                     r.stats.conn_strategies,
                                     r.stats.conn_reach_pairs,
                                     r.stats.conn_endpoint_distinct)
        first = next(iter(results.values()))[0]
        assert all(v[0] == first for v in results.values())
        return results
    twin(scenario)


# ------------------- wildcard interval candidates --------------------- #
def test_edge_pairs_interval_spec_matches_mask():
    def scenario(S):
        g = S.graph(n_nodes=80, n_edges=250, n_preds=3, seed=6)
        n = g.num_nodes
        lo_s, hi_s, lo_d, hi_d = 10, 50, 20, 70
        m_s = np.zeros(n, bool)
        m_s[lo_s:hi_s] = True
        m_d = np.zeros(n, bool)
        m_d[lo_d:hi_d] = True
        if S.port:
            mask, iv = torch.as_tensor, (lambda lo, hi: (lo, hi))
        else:
            mask = jnp.asarray
            iv = (lambda lo, hi: (jnp.int32(lo), jnp.int32(hi)))
        ep = S.matching.edge_pairs
        t_mask = ep(g, 1, mask(m_s), mask(m_d), (0, 1))
        t_iv = ep(g, 1, iv(lo_s, hi_s), iv(lo_d, hi_d), (0, 1))
        t_mix = ep(g, 1, mask(m_s), iv(lo_d, hi_d), (0, 1))
        assert t_mask.result_set() == t_iv.result_set()
        assert t_mix.result_set() == t_mask.result_set()
        return view(t_mask), view(t_iv), view(t_mix)
    twin(scenario)


def test_engine_wildcard_candidates_need_no_masks():
    def scenario(S):
        g = S.graph(n_nodes=100, n_edges=350, n_preds=3, seed=15)
        q = S.query(g, size=4, seed=31, n_connection=1, d_c=3)
        r_never = S.engine(g, "stwig+").execute(q)
        eng = S.engine(g, "h2")
        eng.cfg.check_policy = "always"
        r_always = eng.execute(q)
        assert r_never.result_set() == r_always.result_set()
        assert not r_never.stats.used_check
        return r_never.result_set(), r_always.stats.candidates_after
    twin(scenario)


# ------------------------ dedup_project ------------------------------- #
def test_dedup_project_distinct_sorted():
    def scenario(S):
        rng = np.random.default_rng(0)
        t = mk_table(S, (3, 1, 2), rng.integers(0, 6, (200, 3)))
        d = S.core.dedup_project(t, (1, 2))
        want = sorted({(int(r[1]), int(r[2])) for r in t.numpy()})
        assert [tuple(r) for r in d.numpy()] == want
        assert d.sort_order == (1, 2) and d.cols == (1, 2)
        return view(d)
    twin(scenario)


def test_dedup_project_tolerates_scattered_padding():
    def scenario(S):
        rows = np.full((16, 2), -1, np.int32)
        rows[3] = (5, 2)
        rows[9] = (5, 2)
        rows[12] = (1, 7)
        rows = torch.as_tensor(rows) if S.port else jnp.asarray(rows)
        t = S.matching.Table(cols=(0, 1), rows=rows, count=3)
        d = S.core.dedup_project(t, (0, 1))
        assert d.count == 2
        assert {tuple(r) for r in d.numpy()} == {(5, 2), (1, 7)}
        return view(d)
    twin(scenario)


# ------------------------ planner choice ------------------------------ #
def test_choose_connection_impl_regimes():
    def scenario(S):
        C = S.core
        feat = C.ConnFeatures(distinct_a=20, distinct_b=20, reach_fwd=8.0,
                              reach_bwd=4.0)
        picks = (C.choose_connection_impl(20_000, 20_000, feat, 1e-3,
                                          100_000),
                 C.choose_connection_impl(4, 4, feat, 1e-3, 100_000),
                 C.choose_connection_impl(4, 4, feat, 1e-3, 100_000,
                                          impl="reach"))
        assert picks == ("reach", "cross", "reach")
        cross, reach = C.connection_edge_cost(20_000, 20_000, feat, 1e-3,
                                              100_000)
        assert reach < cross
        return picks, cross, reach
    twin(scenario)


def test_plan_connections_with_features():
    def scenario(S):
        C = S.core
        sizes, endpoints, sels = [1000, 2000, 50], [(0, 1), (1, 2)], \
            [1e-3, 1e-2]
        feats = [C.ConnFeatures(10, 10, 4.0, 4.0),
                 C.ConnFeatures(50, 5, 4.0, 4.0)]
        plan = C.plan_connections(sizes, endpoints, sels, feats=feats,
                                  num_nodes=10_000, impl="auto")
        legacy = C.plan_connections(sizes, endpoints, sels)
        assert sorted(plan.order) == [0, 1]
        assert plan.est_cost <= legacy.est_cost + 1e-9
        return dataclasses.asdict(plan), dataclasses.asdict(legacy)
    twin(scenario)


def test_expected_reach_monotone_capped():
    def scenario(S):
        g = S.graph(n_nodes=60, n_edges=300, n_preds=2, seed=2)
        st_ = S.core.compute_stats(g)
        vals = [S.core.expected_reach(st_, g.num_nodes, h) for h in range(6)]
        assert vals[0] == 1.0
        assert all(b >= a for a, b in zip(vals, vals[1:]))
        assert vals[-1] <= g.num_nodes
        return vals
    twin(scenario)


# ------------------ ReachCache bounds and deltas ---------------------- #
def _cache_ops(S, rc, seed, n_ops=300):
    """A seeded stream of set/array puts and gets on ``rc``; what it saw
    after each step: hits, misses, evictions, entries and bytes."""
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(n_ops):
        key = (int(rng.integers(0, 40)), int(rng.integers(1, 4)),
               int(rng.choice([-1, 1])))
        op = int(rng.integers(0, 4))
        if op == 0:
            rc.put_set(*key, set(int(x) for x in
                                 rng.integers(0, 500, rng.integers(0, 60))))
        elif op == 1:
            rc.put_array(*key, np.unique(rng.integers(
                0, 500, rng.integers(0, 60))).astype(np.int32))
        elif op == 2:
            s = rc.get_set(*key)
            trace.append(None if s is None else sorted(s))
        else:
            a = rc.get_array(*key)
            trace.append(None if a is None else sorted(a.tolist()))
        trace.append((rc.hits, rc.misses, rc.evictions, len(rc),
                      rc.total_bytes))
    return trace


@pytest.mark.parametrize("max_entries,max_bytes", [
    (None, None), (5, None), (None, 600), (12, 2000), (1, None),
    (None, 64)])
def test_reach_cache_entry_and_byte_bounds(max_entries, max_bytes):
    """The LRU bounds evict the same keys in the same order, and the
    byte accounting of both mirrors matches, step by step."""
    def scenario(S):
        rc = S.core.ReachCache(max_entries=max_entries, max_bytes=max_bytes)
        trace = _cache_ops(S, rc, seed=(max_entries or 0) + (max_bytes or 1))
        if max_entries is not None:
            assert len(rc) <= max_entries
        if max_bytes is not None:
            assert rc.total_bytes <= max_bytes or len(rc) == 1
        return trace, list(rc._lru), sorted(rc._nbytes.items())
    twin(scenario)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reach_cache_invalidate_delta(seed):
    """invalidate_delta drops exactly the entries whose seed node or
    stored reach set meets the delta's endpoints, and clear() drops all;
    the surviving keys, sets and counters are the reference's."""
    def scenario(S):
        rc = S.core.ReachCache(max_entries=30)
        trace = _cache_ops(S, rc, seed=seed + 10)
        rng = np.random.default_rng(seed)
        out = [trace]
        for k in (0, 1, 5, 40):
            eps = rng.integers(0, 500, k)
            dropped = rc.invalidate_delta(eps)
            out.append((dropped, list(rc._lru), rc.evictions,
                        rc.total_bytes,
                        {key: sorted(v) for key, v in rc.sets.items()},
                        {key: v.tolist() for key, v in rc.arrays.items()}))
        out.append((rc.clear(), len(rc), rc.total_bytes, rc.evictions))
        return out
    twin(scenario)
