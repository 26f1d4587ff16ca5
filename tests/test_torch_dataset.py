"""Twins of tests/test_dataset.py: the Dataset facade and delta ingest of
the port against the reference, one twin per reference case.

Each twin runs the reference test's scenario on both stacks
(`torch_twin.twin`: the same graphs, deltas and queries from the same
numpy seeds, `impl="ref"`, the port on the CPU), asserts the reference
test's own claims on each side, and holds what each side observed equal,
exactly: digests, versions and cache keys, `delta_info`, edge arrays,
CSRs, NI entries and stats (`dataset_view`), `csr_patch` outputs, result
sets and engine statistics, and the type and message of each error.
"""
import warnings

import numpy as np
import pytest

from torch_twin import dataset_view, freeze, run_stats, twin


# --------------------------- helpers ----------------------------------- #
def _mk(S, seed=3, n_nodes=150, n_edges=450, n_preds=5):
    g = S.graph(n_nodes=n_nodes, n_edges=n_edges, n_preds=n_preds,
                n_literals=25, seed=seed)
    return S.core.Dataset.build(g, variant="rdf_h")


def _recombine_delta(ds, rng, n_ins=4, n_del=4):
    """The reference test's delta (tests/test_dataset.py::_recombine_delta):
    inserts recombine subject/object pairs within one predicate, deletes
    hit only edges whose endpoints stay mentioned."""
    g = ds.graph
    lab, prd = g.labels, g.predicates
    subj = np.bincount(g.src, minlength=g.num_nodes)
    ment = subj + np.bincount(g.dst, minlength=g.num_nodes)
    safe = np.flatnonzero((subj[g.src] >= 2) & (ment[g.src] >= 3)
                          & (ment[g.dst] >= 3))
    dels = rng.choice(safe, size=min(n_del, safe.size), replace=False)
    deletes = [(lab[g.src[i]], prd[g.pred[i]], lab[g.dst[i]])
               for i in dels]
    picks = rng.choice(g.num_edges, size=2 * n_ins, replace=False)
    inserts = [(lab[g.src[i]], prd[g.pred[i]], lab[g.dst[j]])
               for i, j in zip(picks, np.roll(picks, 1))
               if g.pred[i] == g.pred[j]]
    return inserts, deletes


def _oracle(S, ds, inserts, deletes):
    """From-scratch Dataset on the post-delta triples."""
    post = ds._post_triples(inserts, deletes)
    return S.core.Dataset.from_triples(
        post, literal_objects=ds.literal_forced, variant="rdf_h")


def _run(eng, q):
    """One execution: its columns, result set and count-valued stats."""
    r = eng.execute(q)
    return (tuple(r.cols), r.result_set(), run_stats(r))


def _error(fn):
    """The type and message of the error `fn` raises."""
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value)


# ------------------------- construction API ----------------------------- #
def test_build_owns_all_derived_state():
    """Twin of test_dataset.py::test_build_owns_all_derived_state."""
    def scenario(S):
        ds = _mk(S)
        assert ds.version == 0
        assert ds.digest == S.core.content_digest(ds.graph)
        assert ds.cache_key == f"{ds.digest}:v0"
        assert ds.ni.d_max == S.core.ENGINE_VARIANTS["rdf_h"]["d"]
        assert ds.stats is not None and ds.idmap is not None
        return dataset_view(ds), S.core.ENGINE_VARIANTS["rdf_h"]
    twin(scenario)


def test_engine_accepts_dataset_and_rejects_sidecar_state():
    """Twin of
    test_dataset.py::test_engine_accepts_dataset_and_rejects_sidecar_state:
    the same ValueErrors, type and message."""
    def scenario(S):
        ds = _mk(S)
        eng = S.core.Engine(ds, S.cfg())
        assert eng.dataset is ds and eng.graph is ds.graph
        kw = S._kw({})
        with pytest.raises(ValueError, match="Dataset"):
            S.core.make_engine(ds, "rdf_h", stats=ds.stats, **kw)
        with pytest.raises(ValueError, match="hops"):
            S.core.make_engine(ds, "h3", **kw)
        return (_error(lambda: S.core.make_engine(ds, "rdf_h",
                                                  stats=ds.stats, **kw)),
                _error(lambda: S.core.make_engine(ds, "h3", **kw)))
    twin(scenario)


def test_make_engine_graph_shim_warns_and_matches():
    """Twin of
    test_dataset.py::test_make_engine_graph_shim_warns_and_matches."""
    def scenario(S):
        g = S.graph(n_nodes=100, n_edges=300, n_preds=4, seed=7)
        ds = S.core.Dataset.build(g, variant="rdf_h")
        q = S.query(g, size=4, seed=2)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            legacy = S.core.make_engine(g, "rdf_h", **S._kw({}))
        # each names its own package
        dep = [str(x.message).replace(S.name + ".", "<package>.")
               for x in w if issubclass(x.category, DeprecationWarning)]
        assert dep
        got, want = _run(legacy, q), _run(S.engine(ds), q)
        assert got[1] == want[1]
        return dep, got, want, dataset_view(legacy.dataset)
    twin(scenario)


# --------------------------- csr_patch --------------------------------- #
def test_csr_patch_matches_full_rebuild():
    """Twin of test_dataset.py::test_csr_patch_matches_full_rebuild."""
    def scenario(S):
        rng = np.random.default_rng(0)
        g = S.graph(n_nodes=80, n_edges=240, n_preds=4, seed=11)
        dels = rng.choice(g.num_edges, size=10, replace=False)
        keep = np.setdiff1d(np.arange(g.num_edges), dels)
        n_ins = 12
        ins_src = rng.integers(0, g.num_nodes, n_ins).astype(np.int32)
        ins_dst = rng.integers(0, g.num_nodes, n_ins).astype(np.int32)
        ins_pred = rng.integers(0, 4, n_ins).astype(np.int32)
        new_src = np.concatenate([g.src[keep], ins_src])
        new_dst = np.concatenate([g.dst[keep], ins_dst])
        new_pred = np.concatenate([g.pred[keep], ins_pred])
        want = S.graph_mod._csr(g.num_nodes, new_src, new_dst, new_pred)
        got = S.core.csr_patch(g.out_csr, g.num_nodes, 4,
                               g.src[dels], g.dst[dels], g.pred[dels],
                               ins_src, ins_dst, ins_pred)
        assert got is not None
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return freeze(got), freeze(want)
    twin(scenario)


def test_csr_patch_declines_on_pack_overflow():
    """Twin of test_dataset.py::test_csr_patch_declines_on_pack_overflow."""
    def scenario(S):
        g = S.graph(n_nodes=40, n_edges=80, n_preds=2, seed=5)
        huge = 2 ** 33
        out = S.core.csr_patch(g.out_csr, huge, huge,
                               g.src[:1], g.dst[:1], g.pred[:1],
                               g.src[:0], g.dst[:0], g.pred[:0])
        assert out is None
        return out
    twin(scenario)


# ------------------------ delta == rebuild ------------------------------ #
def test_apply_delta_incremental_matches_rebuild_bitwise():
    """Twin of
    test_dataset.py::test_apply_delta_incremental_matches_rebuild_bitwise:
    on each side the incremental Dataset equals the rebuilt one (the
    reference test's claims), and across the sides both are equal field
    for field, NI rows in order."""
    def scenario(S):
        ds = _mk(S, seed=9)
        rng = np.random.default_rng(1)
        inserts, deletes = _recombine_delta(ds, rng, n_ins=5, n_del=5)
        new = ds.apply_delta(inserts, deletes)
        assert new.delta_info["mode"] == "incremental"
        assert new.version == 1 and new.cache_key.endswith(":v1")
        want = _oracle(S, ds, inserts, deletes)
        assert new.digest == want.digest
        g1, g2 = new.graph, want.graph
        for k in ("src", "dst", "pred", "pred_kind"):
            np.testing.assert_array_equal(getattr(g1, k), getattr(g2, k))
        for csr1, csr2 in ((g1.out_csr, g2.out_csr), (g1.in_csr, g2.in_csr)):
            for a, b in zip(csr1, csr2):
                np.testing.assert_array_equal(a, b)
        s1, s2 = new.stats, want.stats
        np.testing.assert_array_equal(s1.pred_selectivity,
                                      s2.pred_selectivity)
        assert (s1.coherence, s1.specialty, s1.diversity) == \
            (s2.coherence, s2.specialty, s2.diversity)
        assert s1.literal_selectivity.keys() == s2.literal_selectivity.keys()
        for k in s1.literal_selectivity:
            np.testing.assert_array_equal(s1.literal_selectivity[k],
                                          s2.literal_selectivity[k])
        for key, e2 in want.ni.entries.items():
            e1 = new.ni.entries[key]
            np.testing.assert_array_equal(e1.count, e2.count)
            np.testing.assert_array_equal(e1.overflow, e2.overflow)
            for r in range(e1.ids.shape[0]):
                if not e1.overflow[r]:
                    assert (set(e1.ids[r][:e1.count[r]].tolist())
                            == set(e2.ids[r][:e2.count[r]].tolist()))
        return dataset_view(new), dataset_view(want)
    twin(scenario)


@pytest.mark.parametrize("policy", ["always", "never", "selective"])
@pytest.mark.parametrize("plan_mode", ["cost", "greedy"])
def test_delta_query_parity_grid(policy, plan_mode):
    """Twin of test_dataset.py::test_delta_query_parity_grid: engines
    over apply_delta and over a rebuilt Dataset agree on each side, and
    each engine's runs (columns, result sets, statistics) agree across
    the sides."""
    def scenario(S):
        ds = _mk(S, seed=21, n_nodes=120, n_edges=380)
        rng = np.random.default_rng(7)
        inserts, deletes = _recombine_delta(ds, rng)
        new = ds.apply_delta(inserts, deletes)
        assert new.delta_info["mode"] == "incremental"
        want = _oracle(S, ds, inserts, deletes)

        def eng(d):
            e = S.engine(d)
            e.cfg.check_policy = policy
            e.cfg.plan_mode = plan_mode
            return e
        ea, eb = eng(new), eng(want)
        out = [dataset_view(new)]
        for i in range(4):
            q = S.query(new.graph, size=4, seed=400 + i,
                        n_connection=i % 2, d_c=2)
            ra, rb = ea.execute(q), eb.execute(q)
            assert ra.cols == rb.cols
            np.testing.assert_array_equal(
                np.sort(ra.rows, axis=0) if ra.rows.size else ra.rows,
                np.sort(rb.rows, axis=0) if rb.rows.size else rb.rows)
            out.append((tuple(ra.cols), ra.result_set(), run_stats(ra),
                        run_stats(rb)))
        return out
    twin(scenario)


def test_apply_delta_is_pure_snapshot_isolation():
    """Twin of test_dataset.py::test_apply_delta_is_pure_snapshot_isolation."""
    def scenario(S):
        ds = _mk(S, seed=13)
        q = S.query(ds.graph, size=4, seed=77)
        before = S.engine(ds).execute(q).result_set()
        digest0 = ds.digest
        edges0 = ds.graph.num_edges
        view0 = dataset_view(ds)
        rng = np.random.default_rng(3)
        inserts, deletes = _recombine_delta(ds, rng)
        new = ds.apply_delta(inserts, deletes)
        assert new is not ds and new.graph is not ds.graph
        assert ds.version == 0 and ds.digest == digest0
        assert ds.graph.num_edges == edges0
        assert dataset_view(ds) == view0
        after_old = S.engine(ds).execute(q).result_set()
        assert after_old == before
        assert new.digest != digest0
        return before, dataset_view(new)
    twin(scenario)


# ------------------------- rebuild fallbacks ---------------------------- #
def test_fallback_new_label():
    """Twin of test_dataset.py::test_fallback_new_label; the rebuilt
    Dataset also equals a build from the post-delta triples."""
    def scenario(S):
        ds = _mk(S)
        ins = [("Zz/new-subject-404", ds.graph.predicates[0],
                ds.graph.labels[0])]
        new = ds.apply_delta(inserts=ins)
        assert new.delta_info["mode"] == "rebuild"
        assert new.delta_info["reason"] == "new-label"
        assert new.version == 1 and new.touched is None
        assert new.digest == _oracle(S, ds, ins, []).digest
        return dataset_view(new)
    twin(scenario)


def test_fallback_churn_threshold():
    """Twin of test_dataset.py::test_fallback_churn_threshold."""
    def scenario(S):
        ds = _mk(S)
        g = ds.graph
        lab, prd = g.labels, g.predicates
        picks = np.arange(g.num_edges)
        inserts = [(lab[g.src[i]], prd[g.pred[i]], lab[g.dst[j]])
                   for i, j in zip(picks, np.roll(picks, 1))
                   if g.pred[i] == g.pred[j]][:100]
        new = ds.apply_delta(inserts=inserts, churn_threshold=0.01)
        assert new.delta_info["mode"] == "rebuild"
        assert new.delta_info["reason"] == "churn"
        inc = ds.apply_delta(inserts=inserts, churn_threshold=1.0)
        assert inc.delta_info["mode"] == "incremental"
        assert inc.digest == new.digest
        return dataset_view(new), dataset_view(inc)
    twin(scenario)


def test_fallback_label_dropped():
    """Twin of test_dataset.py::test_fallback_label_dropped."""
    def scenario(S):
        ds = _mk(S)
        g = ds.graph
        ment = (np.bincount(g.src, minlength=g.num_nodes)
                + np.bincount(g.dst, minlength=g.num_nodes))
        ment[ment == 0] = np.iinfo(ment.dtype).max
        victim = int(np.argmin(ment))
        idx = np.flatnonzero((g.src == victim) | (g.dst == victim))
        deletes = [(g.labels[g.src[i]], g.predicates[g.pred[i]],
                    g.labels[g.dst[i]]) for i in idx]
        new = ds.apply_delta(deletes=deletes)
        assert new.delta_info["mode"] == "rebuild"
        assert new.delta_info["reason"] in ("label-dropped", "node-kind")
        q = S.query(new.graph, size=3, seed=5)
        want = _oracle(S, ds, [], deletes)
        got_run, want_run = _run(S.engine(new), q), _run(S.engine(want), q)
        assert got_run[1] == want_run[1]
        return dataset_view(new), got_run, want_run
    twin(scenario)


def test_delete_unknown_triple_is_noop_insert_existing_duplicates():
    """Twin of
    test_dataset.py::
    test_delete_unknown_triple_is_noop_insert_existing_duplicates."""
    def scenario(S):
        ds = _mk(S)
        g = ds.graph
        new = ds.apply_delta(deletes=[("No/such", "no-pred", "No/where")])
        assert new.graph.num_edges == g.num_edges
        assert new.version == 1
        t0 = (g.labels[g.src[0]], g.predicates[g.pred[0]],
              g.labels[g.dst[0]])
        dup = ds.apply_delta(inserts=[t0])
        assert dup.graph.num_edges == g.num_edges + 1
        return dataset_view(new), dataset_view(dup)
    twin(scenario)


# ---------------------- footprint predicate ----------------------------- #
def test_interval_footprint_hit():
    """Twin of test_dataset.py::test_interval_footprint_hit."""
    def scenario(S):
        hit = S.core.interval_footprint_hit
        touched = np.array([5, 17, 40], dtype=np.int64)
        cases = [None, [], [(15, 20)], [(18, 40)], [(0, 1), (40, 41)],
                 [(5, 6)], [(6, 17)], [(41, 100)]]
        got = [hit(iv, touched) for iv in cases]
        assert got[:5] == [True, False, True, False, True]
        return got, hit([(0, 10)], None), hit([(0, 10)],
                                              np.empty(0, np.int64))
    twin(scenario)
