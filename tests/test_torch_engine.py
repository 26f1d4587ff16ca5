"""End-to-end parity of the PyTorch port against the JAX package.

The same generated datasets go through ``repro`` and ``repro_torch``: the
Dataset digest and NI tensors must be identical, and ``Engine.execute`` must
return the same result sets, cold and warm, with the same join strategies,
check decisions and ``QueryStats.to_dict()`` keys.  The port runs on the
CPU here (``device="cpu"``); the card runs it through ``chip_smoke.py``.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro.core as J
import repro.data as JD
import repro_torch.core as T
import repro_torch.core.engine as tengine
import repro_torch.data as TD

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (dataset, scale, (query seed, connection edges) ...): picked so the
# grid covers the neighborhood check, radix/sorted/nested joins and both
# connection-edge strategies
GRID = [("lubm", 0.05, ((102, 0), (109, 1))),
        ("dblp", 0.05, ((103, 0), (101, 0))),
        ("imdb", 0.05, ((104, 0), (106, 1))),
        ("sp2b", 0.05, ((111, 1), (100, 0)))]


def _pair(name, scale):
    gj = JD.DATASETS[name](scale=scale, seed=1)
    gt = TD.DATASETS[name](scale=scale, seed=1)
    return J.Dataset.build(gj), T.Dataset.build(gt)


def _queries(dj, dt, seeds):
    for s, nc in seeds:
        yield (JD.random_query(dj.graph, size=6, seed=s, n_connection=nc),
               TD.random_query(dt.graph, size=6, seed=s, n_connection=nc))


def _same_run(a, b):
    assert b.result_set() == a.result_set()
    assert b.count == a.count
    assert b.stats.used_check == a.stats.used_check
    assert b.stats.join_strategies == a.stats.join_strategies
    assert b.stats.conn_strategies == a.stats.conn_strategies
    assert (b.stats.sorts_performed, b.stats.sorts_avoided) == \
        (a.stats.sorts_performed, a.stats.sorts_avoided)
    assert b.stats.candidates_after == a.stats.candidates_after
    assert set(b.stats.to_dict()) == set(a.stats.to_dict())


@pytest.mark.parametrize("name,scale,seeds", GRID)
def test_dataset_and_engine_parity(name, scale, seeds):
    dj, dt = _pair(name, scale)
    assert dt.digest == dj.digest == T.content_digest(dt.graph)
    assert sorted(dt.ni.entries) == sorted(dj.ni.entries)
    for k, e in dj.ni.entries.items():
        np.testing.assert_array_equal(dt.ni.entries[k].ids, e.ids)
        np.testing.assert_array_equal(dt.ni.entries[k].overflow, e.overflow)
    ej, et = dj.engine("rdf_h"), dt.engine("rdf_h", device="cpu")
    assert et.cfg.device == "cpu" and et.cfg.check_policy == "selective"
    for qj, qt in _queries(dj, dt, seeds):
        pj, pt = ej.prepare(qj), et.prepare(qt)
        assert pt.use_check == pj.use_check
        for _ in ("cold", "warm"):
            _same_run(ej.execute_prepared(pj), et.execute_prepared(pt))
        assert pt.join_seq == pj.join_seq
        assert pt.conn_impls == pj.conn_impls


def test_grid_covers_the_main_path():
    """The parity grid reaches the check, every join strategy and a
    connection edge (seeds pinned above)."""
    used, strategies, conns = set(), set(), set()
    for name, scale, seeds in GRID:
        g = TD.DATASETS[name](scale=scale, seed=1)
        eng = T.Dataset.build(g).engine("rdf_h", device="cpu")
        for s, nc in seeds:
            q = TD.random_query(g, size=6, seed=s, n_connection=nc)
            r = eng.execute(q)
            used.add(r.stats.used_check)
            strategies |= set(r.stats.join_strategies)
            conns |= set(r.stats.conn_strategies)
    assert used == {True, False}
    assert {"sorted", "nested", "radix"} <= strategies
    assert conns == {"cross", "reach"}


def test_always_check_variant_matches():
    """SPath(NI2) runs the neighborhood check on every query."""
    dj, dt = _pair("dblp", 0.05)
    ej, et = dj.engine("spath_ni2"), dt.engine("spath_ni2", device="cpu")
    for qj, qt in _queries(dj, dt, ((104, 0),)):
        a, b = ej.execute(qj), et.execute(qt)
        assert b.stats.used_check and b.stats.candidates_after \
            < b.stats.candidates_before
        _same_run(a, b)


@pytest.mark.parametrize("variant", sorted(J.ENGINE_VARIANTS))
def test_every_variant_matches_cold_and_warm(variant):
    """Every engine variant (paper §6) against the reference on one
    dataset built for it: stwig+ never checks, spath_ni2 always does, h3
    checks at distance 3 over a depth-3 NI index, hvc over the
    vertex-cover NI variant."""
    gj = JD.DATASETS["lubm"](scale=0.05, seed=1)
    gt = TD.DATASETS["lubm"](scale=0.05, seed=1)
    dj = J.Dataset.build(gj, variant=variant)
    dt = T.Dataset.build(gt, variant=variant)
    assert sorted(dt.ni.entries) == sorted(dj.ni.entries)
    ej, et = dj.engine(variant), dt.engine(variant, device="cpu")
    assert et.cfg.check_policy == ej.cfg.check_policy
    assert et.cfg.d_check == ej.cfg.d_check
    for qj, qt in _queries(dj, dt, ((102, 0), (109, 1), (104, 0))):
        pj, pt = ej.prepare(qj), et.prepare(qt)
        assert pt.use_check == pj.use_check
        for _ in ("cold", "warm"):
            _same_run(ej.execute_prepared(pj), et.execute_prepared(pt))
        assert pt.join_seq == pj.join_seq
        assert pt.conn_impls == pj.conn_impls


def test_from_arrays_on_a_jax_built_dataset():
    dj = J.Dataset.build(JD.DATASETS["imdb"](scale=0.05, seed=1))
    g = dj.graph
    arrays = {k: getattr(g, k) for k in ("labels", "node_kind", "src", "dst",
                                        "pred", "predicates", "pred_kind")}
    for k, e in dj.ni.entries.items():
        arrays[f"ni.{k}.ids"] = e.ids
        arrays[f"ni.{k}.overflow"] = e.overflow
    dt = T.Dataset.from_arrays(arrays)
    assert dt.digest == dj.digest
    for k, e in dj.ni.entries.items():
        np.testing.assert_array_equal(dt.ni.entries[k].bin_lo, e.bin_lo)
        np.testing.assert_array_equal(dt.ni.entries[k].bin_hi, e.bin_hi)
    ej, et = dj.engine("spath_ni2"), dt.engine("spath_ni2", device="cpu")
    for s in (100,):
        q = JD.random_query(g, size=6, seed=s)
        qt = TD.random_query(dt.graph, size=6, seed=s)
        _same_run(ej.execute(q), et.execute(qt))


@pytest.mark.parametrize("seed", [3, 4])
def test_apply_delta_matches_reference(seed):
    """Incremental delta ingest: same digest, mode, touched set and NI
    tensors as the reference's, on the random-graph grid of
    tests/test_dataset.py."""
    kw = dict(n_nodes=150, n_edges=450, n_preds=5, n_literals=25, seed=seed)
    dj = J.Dataset.build(JD.random_graph(**kw))
    dt = T.Dataset.build(TD.random_graph(**kw))
    g, rng = dj.graph, np.random.default_rng(seed)
    picks = rng.choice(g.num_edges, size=12, replace=False)
    inserts = [(g.labels[g.src[i]], g.predicates[g.pred[i]],
                g.labels[g.dst[j]])
               for i, j in zip(picks[:6], np.roll(picks[:6], 1))
               if g.pred[i] == g.pred[j]]
    deletes = [(g.labels[g.src[i]], g.predicates[g.pred[i]],
                g.labels[g.dst[i]]) for i in picks[6:8]]
    nj = dj.apply_delta(inserts, deletes)
    nt = dt.apply_delta(inserts, deletes)
    assert nt.digest == nj.digest and nt.version == nj.version == 1
    assert nt.delta_info == nj.delta_info
    assert nt.delta_info["mode"] == "incremental"
    if nj.touched is not None:
        np.testing.assert_array_equal(nt.touched, nj.touched)
    for k, e in nj.ni.entries.items():
        for field in ("ids", "overflow", "count", "bin_lo", "bin_hi"):
            np.testing.assert_array_equal(getattr(nt.ni.entries[k], field),
                                          getattr(e, field))


@pytest.mark.parametrize("cap,m", [(8, 5), (16, 4), (24, 5), (40, 7)])
def test_patch_entry_matches_reference(cap, m):
    """The port's patch_entry computes its bin summaries a block of rows
    at a time: the same ids, counts, overflow bits and bin bounds as the
    reference's per-bin loop, with short, full and overflowing lists, an
    emptied row and a row rewritten twice."""
    from repro.core.ni_index import _pack as jpack
    from repro.core.ni_index import patch_entry as jpatch
    from repro_torch.core.ni_index import patch_entry as tpatch
    rng = np.random.default_rng(cap * m)
    base = jpack([np.unique(rng.integers(0, 500, rng.integers(0, cap + 4)))
                  .astype(np.int32) for _ in range(60)], cap, m)
    rows = np.concatenate([rng.choice(60, 25, replace=False), [7, 7]])
    lists = [np.unique(rng.integers(0, 500, n)).astype(np.int32)
             for n in rng.integers(0, 2 * cap, rows.size)]
    lists[3] = np.empty(0, np.int32)
    want = jpatch(base, rows, lists, m)
    got = tpatch(base, rows, lists, m)
    for field in ("ids", "overflow", "count", "bin_lo", "bin_hi"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_warm_run_never_replans_or_rechecks(monkeypatch):
    dt = T.Dataset.build(TD.DATASETS["imdb"](scale=0.05, seed=1))
    eng = dt.engine("rdf_h", device="cpu")
    pqs = [eng.prepare(TD.random_query(dt.graph, size=6, seed=s,
                                       n_connection=nc))
           for s, nc in ((100, 0), (101, 1), (106, 1))]
    assert [pq.use_check for pq in pqs] == [True, True, False]
    colds = [eng.execute_prepared(pq) for pq in pqs]
    # the bloom configuration too: its prefilter runs on the cold run only
    bloom = T.Engine(dt, T.EngineConfig(device="cpu", check_policy="always",
                                        use_bloom=True))
    bpq = bloom.prepare(TD.random_query(dt.graph, size=6, seed=100,
                                        exact_nodes=0.5))
    bcold = bloom.execute_prepared(bpq)
    assert "bloom" in bloom._dev_cache

    def forbidden(*a, **kw):
        raise AssertionError("warm run re-entered planning or the check")
    for name in ("decide", "plan_table_joins", "plan_connections",
                 "check_template", "build_requirements",
                 "choose_connection_impl", "bloom_prefilter", "build_bloom"):
        monkeypatch.setattr(tengine, name, forbidden)
    assert bloom.execute_prepared(bpq).result_set() == bcold.result_set()
    for pq, cold in zip(pqs, colds):
        warm = eng.execute_prepared(pq)
        assert warm.stats.cache_hit and warm.stats.join_retries == 0
        assert warm.result_set() == cold.result_set()
        assert warm.stats.join_strategies == cold.stats.join_strategies
        assert warm.stats.conn_strategies == cold.stats.conn_strategies


def test_cuda_engine_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dt = T.Dataset.build(TD.DATASETS["sp2b"](scale=0.02, seed=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Engine(dt)                        # EngineConfig().device: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.engine("rdf_h")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Engine(dt, T.EngineConfig(device="cuda:0"))


# (dataset, query seeds): the random graphs and queries of
# tests/test_stats_planner.py::test_bloom_prefilter_engine_equality, and
# lubm/dblp with exact keywords, where the prefilter has work to do
BLOOM_GRID = [("random", 0), ("random", 1), ("random", 2),
              ("lubm", 100), ("dblp", 100)]


def _bloom_pair(name, seed):
    """(reference engine, port engine, [(query, query)]) with bloom on."""
    if name == "random":
        kw = dict(n_nodes=50, n_edges=150, n_preds=3, n_literals=15,
                  seed=seed)
        gj, gt = JD.random_graph(**kw), TD.random_graph(**kw)
        seeds, size = (seed * 5 + 2,), 4
    else:
        gj = JD.DATASETS[name](scale=0.05, seed=1)
        gt = TD.DATASETS[name](scale=0.05, seed=1)
        seeds, size = range(seed, seed + 4), 6
    ej = J.Dataset.build(gj).engine("spath_ni2")
    ej.cfg.use_bloom = True
    et = T.Dataset.build(gt).engine("spath_ni2", device="cpu")
    et.cfg.use_bloom = True
    qs = [(JD.random_query(gj, size=size, seed=s, exact_nodes=0.5),
           TD.random_query(gt, size=size, seed=s, exact_nodes=0.5))
          for s in seeds]
    return ej, et, qs


@pytest.mark.parametrize("name,seed", BLOOM_GRID)
def test_bloom_engine_matches_reference(name, seed, monkeypatch):
    """SPath(NI2) with the bloom prefilter: the reference's result sets,
    candidates_after and to_dict() keys, cold and warm; and the prefilter
    really rejects candidates here."""
    ej, et, qs = _bloom_pair(name, seed)
    removed = []
    prefilter = tengine.bloom_prefilter

    def counting(*a, **kw):
        ok = prefilter(*a, **kw)
        removed.append(int((~ok).sum()))
        return ok
    monkeypatch.setattr(tengine, "bloom_prefilter", counting)
    for qj, qt in qs:
        pj, pt = ej.prepare(qj), et.prepare(qt)
        for _ in ("cold", "warm"):
            _same_run(ej.execute_prepared(pj), et.execute_prepared(pt))
    assert sum(removed) > 0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_cli_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import query as cli
    monkeypatch.setattr("sys.argv", ["query", "--dataset", "sp2b",
                                     "--scale", "0.02", "--queries", "2",
                                     "--device", "cpu"])
    cli.main()
    out = capsys.readouterr().out
    assert "qps" in out and "matches=" in out
