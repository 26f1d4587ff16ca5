"""Warm-restart snapshots, the result cache and dataset deltas of the port's
server, against the reference (twin of ``tests/test_snapshot.py`` and
``tests/test_result_cache.py``).

Both stacks write and restore their own snapshots (the port has its own
magic and format version) and serve the same stream; the twin holds equal
the restored plans' replays, every typed ``SnapshotError`` reason, the
result-cache hits and the delta migration counts.  A snapshot written by
the reference is refused by the port before anything is unpickled.
"""
import hashlib
import os
import pickle
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_twin import (PORT, REF, per_stack, run_stats, telemetry_view,
                        twin)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLD_PATH = ("plan_table_joins", "plan_connections", "decide",
             "connection_selectivity", "endpoint_reach",
             "choose_connection_impl")


@per_stack
def fx(S):
    g = S.graph(n_nodes=80, n_edges=220, n_preds=3, n_literals=20, seed=7)
    pool = S.pool(g, 60)
    eng = S.engine(g)
    return g, pool, [eng.execute(q).result_set() for q in pool]


def _server(S, data=None, **kw):
    kw.setdefault("governor", S.serve.GovernorConfig())
    return S.server(fx(S)[0] if data is None else data, **kw)


def _warm_server(S):
    srv = _server(S)
    for _ in range(2):
        for q in fx(S)[1]:
            srv.query(q)
    return srv


def _canon_rows(res):
    order = np.argsort(res.cols)
    rows = np.asarray(res.rows)[:, order]
    if rows.shape[0] > 1:
        rows = rows[np.lexsort(rows.T[::-1])]
    return rows


def _poison(S, m, srv):
    def _boom(*a, **k):
        raise AssertionError("cold path re-entered after restore")
    for fn in (*COLD_PATH, S.check):
        m.setattr(S.engine_mod, fn, _boom)
    m.setattr(srv.engine, "prepare", _boom)


# --------------------------- happy path -------------------------------- #
def test_roundtrip_restores_warm_path_byte_identical(tmp_path, monkeypatch):
    def scenario(S):
        _, pool, oracle = fx(S)
        srv = _warm_server(S)
        before = [srv.query(q) for q in pool]
        path = tmp_path / f"{S.name}.snap"
        manifest = srv.save_snapshot(path)
        assert manifest["format_version"] == S.snapshot.FORMAT_VERSION
        srv2 = _server(S)
        srv2.restore_snapshot(path)
        out = []
        with monkeypatch.context() as m:
            _poison(S, m, srv2)
            for q, b, want in zip(pool, before, oracle):
                res = srv2.query(q)
                assert res.stats.cache_hit and res.stats.join_retries == 0
                assert res.result_set() == want and res.cols == b.cols
                assert np.array_equal(_canon_rows(res), _canon_rows(b))
                out.append((_canon_rows(res).tolist(), res.cols,
                            run_stats(res)))
        t = telemetry_view(srv2)
        assert t["plan_cache"]["misses"] == 0
        assert t["governor"]["snapshot"]["action"] == "restored"
        return manifest["plans"], out, t["plan_cache"]
    twin(scenario)


def test_roundtrip_with_signature_masks(tmp_path, monkeypatch):
    def scenario(S):
        g = fx(S)[0]
        cfg = S.cfg(check_policy="always", d_check=2)
        q = S.query(g, size=4, seed=64, n_connection=0)
        srv = S.server(g, cfg=cfg, governor=S.serve.GovernorConfig())
        cold = srv.query(q)
        srv.query(q)
        path = tmp_path / f"{S.name}-masks.snap"
        srv.save_snapshot(path)
        srv2 = S.server(g, cfg=cfg, governor=S.serve.GovernorConfig())
        srv2.restore_snapshot(path)
        calls = []
        with monkeypatch.context() as m:
            m.setattr(S.engine_mod, S.check,
                      lambda *a, **k: calls.append(1))
            res = srv2.query(q)
        assert res.stats.cache_hit and not calls
        assert res.result_set() == cold.result_set()
        assert res.stats.used_check
        assert res.stats.candidates_after == cold.stats.candidates_after
        return res.result_set(), run_stats(res)
    twin(scenario)


def test_port_restore_replays_with_zero_check_work(tmp_path, monkeypatch):
    """A snapshot written and restored by the port replays its masks from
    host form: no neighborhood check runs (no interval_check call), and
    candidates_after is the pre-restart value."""
    from repro_torch.kernels import ops
    g = fx(PORT)[0]
    cfg = PORT.cfg(check_policy="always", d_check=2)
    q = PORT.query(g, size=4, seed=64, n_connection=0)
    srv = PORT.server(g, cfg=cfg)
    cold = srv.query(q)
    warm = srv.query(q)
    assert cold.stats.used_check and cold.stats.candidates_after < \
        cold.stats.candidates_before
    path = tmp_path / "port.snap"
    srv.save_snapshot(path)
    srv2 = PORT.server(g, cfg=cfg)
    srv2.restore_snapshot(path)
    checks = []
    real = ops.interval_check
    monkeypatch.setattr(ops, "interval_check",
                        lambda *a, **k: checks.append(1) or real(*a, **k))
    res = srv2.query(q)
    assert not checks
    assert res.stats.candidates_after == warm.stats.candidates_after
    assert res.result_set() == cold.result_set()
    pq = next(pq for _, pq in srv2.plan_cache.entries())
    assert all(m is None or isinstance(m, np.ndarray)
               for m in pq.masks[1].values())


def test_restore_preserves_learned_state(tmp_path):
    def scenario(S):
        _, pool, _ = fx(S)
        srv = _warm_server(S)
        srv.calibrator.cost_model.join_est_scale = 0.37
        srv.calibrator.thresholds.tau_sel = 2.5
        srv.calibrator.version += 3
        gov = srv.governor
        gov.breaker.record("bad-fp", ok=False, now=0.0)
        gov.breaker.record("bad-fp", ok=False, now=0.0)
        gov.rung_memory.record_degraded("deg-fp", "greedy_plan", now=0.0)
        path = tmp_path / f"{S.name}-state.snap"
        srv.save_snapshot(path)
        srv2 = _server(S)
        srv2.restore_snapshot(path)
        fp = S.serve.template_fingerprint(pool[0])
        pq = srv2.plan_cache.get(srv2.dataset_id, fp)
        assert pq is not None and pq.warm and pq.join_seq
        assert pq.version == 0 != srv2._version()
        return (srv2.calibrator.snapshot(),
                srv2.governor.rung_memory.rung("deg-fp"),
                srv2.governor.breaker._st["bad-fp"]["failures"],
                pq.join_seq, pq.conn_impls, pq.comp_orders)
    twin(scenario)


# ------------------------- typed failure modes ------------------------- #
def _damage(S, path, how):
    raw = bytearray(path.read_bytes())
    magic, version = S.snapshot.MAGIC, S.snapshot.FORMAT_VERSION
    if how == "truncated":
        raw = raw[:20]
    elif how == "magic":
        raw[:len(magic)] = b"NOTASNAP"
    elif how == "format_version":
        raw[len(magic):len(magic) + 4] = struct.pack("<I", version + 1)
    elif how == "checksum":
        raw[-10] ^= 0xFF
    elif how == "undecodable":
        payload = b"\x80\x04 this is not a valid pickle stream"
        raw = bytearray(magic + struct.pack("<I", version)
                        + hashlib.sha256(payload).digest() + payload)
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("how", ["io", "truncated", "magic",
                                 "format_version", "checksum",
                                 "undecodable", "dataset", "stale"])
def test_damaged_snapshot_raises_typed_and_cold_starts(how, tmp_path):
    def scenario(S):
        _, pool, oracle = fx(S)
        path = tmp_path / f"{S.name}-{how}.snap"
        kw = {}
        if how == "dataset":
            other = S.graph(n_nodes=80, n_edges=220, n_preds=3,
                            n_literals=20, seed=99)
            srv_o = _server(S, other)
            srv_o.query(S.query(other, size=3, seed=61))
            srv_o.save_snapshot(path)
        elif how != "io":
            _warm_server(S).save_snapshot(path)
            if how == "stale":
                time.sleep(0.05)
                kw["max_age_s"] = 0.01
            else:
                _damage(S, path, how)
        srv = _server(S)
        with pytest.raises(S.serve.SnapshotError) as ei:
            srv.restore_snapshot(path, **kw)
        assert len(srv.plan_cache) == 0
        got = [srv.query(q).result_set() for q in pool]
        assert got == oracle
        return ei.value.reason, got, telemetry_view(srv)["plan_cache"]
    assert twin(scenario)[0] == how


def test_stale_snapshot_within_budget_and_atomic_save(tmp_path):
    def scenario(S):
        d = tmp_path / S.name
        d.mkdir()
        srv = _warm_server(S)
        srv.save_snapshot(d / "a.snap")
        srv.save_snapshot(d / "a.snap")
        assert sorted(os.listdir(d)) == ["a.snap"]
        srv2 = _server(S)
        m = srv2.restore_snapshot(d / "a.snap", max_age_s=3600.0)
        return m["plans"], len(srv2.plan_cache)
    twin(scenario)


def test_restore_pre_observability_payload(tmp_path):
    def scenario(S):
        _, pool, oracle = fx(S)
        path = tmp_path / f"{S.name}-old.snap"
        _warm_server(S).save_snapshot(path)
        magic = S.snapshot.MAGIC
        hdr = len(magic) + 4 + hashlib.sha256().digest_size
        data = pickle.loads(path.read_bytes()[hdr:])
        for _, blob in data["plans"]:
            del blob["join_est_seq"]
        payload = pickle.dumps(data, protocol=4)
        path.write_bytes(magic + struct.pack("<I", S.snapshot.FORMAT_VERSION)
                         + hashlib.sha256(payload).digest() + payload)
        srv2 = _server(S)
        assert srv2.restore_snapshot(path)["plans"] == len(pool)
        out = []
        for q, want in zip(pool, oracle):
            res = srv2.query(q)
            assert res.stats.cache_hit and res.result_set() == want
            out.append(run_stats(res))
        assert all(pq.join_est_seq == [] for _, pq in
                   srv2.plan_cache.entries())
        return out
    twin(scenario)


def test_reference_snapshot_refused_before_unpickling(tmp_path):
    """The port reads only its own format: the reference's file (magic
    b"REPROSNP") is refused on its magic, in a process that has imported
    neither repro nor jax and still has not afterwards."""
    assert PORT.snapshot.MAGIC != REF.snapshot.MAGIC
    assert len(PORT.snapshot.MAGIC) == len(REF.snapshot.MAGIC)
    path = tmp_path / "reference.snap"
    srv = _warm_server(REF)
    srv.save_snapshot(path)
    g = fx(PORT)[0]
    with pytest.raises(PORT.serve.SnapshotError) as ei:
        _server(PORT, g).restore_snapshot(path)
    assert ei.value.reason == "magic"
    code = f"""
import sys
import repro_torch.data as TD
from repro_torch.serve import QueryServer, SnapshotError
g = TD.random_graph(n_nodes=80, n_edges=220, n_preds=3, n_literals=20,
                    seed=7)
srv = QueryServer(g, device="cpu")
try:
    srv.restore_snapshot({str(path)!r})
except SnapshotError as e:
    print("refused", e.reason)
print("imported", sorted(m for m in sys.modules
                         if m.split(".")[0] in ("repro", "jax", "jaxlib")))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "refused magic" in out.stdout
    assert "imported []" in out.stdout


# ------------------------------ result cache ---------------------------- #
@per_stack
def ds_fx(S):
    g = S.graph(n_nodes=150, n_edges=450, n_preds=5, n_literals=25, seed=3)
    return S.core.Dataset.build(g, variant="rdf_h")


def _rc_server(S, ds, **kw):
    kw.setdefault("result_cache_size", 32)
    kw.setdefault("calibrate", False)
    return S.server(ds, **kw)


def _recombine_delta(ds, rng, n_ins=4, n_del=4):
    g = ds.graph
    lab, prd = g.labels, g.predicates
    subj = np.bincount(g.src, minlength=g.num_nodes)
    ment = subj + np.bincount(g.dst, minlength=g.num_nodes)
    safe = np.flatnonzero((subj[g.src] >= 2) & (ment[g.src] >= 3)
                          & (ment[g.dst] >= 3))
    dels = rng.choice(safe, size=min(n_del, safe.size), replace=False)
    deletes = [(lab[g.src[i]], prd[g.pred[i]], lab[g.dst[i]]) for i in dels]
    picks = rng.choice(g.num_edges, size=2 * n_ins, replace=False)
    inserts = [(lab[g.src[i]], prd[g.pred[i]], lab[g.dst[j]])
               for i, j in zip(picks, np.roll(picks, 1))
               if g.pred[i] == g.pred[j]]
    return inserts, deletes


def _poison_execution(m, srv):
    def _boom(*a, **k):
        raise AssertionError("engine execution re-entered on a repeat")
    m.setattr(srv.engine, "execute_prepared", _boom)


def test_result_cache_units():
    def scenario(S):
        rc = S.serve.ResultCache(max_entries=2, max_bytes=10_000)
        rows = np.zeros((100, 3), dtype=np.int32)
        iv = [(0, 10), (20, 30), (40, 50)]
        for k in "abc":
            rc.put("ds:v0", k, (0, 1, 2), rows, False, iv)
        assert rc.get("ds:v0", "a") is None
        cols, got = rc.get("ds:v0", "b")
        big = S.serve.ResultCache(max_entries=8, max_bytes=100)
        big.put("ds:v0", "big", (0,), rows, False, iv)
        mig = S.serve.ResultCache(max_entries=8)
        small = np.zeros((4, 2), dtype=np.int32)
        mig.put("d:v0", "clean", (0, 1), small, False, [(0, 5)])
        mig.put("d:v0", "hit", (0, 1), small, False, [(10, 20)])
        mig.put("d:v0", "conn", (0, 1), small, True, [(0, 5)])
        kept = mig.migrate("d:v0", "d:v1", np.array([12, 40], np.int64))
        survivors = [k for k in ("clean", "hit", "conn")
                     if mig.get("d:v1", k) is not None]
        mig.put("d:v1", "x", (0, 1), small, False, [(0, 5)])
        rebuilt = mig.migrate("d:v1", "d:v2", None)
        return (rc.snapshot(), cols, got.tolist(), big.snapshot(), kept,
                survivors, rebuilt, mig.snapshot())
    twin(scenario)


def test_repeat_served_without_execution(monkeypatch):
    def scenario(S):
        ds = ds_fx(S)
        srv = _rc_server(S, ds)
        q = S.query(ds.graph, size=4, seed=11)
        first = srv.query(q)
        with monkeypatch.context() as m:
            _poison_execution(m, srv)
            again = srv.query(q)
        assert again.stats.result_cache_hit and again.stats.cache_hit
        assert again.cols == first.cols
        np.testing.assert_array_equal(again.rows, first.rows)
        t = telemetry_view(srv)
        assert t["metrics"]["counters"]["result_cache_hits"] == 1
        return np.asarray(again.rows).tolist(), again.cols, t
    twin(scenario)


def test_isomorphic_renumbering_hits_and_remaps(monkeypatch):
    def scenario(S):
        ds = ds_fx(S)
        q = S.query(ds.graph, size=4, seed=21)
        perm = [2, 0, 3, 1][:q.num_nodes]
        perm += list(range(len(perm), q.num_nodes))
        inv = {orig: new for new, orig in enumerate(perm)}
        q2 = S.qmod.QueryTemplate(
            keywords=[q.keywords[perm[i]] for i in range(q.num_nodes)],
            edges=[S.qmod.QueryEdge(inv[e.src], inv[e.dst], e.pred)
                   for e in q.edges],
            connections=list(q.connections))
        want = S.engine(ds).execute(q2).result_set()
        srv = _rc_server(S, ds)
        srv.query(q)
        with monkeypatch.context() as m:
            _poison_execution(m, srv)
            r2 = srv.query(q2)
        assert r2.stats.result_cache_hit and r2.result_set() == want
        return r2.result_set(), r2.cols
    twin(scenario)


def test_result_cache_off_by_default():
    def scenario(S):
        ds = ds_fx(S)
        srv = S.server(ds, calibrate=False)
        q = S.query(ds.graph, size=4, seed=11)
        srv.query(q)
        r = srv.query(q)
        assert srv.result_cache is None and not r.stats.result_cache_hit
        return telemetry_view(srv)
    twin(scenario)


# ----------------------- delta migration -------------------------------- #
def test_delta_invalidates_and_repeat_is_correct():
    def scenario(S):
        ds = ds_fx(S)
        srv = _rc_server(S, ds)
        q = S.query(ds.graph, size=4, seed=31)
        srv.query(q)
        info = srv.apply_delta(*_recombine_delta(ds,
                                                 np.random.default_rng(5)))
        assert info["mode"] == "incremental" and srv.dataset.version == 1
        want = S.engine(srv.dataset).execute(q).result_set()
        r1, r2 = srv.query(q), srv.query(q)
        assert r1.result_set() == want == r2.result_set()
        assert r2.stats.result_cache_hit
        info.pop("dataset_id")
        return info, want, telemetry_view(srv)
    twin(scenario)


def test_footprint_clean_entry_survives_delta(monkeypatch):
    def scenario(S):
        g = S.graph(n_nodes=800, n_edges=1600, n_preds=6, n_literals=40,
                    seed=7)
        ds = S.core.Dataset.build(g, variant="rdf_h")
        srv = _rc_server(S, ds)
        q = S.query(g, size=4, seed=31, exact_nodes=True)
        qc = S.query(g, size=4, seed=32, n_connection=1, d_c=2)
        srv.query(q)
        srv.query(qc)
        _, _, fp = S.serve.canonicalize(q)
        pq = srv.plan_cache.peek(srv.dataset_id, fp)
        iv = [(int(lo), int(hi)) for lo, hi in pq.iv]
        subj = np.bincount(g.src, minlength=g.num_nodes)
        ment = subj + np.bincount(g.dst, minlength=g.num_nodes)
        safe = np.flatnonzero((subj[g.src] >= 2) & (ment[g.src] >= 3)
                              & (ment[g.dst] >= 3))
        chosen = None
        for i in safe:
            d = [(g.labels[g.src[i]], g.predicates[g.pred[i]],
                  g.labels[g.dst[i]])]
            trial = ds.apply_delta(deletes=d)
            if trial.delta_info["mode"] == "incremental" and not \
                    S.core.interval_footprint_hit(iv, trial.touched):
                chosen = d
                break
        assert chosen is not None
        info = srv.apply_delta(deletes=chosen)
        assert info["results_kept"] >= 1
        with monkeypatch.context() as m:
            _poison_execution(m, srv)
            r = srv.query(q)
            assert r.stats.result_cache_hit
            with pytest.raises(Exception):
                srv.query(qc)
        info.pop("dataset_id")
        return chosen, info, r.result_set()
    twin(scenario)


def test_plans_revalidated_not_reprepared_after_delta(monkeypatch):
    def scenario(S):
        ds = ds_fx(S)
        srv = S.server(ds, calibrate=False)
        pool = [S.query(ds.graph, size=4, seed=41 + i) for i in range(3)]
        for q in pool:
            srv.query(q)
        misses0 = srv.plan_cache.snapshot()["misses"]
        info = srv.apply_delta(*_recombine_delta(ds,
                                                 np.random.default_rng(9)))
        oracle = S.engine(srv.dataset)
        want = [oracle.execute(q).result_set() for q in pool]
        with monkeypatch.context() as m:
            m.setattr(srv.engine, "prepare", lambda *a, **k: (_ for _ in (
                )).throw(AssertionError("prepare re-entered")))
            got = [srv.query(q) for q in pool]
        assert [r.result_set() for r in got] == want
        t = srv.plan_cache.snapshot()
        assert t["misses"] == misses0
        info.pop("dataset_id")
        return info, want, [run_stats(r) for r in got], t
    twin(scenario)


def test_delta_keeps_untouched_device_tensors():
    """The port's engine migration keeps the device tensors of every NI
    entry the incremental delta left untouched, and drops the edge
    tensors of the old graph."""
    ds = ds_fx(PORT)
    srv = _rc_server(PORT, ds)
    eng0 = srv.engine
    for seed in (31, 32):
        srv.query(PORT.query(ds.graph, size=4, seed=seed, n_connection=1))
    srv.apply_delta(*_recombine_delta(ds, np.random.default_rng(5)))
    new, old = srv.engine._dev_cache, eng0._dev_cache
    assert "edges" in old and "edges" not in new
    for key in new:
        e = 1 if key == "bloom" else key[0] * key[1]
        assert srv.dataset.ni.entries[e] is ds.ni.entries[e]
        assert new[key] is old[key]
    assert srv.engine.device == eng0.device


def test_rebuild_delta_drops_all_plans_and_results():
    def scenario(S):
        ds = ds_fx(S)
        srv = _rc_server(S, ds)
        q = S.query(ds.graph, size=4, seed=51)
        srv.query(q)
        info = srv.apply_delta(inserts=[("Zz/brand-new-node",
                                         ds.graph.predicates[0],
                                         ds.graph.labels[0])])
        assert info["mode"] == "rebuild" and info["plans_kept"] == 0
        want = S.engine(srv.dataset).execute(q).result_set()
        assert srv.query(q).result_set() == want
        info.pop("dataset_id")
        return info, want
    twin(scenario)


def test_snapshot_rejects_version_mismatch(tmp_path):
    def scenario(S):
        ds = ds_fx(S)
        srv = _rc_server(S, ds)
        srv.query(S.query(ds.graph, size=4, seed=61))
        path = tmp_path / f"{S.name}-v0.snap"
        manifest = srv.save_snapshot(path)
        srv.apply_delta(*_recombine_delta(ds, np.random.default_rng(13)))
        with pytest.raises(S.serve.SnapshotError) as ei:
            srv.restore_snapshot(path)
        srv2 = _rc_server(S, ds)
        srv2.restore_snapshot(path)
        return (manifest["dataset_version"], ei.value.reason,
                srv2.plan_cache.snapshot()["entries"])
    assert twin(scenario)[1] == "version"
