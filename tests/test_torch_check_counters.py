"""What the signature check says it did (``signature.CheckCounts``): the
candidates that entered, passed, passed with an overflowed NI row, the
stored ids of the checked rows and the host's waits, against brute-force
counts from the NI entries, on a graph with a hub past the index's
``max_cap``.  The passes come from the launches' counters in the check's
one read; the counts add nothing on a warm plan, and reach
``QueryServer.telemetry()["check"]`` and the ``check`` span."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.core import Dataset, RDFGraph, engine as engine_mod
from repro_torch.core import signature
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.signature import CheckCounts, build_requirements
from repro_torch.data import random_query
from repro_torch.obs import Tracer
from repro_torch.obs import trace as trace_mod
from repro_torch.serve import QueryServer

MAX_CAP = 8
FIELDS = ("nodes", "candidates", "passed", "overflow_passed", "ids_read",
          "syncs")


@pytest.fixture(scope="module")
def ds():
    """60 resources with random edges, and R/hub linked both ways to 30 of
    them: its rows at distances +-1 and +-2 pass ``MAX_CAP``."""
    rng = np.random.default_rng(7)
    res = [f"R/{i:03d}" for i in range(60)]
    triples = {(res[a], f"p{p}", res[b]) for a, b, p in
               zip(rng.integers(0, 60, 200), rng.integers(0, 60, 200),
                   rng.integers(0, 3, 200)) if a != b}
    triples |= {("R/hub", "p0", res[i]) for i in range(0, 60, 2)}
    triples |= {(res[i], "p1", "R/hub") for i in range(1, 60, 2)}
    triples |= {(r, "name", f"n{i % 7}") for i, r in enumerate(res)}
    g = RDFGraph.from_triples(sorted(triples))
    return Dataset.build(g, "rdf_h", max_cap=MAX_CAP)


@pytest.fixture(scope="module")
def queries(ds):
    return [random_query(ds.graph, size=4, seed=300 + i) for i in range(12)]


def make_engine(ds):
    return Engine(ds, EngineConfig(check_policy="always", impl="ref",
                                   device="cpu"))


def brute(eng, pq) -> CheckCounts:
    """The counts of one cold execution of ``pq``, from the NI entries and
    the masks it left: the segments the check reads are, per direction
    with a requirement, distances 1 up to the last that requires."""
    ni, out = eng.ni, CheckCounts()
    d_check = min(eng.cfg.d_check, ni.d_max)
    _, pass_np, _ = pq.masks
    for comp in pq.comps:
        for q in comp:
            reqs = build_requirements(pq.query, comp, q, d_check, pq.iv)
            lo, hi = int(pq.iv[q, 0]), int(pq.iv[q, 1])
            keys = []
            for sign, r in ((1, reqs.fwd), (-1, reqs.bwd)):
                if r is not None and r.need.any():
                    last = max(d + 1 for d in range(r.need.shape[0])
                               if r.need[d].any())
                    keys += [(sign, d) for d in range(1, min(d_check, last)
                                                      + 1)]
            if not keys or hi == lo:
                continue
            over = np.zeros(hi - lo, dtype=bool)
            ids = 0
            for sign, d in keys:
                e = ni.entries[sign * d]
                over |= e.overflow[lo:hi]
                ids += int(np.minimum(e.count[lo:hi], e.cap).sum())
            ok = pass_np[q][lo:hi]
            out.add(CheckCounts(1, hi - lo, int(ok.sum()),
                                int((ok & over).sum()), ids))
    # one read of the counters where a node was checked
    out.syncs = int(out.nodes > 0)
    return out


def test_the_hub_overflows_and_the_check_runs(ds, queries):
    assert all(ds.ni.entries[k].overflow.any() for k in (1, -1, 2, -2))
    eng = make_engine(ds)
    for q in queries:
        eng.execute_prepared(eng.prepare(q))
    c = eng.check_counts
    assert c.nodes > 0 and 0 < c.passed < c.candidates
    assert c.overflow_passed > 0 and c.ids_read > 0


def test_counts_equal_brute_force_counts_from_the_ni_entries(ds, queries):
    eng = make_engine(ds)
    want = CheckCounts()
    for q in queries:
        before = CheckCounts(**eng.check_counts.snapshot())
        pq = eng.prepare(q)
        eng.execute_prepared(pq)
        one = brute(eng, pq)
        got = eng.check_counts.snapshot()
        assert {k: got[k] - v for k, v in before.snapshot().items()} \
            == one.snapshot()
        want.add(one)
    assert eng.check_counts == want


def test_passed_is_the_true_count_of_the_checked_nodes_masks(ds, queries):
    eng = make_engine(ds)
    masks_true, checked = 0, 0
    for q in queries:
        pq = eng.prepare(q)
        before = eng.check_counts.nodes
        eng.execute_prepared(pq)
        _, pass_np, _ = pq.masks
        d_check = min(eng.cfg.d_check, eng.ni.d_max)
        for comp in pq.comps:
            for node in comp:
                reqs = build_requirements(pq.query, comp, node, d_check,
                                          pq.iv)
                if not reqs.empty and pq.iv[node, 1] > pq.iv[node, 0]:
                    masks_true += int(pass_np[node].sum())
                    checked += 1
        assert eng.check_counts.nodes - before <= pq.query.num_nodes
    assert eng.check_counts.passed == masks_true
    assert eng.check_counts.nodes == checked


def test_a_warm_replay_adds_nothing(ds, queries):
    eng = make_engine(ds)
    pqs = [eng.prepare(q) for q in queries]
    for pq in pqs:
        eng.execute_prepared(pq)
    cold = eng.check_counts.snapshot()
    for pq in pqs:
        assert eng.execute_prepared(pq).stats.cache_hit
    assert eng.check_counts.snapshot() == cold


def test_device_reads_are_the_same_with_and_without_counting(ds, queries,
                                                             monkeypatch):
    """Counting adds no ``to_host`` call: an execution reads the device
    as often when the check counts nothing."""
    real = trace_mod.to_host
    calls = []

    def counting(t, counted=True):
        calls.append(1)
        return real(t, counted)

    for mod in (engine_mod, signature):
        monkeypatch.setattr(mod, "to_host", counting)

    def reads(eng):
        out = []
        for q in queries:
            calls.clear()
            eng.execute_prepared(eng.prepare(q))
            out.append(len(calls))
        return out

    on = reads(make_engine(ds))
    monkeypatch.setattr(signature, "_count",
                        lambda *a: CheckCounts())
    eng = make_engine(ds)
    off = reads(eng)
    assert on == off and sum(on) > 0
    assert eng.check_counts == CheckCounts()


def test_telemetry_and_the_check_span_carry_the_counts(ds, queries):
    srv = QueryServer(ds, "rdf_h", impl="ref", device="cpu",
                      tracer=Tracer())
    srv.engine.cfg.check_policy = "always"
    t0 = srv.telemetry()["check"]
    assert t0 == dict.fromkeys(FIELDS, 0)
    for f in srv.submit_many(queries, wait=True):
        f.result()
    t1 = srv.telemetry()["check"]
    assert t1 == srv.engine.check_counts.snapshot() and t1["nodes"] > 0
    spans = [s for tr in srv.tracer.finished for s in tr.spans
             if s.name == "check"]
    assert {k: sum(s.attrs[f"check_{k}"] for s in spans)
            for k in FIELDS} == t1
    # a degraded sibling counts into the same totals; a delta keeps them
    sib = srv.engine.with_config(replace(srv.engine.cfg))
    assert sib.check_counts is srv.engine.check_counts
    srv.apply_delta(inserts=[("R/000", "p2", "R/001")])
    assert srv.telemetry()["check"] == t1


def test_syncs_one_a_cold_checked_execution_none_warm(ds, queries):
    """The check reads the device once a cold execution that checks a
    node (its counters) and never on a warm plan."""
    eng = make_engine(ds)
    pqs = [eng.prepare(q) for q in queries]
    for pq in pqs:
        before = eng.check_counts.snapshot()
        eng.execute_prepared(pq)
        got = eng.check_counts.snapshot()
        assert got["syncs"] - before["syncs"] \
            == int(got["nodes"] > before["nodes"])
    assert eng.check_counts.syncs > 0
    cold = eng.check_counts.snapshot()
    for pq in pqs:
        eng.execute_prepared(pq)
    assert eng.check_counts.snapshot() == cold


def test_the_cold_check_keeps_its_verdict_on_the_device(ds, queries,
                                                        monkeypatch):
    """On the cold path no host [N] mask is built and none uploaded: the
    check uploads its segments' words once, makes one interval_check a
    checked node, each writing a row of one [Q, N] buffer, and reads the
    [Q, 3] counters once; the host form is read only when asked for."""
    from repro_torch.kernels import ops
    eng = make_engine(ds)
    n = ds.graph.num_nodes
    uploads, launches, reads = [], [], []
    real_upload, real_check = ops.upload, ops.interval_check
    real_read = trace_mod.to_host

    def upload(words, device):
        uploads.append(len(words))
        return real_upload(words, device)

    def check(segments, lo, hi, **kw):
        launches.append(kw["out"])
        return real_check(segments, lo, hi, **kw)

    def read(t, counted=True):
        reads.append(tuple(t.shape))
        return real_read(t, counted)
    monkeypatch.setattr(ops, "upload", upload)
    monkeypatch.setattr(ops, "interval_check", check)
    monkeypatch.setattr(signature, "to_host", read)
    for q in queries:
        pq = eng.prepare(q)
        before = eng.check_counts.nodes
        uploads.clear(), launches.clear(), reads.clear()
        eng.execute_prepared(pq)
        nodes = eng.check_counts.nodes - before
        assert len(launches) == nodes
        if not nodes:
            assert not uploads and not reads
            continue
        assert len(uploads) == 1 and uploads[0] < n
        assert reads == [(nodes, 3)]
        pass_masks, host, _ = pq.masks
        rows = [m for m in pass_masks.values() if not isinstance(m, tuple)]
        assert len(rows) == nodes
        base = rows[0].untyped_storage().data_ptr()
        assert all(r.shape == (n,) and r.dtype == torch.bool
                   and r.untyped_storage().data_ptr() == base
                   for r in rows)
        assert all(any(r is row for row in rows) for r in launches)
        assert host._host == {}             # no host form read yet
