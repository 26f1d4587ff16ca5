"""The port's own tracing, on the CPU: spans on ``torch.profiler``'s clock,
the span of the answer's copy to the host (``copy_out``), and the count of
the engine's device reads (``obs.trace.to_host``) on the ``execute``
segment.  The reference has none of these, so no twin holds them."""
import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import Dataset
from repro_torch.core import connectivity, engine, matching, signature
from repro_torch.data import random_graph, random_query
from repro_torch.obs import NULL_SPAN, NULL_TRACER, NullTracer, Tracer
from repro_torch.obs import trace as trace_mod
from repro_torch.serve import QueryServer

SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
# the modules of the engine's execute path, whose device reads must go
# through to_host
EXECUTE_PATH = ([SRC / "core" / f"{m}.py" for m in
                 ("engine", "matching", "connectivity", "signature")]
                + sorted((SRC / "kernels").glob("*.py")))
READERS = (engine, matching, connectivity, signature)


@pytest.fixture(scope="module")
def data():
    g = random_graph(n_nodes=80, n_edges=220, n_preds=3, n_literals=20,
                     seed=1)
    pool = [random_query(g, size=4, seed=40 + i, n_connection=i % 2, d_c=2)
            for i in range(4)]
    return Dataset.build(g, "rdf_h"), pool


def server(ds, **kw):
    return QueryServer(ds, "rdf_h", impl="ref", device="cpu", **kw)


def test_span_holds_a_profiled_op_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(256, 256)
    tr = Tracer()
    tid = tr.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.segment("execute", tid):
            with tr.span("op") as sp:
                time.sleep(0.002)
                x @ x
                time.sleep(0.002)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    start = mm[0].start_ns()
    assert sp.start_ns < start
    assert start + mm[0].duration_ns() < sp.end_ns
    assert 0.004 <= sp.duration_s < 1.0


def test_chrome_export_writes_microseconds_on_the_epoch_base(tmp_path):
    tr = Tracer()
    tid = tr.start()
    before = time.time_ns()
    with tr.segment("execute", tid) as seg:
        with tr.span("join"):
            time.sleep(0.001)
    after = time.time_ns()
    tr.finish(tid)
    doc = json.loads(Path(tr.export_chrome(tmp_path / "t.json")["path"])
                     .read_text())
    spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert [ev["name"] for ev in spans] == ["execute", "join"]
    assert all(before / 1e3 <= ev["ts"] <= ev["ts"] + ev["dur"]
               <= after / 1e3 for ev in spans)
    assert spans[0]["ts"] == seg.start_ns / 1e3
    assert spans[1]["dur"] >= 1e3


def test_copy_out_once_per_execution_with_the_answers_bytes(data):
    ds, pool = data
    srv = server(ds, tracer=Tracer())
    futs = srv.submit_many(pool * 2, wait=True)
    executed = 0
    for f in futs:
        res = f.result()
        spans = srv.tracer.get(f.trace_id).spans
        segs = [s for s in spans if s.name == "execute"]
        outs = [s for s in spans if s.name == "copy_out"]
        assert len(outs) == len(segs) <= 1
        if not segs:
            continue
        executed += 1
        out, = outs
        top = out
        while top.parent is not None:
            top = top.parent
        assert top is segs[0]
        assert segs[0].start_ns <= out.start_ns <= out.end_ns \
            <= segs[0].end_ns
        assert out.attrs == {"rows": res.count,
                             "bytes": res.count * len(res.cols) * 4}
    assert executed >= len(pool)


def test_host_syncs_count_every_read_of_the_execute_path(data, monkeypatch):
    ds, pool = data
    calls: dict = {}
    real = trace_mod.to_host

    def counting(t, counted=True):
        seg = trace_mod._execute
        if counted and seg is not None:
            calls[id(seg)] = calls.get(id(seg), 0) + 1
        return real(t, counted)

    for mod in READERS:
        monkeypatch.setattr(mod, "to_host", counting)
    srv = server(ds, tracer=Tracer())
    for f in srv.submit_many(pool * 2, wait=True):
        f.result()
    segs = [s for tr in srv.tracer.finished for s in tr.spans
            if s.name == "execute"]
    assert segs and sum(calls.values()) > 0
    for s in segs:
        assert s.attrs.get("host_syncs", 0) == calls.get(id(s), 0)
        assert (s.attrs.get("sync_wait_ns", 0) > 0) \
            == (s.attrs.get("host_syncs", 0) > 0)
    assert trace_mod._execute is None


def test_to_host_counts_only_inside_an_execute_segment():
    t = torch.arange(6, dtype=torch.int32)
    tr = Tracer()
    tid = tr.start()
    with tr.segment("prepare", tid) as prep:
        trace_mod.to_host(t)
    with tr.segment("execute", tid) as seg:
        with tr.span("join"):
            got = trace_mod.to_host(t)
            assert int(trace_mod.to_host(t.sum())) == 15
        trace_mod.to_host(t, counted=False)
    assert np.array_equal(got, np.arange(6))
    assert "host_syncs" not in prep.attrs
    assert seg.attrs["host_syncs"] == 2
    assert isinstance(seg.attrs["sync_wait_ns"], int)
    assert trace_mod._execute is None
    trace_mod.to_host(t)
    assert seg.attrs["host_syncs"] == 2


def test_the_execute_path_reads_the_device_only_through_to_host():
    found = []
    for path in EXECUTE_PATH:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("item", "cpu", "tolist"):
                found.append(f"{path.name}:{node.lineno}")
    assert found == []
    assert all(mod.to_host is trace_mod.to_host for mod in READERS)


def test_without_a_tracer_the_new_sites_record_nothing(data):
    ds, pool = data

    class Spy(NullTracer):
        def __init__(self):
            self.opened = []

        def span(self, name, **attrs):
            sp = super().span(name, **attrs)
            self.opened.append((name, sp))
            return sp

    srv = server(ds)
    assert srv.tracer is NULL_TRACER
    spy = srv.engine.tracer = Spy()
    for q in pool:
        srv.query(q)
        assert trace_mod._execute is None
    names = [n for n, _ in spy.opened]
    assert names.count("copy_out") == len(pool)
    assert all(sp is NULL_SPAN for _, sp in spy.opened)
    assert len(NULL_TRACER.finished) == 0
