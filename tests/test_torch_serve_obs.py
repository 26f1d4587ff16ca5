"""Metrics, EXPLAIN and per-query tracing of the port's server against the
reference (twin of the metrics, serving and EXPLAIN parts of
``tests/test_obs.py``).

The metrics registry and the EXPLAIN renderer are stdlib copies; the twin
feeds both the same observations and the same request streams and holds
equal the registry snapshots, the server's counters and gauges, the span
names of every query's trace (less the port's own spans and attrs,
``torch_twin.PORT_ONLY_TRACE``), the rung histories of typed errors, and
the EXPLAIN text with its ``prepare_time`` masked.
"""
import json

import pytest

from torch_twin import (PORT, REF, chrome_events, forcing_cfg,
                        mask_explain, outcomes, per_stack, telemetry_view,
                        trace_spans, twin)


@per_stack
def fx(S):
    g = S.graph(n_nodes=80, n_edges=220, n_preds=3, n_literals=20, seed=1)
    return g, S.pool(g, 40)


# ------------------------------ metrics -------------------------------- #
def test_metrics_counter_gauge_histogram_basics():
    def scenario(S):
        m = S.obs.MetricsRegistry()
        m.counter("c").inc()
        m.counter("c").inc(3)
        m.gauge("g").set(2.5)
        h = m.histogram("h")
        for v in (1.0, 2.0, 4.0, 0.0):
            h.observe(v)
        assert m.counter("c").value == 4 and m.gauge("g").value == 2.5
        assert (h.count, h.sum, h.min, h.max, h.zeros) == (4, 7.0, 0.0,
                                                           4.0, 1)
        return m.snapshot()
    twin(scenario)


def test_histogram_percentile_within_bucket_resolution():
    def scenario(S):
        h = S.metrics.Histogram()
        vals = [0.001 * (1 + i) for i in range(1000)]
        for v in vals:
            h.observe(v)
        base = S.metrics.HISTOGRAM_BASE
        out = []
        for q in (50, 90, 99, 100):
            est = h.percentile(q)
            if q < 100:
                exact = vals[int(len(vals) * q / 100) - 1]
                assert exact / base <= est <= exact * base
            out.append(est)
        assert S.metrics.Histogram().percentile(99) == 0.0
        return out, h.snapshot(), base
    twin(scenario)


def test_metrics_snapshot_schema_and_conflicts():
    def scenario(S):
        m = S.obs.MetricsRegistry()
        m.counter("a").inc()
        m.gauge("b").set(1.0)
        m.histogram("c").observe(0.5)
        snap = m.snapshot()
        assert sorted(snap["histograms"]["c"]) == \
            sorted(S.obs.HISTOGRAM_FIELDS)
        json.dumps(snap)
        x = S.obs.MetricsRegistry()
        x.counter("x")
        for kind in ("histogram", "gauge"):
            with pytest.raises(ValueError):
                getattr(x, kind)("x")
        return snap, S.obs.HISTOGRAM_FIELDS
    twin(scenario)


# --------------------------- serving e2e ------------------------------- #
def test_traced_and_untraced_servers_agree():
    def scenario(S):
        g, pool = fx(S)
        srv_a = S.server(g)
        srv_b = S.server(g, tracer=S.obs.Tracer())
        out = []
        for q in pool:
            a, b = srv_a.query(q), srv_b.query(q)
            assert a.result_set() == b.result_set()
            out.append(a.result_set())
        assert len(srv_b.tracer.finished) == len(pool)
        assert len(S.obs.NULL_TRACER.finished) == 0
        return out, [trace_spans(t) for t in srv_b.tracer.finished]
    twin(scenario)


def test_end_to_end_chaos_trace_export(tmp_path):
    def scenario(S):
        g, pool = fx(S)
        tr = S.obs.Tracer()
        srv = S.server(g, cfg=forcing_cfg(S), tracer=tr,
                       governor=S.serve.GovernorConfig())
        stream = pool * 2
        with S.testing.FaultInjector(
                S.testing.Fault("kernel_dispatch", "raise", every=1)):
            futs = srv.submit_many(stream, wait=True)
        got = outcomes(futs)
        assert any(o[0] == "ok" and o[2] for o in got)
        path = tmp_path / f"{S.name}.json"
        info = tr.export_chrome(path)
        doc = json.loads(path.read_text())
        assert info["events"] == len(doc["traceEvents"])
        events = chrome_events(doc)
        by_trace: dict = {}
        for ev in events:
            if ev["ph"] == "X":
                by_trace.setdefault(ev["args"]["trace_id"], []).append(
                    (ev["name"], sorted(ev["args"])))
        names = {n for evs in by_trace.values() for n, _ in evs}
        assert {"breaker", "ladder", "rung", "join"} <= names
        return (got, info["traces"], len(events),
                [f.trace_id for f in futs], by_trace)
    twin(scenario)


def test_serving_errors_carry_trace_id_and_rung_history():
    def scenario(S):
        g, pool = fx(S)
        tr = S.obs.Tracer()
        srv = S.server(g, cfg=forcing_cfg(S), tracer=tr,
                       governor=S.serve.GovernorConfig(max_rows=0))
        f = srv.submit(pool[0])
        srv.flush()
        with pytest.raises(S.serve.DegradationExhausted) as ei:
            f.result()
        exc = ei.value
        assert exc.trace_id == f.trace_id
        assert f"[trace {f.trace_id}]" in str(exc)
        rungs = [s for s in tr.get(f.trace_id).spans if s.name == "rung"]
        assert rungs and all(s.attrs.get("outcome") == "failed"
                             for s in rungs)
        history = [line.split(" after ")[0]
                   for line in exc.attempt_history.splitlines()]
        return (exc.trace_id, history,
                [sorted(s.attrs) for s in rungs], outcomes([f]))
    twin(scenario)


def test_telemetry_metrics_match():
    def scenario(S):
        g, pool = fx(S)
        srv = S.server(g, governor=S.serve.GovernorConfig())
        for f in srv.submit_many(pool * 2, wait=True):
            f.result()
        t = srv.telemetry()
        assert t["latency"]["n_cold"] + t["latency"]["n_warm"] == 8
        assert t["metrics"]["counters"]["queries_served"] == 8
        json.dumps(t["metrics"])
        return sorted(t["latency"]), telemetry_view(srv)["metrics"]
    twin(scenario)


def test_slow_query_log_captures_explain():
    def scenario(S):
        g, pool = fx(S)
        srv = S.server(g, slow_query_s=0.0, slow_log_max=3)
        for f in srv.submit_many(pool, wait=True):
            f.result()
        log = srv.slow_queries()
        assert len(log) == 3
        assert srv.telemetry()["metrics"]["counters"]["slow_queries"] == 4
        return [(sorted(e), e["fingerprint"], e["warm"], e["trace_id"],
                 mask_explain(e["explain"])) for e in log]
    twin(scenario)


# ------------------------------ EXPLAIN -------------------------------- #
def test_explain_golden_three_join_template():
    def scenario(S):
        g, _ = fx(S)
        q = S.query(g, size=4, seed=41, n_connection=0)
        srv = S.server(g, calibrate=False)
        cold = srv.explain(q)
        assert "(unlearned — cold execution pending" in cold
        srv.query(q)
        text = mask_explain(srv.explain(q))
        for section in ("candidates (IDMap intervals):",
                        "check decision (§4.3):", "components: ",
                        "join order (Selinger DP over per-tree tables):",
                        "connection edges:", "learned join sequence",
                        "=> use_check", "impl=", "est=", "rows="):
            assert section in text
        return mask_explain(cold), text
    twin(scenario)


def test_explain_matches_on_every_pool_template_and_policy():
    def scenario(S):
        g, pool = fx(S)
        out = []
        for policy in ("selective", "always", "never"):
            srv = S.server(g, cfg=S.cfg(check_policy=policy, d_check=2),
                           calibrate=False)
            for q in pool:
                srv.query(q)
                out.append(mask_explain(srv.explain(q)))
        return out
    twin(scenario)


def test_explain_renders_without_thresholds_or_decision():
    def scenario(S):
        g, _ = fx(S)
        q = S.query(g, size=3, seed=42, n_connection=0)
        pq = S.engine(g).prepare(q)
        text = S.obs.render_explain(pq)
        assert "est_iterations=" in text
        srv = S.server(g, cfg=S.cfg(check_policy="never", d_check=2))
        forced = srv.explain(q)
        assert "forced by check_policy" in forced
        return mask_explain(text), mask_explain(forced)
    twin(scenario)


def test_port_obs_exports_match_reference():
    assert sorted(PORT.obs.__all__) == sorted(REF.obs.__all__)
    assert sorted(PORT.serve.__all__) == sorted(REF.serve.__all__)
    assert sorted(PORT.testing.__all__) == sorted(REF.testing.__all__)
