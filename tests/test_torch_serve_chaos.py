"""The port's serving stack under injected faults, against the reference
(twin of ``tests/test_chaos.py``).

``repro_torch.testing.faults`` has the reference's six injection points,
fault kinds and trigger matrix.  Each test injects the same fault into
both stacks — each through its own package's injector — on the chaos
suite's graph, pool and forcing configs, and holds equal: every future's
outcome (exact result with its ladder stamps, or the failure's type and
phase), the injector's per-point call counts and fired list, and the
governor's counters (shed, quarantined, degraded by rung, rung-memory
jumps and probes, transient retries).
"""
import dataclasses
import time

import pytest

from torch_twin import (PORT, REF, forcing_cfg, outcome, outcomes,
                        per_stack, telemetry_view, twin)

POINTS = sorted(REF.testing.INJECTION_POINTS)
KINDS = REF.faults.FAULT_KINDS
LADDER = ["primary", "skip_check", "greedy_plan", "force_simple_impls",
          "truncate"]


@per_stack
def fx(S):
    g = S.graph(n_nodes=80, n_edges=220, n_preds=3, n_literals=20, seed=1)
    pool = S.pool(g, 40)
    eng = S.engine(g)
    return g, pool, [eng.execute(q).result_set() for q in pool]


def _chaos_server(S, point="kernel_dispatch", **gov_kw):
    g, _, _ = fx(S)
    return S.server(g, cfg=forcing_cfg(S, point),
                    governor=S.serve.GovernorConfig(**gov_kw))


def _warm(srv, pool, passes=1):
    for _ in range(passes):
        for f in srv.submit_many(pool, wait=True):
            f.result()


def _exact_or_typed(S, futures, oracle):
    for i, f in enumerate(futures):
        assert f.done()
        try:
            res = f.result()
        except S.serve.ServingError as e:
            assert isinstance(e, (S.serve.QueryError,
                                  S.serve.DegradationExhausted,
                                  S.serve.QuarantinedError))
        else:
            assert res.result_set() == oracle[i]


def test_port_has_the_reference_injection_points():
    assert PORT.testing.INJECTION_POINTS.keys() == \
        REF.testing.INJECTION_POINTS.keys()
    assert PORT.faults.FAULT_KINDS == KINDS
    for point, targets in PORT.testing.INJECTION_POINTS.items():
        ref = REF.testing.INJECTION_POINTS[point]
        assert [a for _, a in targets] == [a for _, a in ref]
        assert all(m.startswith("repro_torch.") for m, _ in targets)


def test_corrupt_capacity_raises_the_ports_capacity_overflow():
    from repro_torch.kernels import ops
    fault = PORT.testing.Fault("kernel_dispatch", "corrupt_capacity")
    with PORT.testing.FaultInjector(fault) as fi:
        with pytest.raises(PORT.matching.CapacityOverflow):
            ops.merge_probe([1], [1], impl="ref")
    assert fi.fired == [("kernel_dispatch", "corrupt_capacity", 1)]


# ------------------------- per-point call counts ------------------------ #
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("point", POINTS)
def test_fault_seams_count_the_reference_calls(point, fuse):
    """Every injection point counts exactly the reference's calls for the
    same query and config, fused and staged: a fault that never triggers
    observes a cold and a warm pass of the chaos pool."""
    def scenario(S):
        g, pool, oracle = fx(S)
        cfg = dataclasses.replace(forcing_cfg(S, point), fuse_joins=fuse)
        srv = S.server(g, cfg=cfg, calibrate=False)
        counts = []
        with S.testing.FaultInjector(
                S.testing.Fault(point, "delay", at=1 << 30)) as fi:
            for _ in ("cold", "warm"):
                futs = srv.submit_many(pool, wait=True)
                assert [f.result().result_set() for f in futs] == oracle
                counts.append(dict(fi.calls))
        assert not fi.fired
        return counts
    counts = twin(scenario)
    if (point, fuse) in (("fused_probe", True), ("kernel_dispatch", False),
                         ("join_expand", False), ("radix_probe", True),
                         ("radix_probe", False), ("reach_gather", True),
                         ("cache_lookup", True)):
        assert counts[0][point] > 0      # the seam really dispatches here


@pytest.mark.parametrize("point", POINTS)
def test_fault_seams_count_the_reference_calls_default_cfg(point):
    """The same on the default engine configuration (auto joins, fused
    chain), where the fused probes must not reach kernel_dispatch."""
    def scenario(S):
        g, pool, _ = fx(S)
        srv = S.server(g, calibrate=False)
        with S.testing.FaultInjector(
                S.testing.Fault(point, "delay", at=1 << 30)) as fi:
            _warm(srv, pool, passes=2)
        return dict(fi.calls)
    twin(scenario)


# ----------------------------- the chaos grid --------------------------- #
@pytest.mark.parametrize("point", POINTS)
@pytest.mark.parametrize("kind", KINDS)
def test_chaos_grid_exact_or_typed(point, kind):
    def scenario(S):
        _, pool, oracle = fx(S)
        srv = _chaos_server(S, point)
        _warm(srv, pool)
        with S.testing.FaultInjector(
                S.testing.Fault(point, kind, at=1, delay_s=0.01)) as fi:
            futs = srv.submit_many(pool, wait=True)
            got = outcomes(futs)
        for i, f in enumerate(futs):
            assert f.result().result_set() == oracle[i]
        assert fi.fired
        t = telemetry_view(srv)
        assert t["query_errors"] == 0
        if kind == "raise":
            gov = t["governor"]
            assert gov["transient_retries"] + gov["degraded_queries"] >= 1
        return got, fi.calls, fi.fired, t["governor"]
    twin(scenario)


@pytest.mark.parametrize("point", POINTS)
def test_chaos_persistent_fault_degrades_or_fails_typed(point):
    def scenario(S):
        _, pool, oracle = fx(S)
        srv = _chaos_server(S, point)
        _warm(srv, pool)
        with S.testing.FaultInjector(
                S.testing.Fault(point, "raise", every=1)) as fi:
            futs = srv.submit_many(pool, wait=True)
            _exact_or_typed(S, futs, oracle)
            got = outcomes(futs)
        gov = telemetry_view(srv)["governor"]
        assert gov["degraded_queries"] + srv.query_errors >= 1
        return got, fi.calls, len(fi.fired), gov
    twin(scenario)


def test_chaos_degraded_steps_recorded_and_calibration_skipped():
    def scenario(S):
        _, pool, _ = fx(S)
        srv = _chaos_server(S)
        _warm(srv, pool)
        before = srv.calibrator.snapshot()
        with S.testing.FaultInjector(
                S.testing.Fault("kernel_dispatch", "raise", every=1)):
            futs = srv.submit_many(pool, wait=True)
            stepped = [f.result() for f in futs
                       if f.result().stats.degraded_steps]
        assert stepped
        assert srv.calibrator.degraded_skipped >= len(stepped)
        after = srv.calibrator.snapshot()
        for k in ("join_est_scale", "conn_sel_scale", "reach_scale"):
            assert after[k] == before[k]
        return outcomes(futs), after
    twin(scenario)


# ----------------------- budgets feed the ladder ------------------------ #
def test_budget_exceeded_walks_ladder_then_fails_typed():
    def scenario(S):
        _, pool, _ = fx(S)
        srv = _chaos_server(S, max_rows=0)
        f = srv.submit(pool[0])
        srv.flush()
        with pytest.raises(S.serve.DegradationExhausted) as ei:
            f.result()
        cause = ei.value.__cause__
        assert isinstance(cause, S.serve.BudgetExceeded)
        assert cause.reason == "rows" and cause.stats.budget_checks >= 1
        assert [n for n, _ in ei.value.attempts] == LADDER
        gov = telemetry_view(srv)["governor"]
        assert gov["budget_exceeded"] == 1 and gov["exhausted"] == 1
        return (outcome(f), cause.phase, cause.rows,
                cause.stats.budget_checks, gov)
    twin(scenario)


def test_generous_budget_never_triggers():
    def scenario(S):
        _, pool, oracle = fx(S)
        srv = _chaos_server(S, deadline_s=300.0, max_rows=1 << 40,
                            max_capacity=1 << 40)
        futs = srv.submit_many(pool, wait=True)
        for i, f in enumerate(futs):
            assert f.result().result_set() == oracle[i]
        t = telemetry_view(srv)
        assert t["governor"]["budget_exceeded"] == 0
        assert t["stats_rollup"]["budget_checks"] > 0
        return outcomes(futs), t["stats_rollup"]["budget_checks"], t
    twin(scenario)


# -------------------------- admission control --------------------------- #
def test_admission_control_sheds_beyond_max_pending():
    def scenario(S):
        g, pool, oracle = fx(S)
        srv = S.server(g, governor=S.serve.GovernorConfig(max_pending=2))
        futs = [srv.submit(pool[i % len(pool)]) for i in range(5)]
        shed = [f for f in futs if f.done()]
        assert len(shed) == 3
        srv.flush()
        for f in futs[:2]:
            assert f.result().result_set() in oracle
        t = telemetry_view(srv)
        assert t["queries_shed"] == 3 and t["query_errors"] == 0
        return outcomes(futs), t
    twin(scenario)


@pytest.mark.parametrize("batching", [True, False])
def test_flush_wall_budget_sheds(batching):
    def scenario(S):
        g, pool, _ = fx(S)
        srv = S.server(g, batching=batching,
                       governor=S.serve.GovernorConfig(flush_wall_s=0.0))
        futs = srv.submit_many(pool, wait=True)
        for f in futs:
            with pytest.raises(S.serve.RejectedError):
                f.result()
        srv2 = S.server(g, batching=batching,
                        governor=S.serve.GovernorConfig(flush_wall_s=300.0))
        _warm(srv2, pool)
        assert srv2.telemetry()["governor"]["shed_flush"] == 0
        return (outcomes(futs), srv.batcher.telemetry.snapshot(),
                telemetry_view(srv)["governor"])
    twin(scenario)


# -------------------------- circuit breaker ----------------------------- #
def test_quarantine_cooldown_and_halfopen_recovery():
    def scenario(S):
        _, pool, _ = fx(S)
        q = pool[1]
        srv = _chaos_server(S, breaker_threshold=2, breaker_cooldown_s=0.2)
        _warm(srv, pool)
        want = srv.query(q).result_set()
        seen = []
        calls = []
        with S.testing.FaultInjector(
                S.testing.Fault("cache_lookup", "raise", every=1)):
            for _ in range(2):
                f = srv.submit(q)
                srv.flush()
                seen.append(outcome(f))
            fp = f.fingerprint
            assert srv.governor.breaker.state(fp) == "open"
            real = srv.engine.execute_prepared

            def counting(pq, budget=None):
                calls.append(pq.fingerprint)
                return real(pq, budget=budget)
            srv.engine.execute_prepared = counting
            f = srv.submit(q)
            srv.flush()
            seen.append(outcome(f))
        f = srv.submit(q)
        srv.flush()
        seen.append(outcome(f))
        assert not calls
        time.sleep(0.25)
        res = srv.query(q)
        assert res.result_set() == want
        assert srv.governor.breaker.state(fp) == "closed"
        assert len(calls) == 1
        return seen, srv.governor.breaker.snapshot()
    seen, breaker = twin(scenario)
    assert [s[1] for s in seen] == ["DegradationExhausted"] * 2 + \
        ["QuarantinedError"] * 2
    assert breaker["recoveries"] == 1


# ---------------------- future error semantics -------------------------- #
def test_prepare_failure_isolated_and_phase_tagged(monkeypatch):
    def scenario(S):
        g, pool, _ = fx(S)
        srv = S.server(g)
        bad = S.serve.template_fingerprint(pool[0])
        real = srv.engine.prepare

        def flaky(query, fingerprint=None, version=0):
            if fingerprint == bad:
                raise ValueError("planner blew up")
            return real(query, fingerprint=fingerprint, version=version)
        monkeypatch.setattr(srv.engine, "prepare", flaky)
        futs = srv.submit_many([pool[0], pool[1]], wait=True)
        with pytest.raises(S.serve.QueryError) as ei:
            futs[0].result()
        assert ei.value.phase == "prepare"
        assert "planner blew up" in str(ei.value)
        return outcomes(futs), srv.query_errors
    twin(scenario)


def test_execute_failure_wrapped_and_terminal(monkeypatch):
    def scenario(S):
        g, pool, _ = fx(S)
        srv = S.server(g)
        boom = RuntimeError("engine exploded")
        monkeypatch.setattr(srv.engine, "execute_prepared",
                            lambda pq, budget=None: (_ for _ in ()).throw(
                                boom))
        f = srv.submit(pool[0])
        with pytest.raises(S.serve.QueryError) as ei:
            f.result()                   # lazy flush resolves it
        assert ei.value.__cause__ is boom
        assert isinstance(ei.value, RuntimeError)
        assert ei.value.fingerprint == S.serve.template_fingerprint(pool[0])
        flushes = []
        monkeypatch.setattr(srv, "flush", lambda: flushes.append(1))
        for _ in range(3):
            with pytest.raises(S.serve.QueryError):
                f.result()
        assert not flushes
        return outcome(f), ei.value.phase, srv.query_errors
    twin(scenario)


def test_query_errors_accounting_exact(monkeypatch):
    def scenario(S):
        g, pool, _ = fx(S)
        srv = S.server(g)
        bad = S.serve.template_fingerprint(pool[0])
        real = srv.engine.execute_prepared

        def flaky(pq, budget=None):
            if pq.fingerprint == bad:
                raise RuntimeError("boom")
            return real(pq)
        monkeypatch.setattr(srv.engine, "execute_prepared", flaky)
        futs = srv.submit_many([pool[0], pool[1], pool[0], pool[2]],
                               wait=True)
        got = outcomes(futs) + outcomes(futs)
        assert srv.query_errors == 2 and srv.queries_served == 2
        return got, telemetry_view(srv)
    twin(scenario)


def test_unexpected_flush_crash_fails_all_futures_typed(monkeypatch):
    def scenario(S):
        g, pool, _ = fx(S)
        srv = S.server(g)
        monkeypatch.setattr(srv.batcher, "flush",
                            lambda *a, **k: (_ for _ in ()).throw(
                                RuntimeError("batcher bug")))
        futs = srv.submit_many(pool)
        with pytest.raises(RuntimeError, match="batcher bug"):
            srv.flush()
        for f in futs:
            with pytest.raises(S.serve.IncompleteFlushError):
                f.result()
        assert srv.query_errors == len(pool)
        return outcomes(futs)
    twin(scenario)


# ------------------------ crash-restart grid ---------------------------- #
@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """snapshot(S, point): the path of a warm snapshot of the point's
    chaos server on stack S, saved once per module."""
    d = tmp_path_factory.mktemp("chaos-snaps")
    paths: dict = {}

    def get(S, point):
        if (S.name, point) not in paths:
            _, pool, _ = fx(S)
            srv = _chaos_server(S, point)
            _warm(srv, pool, passes=2)
            path = d / f"{S.name}-{point}.snap"
            assert srv.save_snapshot(path)["plans"] == len(pool)
            paths[(S.name, point)] = path
        return paths[(S.name, point)]
    return get


@pytest.mark.parametrize("crash", ["before_snapshot", "after_snapshot"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("point", POINTS)
def test_chaos_restart_grid(point, kind, crash, tmp_path, snapshot):
    def scenario(S):
        _, pool, oracle = fx(S)
        srv = _chaos_server(S, point)
        if crash == "after_snapshot":
            manifest = srv.restore_snapshot(snapshot(S, point))
            assert manifest["plans"] == len(pool)
        else:
            with pytest.raises(S.serve.SnapshotError):
                srv.restore_snapshot(tmp_path / "never-written.snap")
            assert len(srv.plan_cache) == 0
        with S.testing.FaultInjector(
                S.testing.Fault(point, kind, at=1, delay_s=0.01)) as fi:
            futs = srv.submit_many(pool, wait=True)
            _exact_or_typed(S, futs, oracle)
            got = outcomes(futs)
        assert fi.fired
        t = telemetry_view(srv)
        if crash == "after_snapshot":
            assert t["plan_cache"]["hits"] >= len(pool)
        return got, fi.calls, t["plan_cache"], t["governor"]
    twin(scenario)


def test_restart_grid_corrupt_snapshot_cell(tmp_path, snapshot):
    def scenario(S):
        _, pool, oracle = fx(S)
        raw = bytearray(snapshot(S, "kernel_dispatch").read_bytes())
        raw[-5] ^= 0x55
        bad = tmp_path / f"{S.name}-damaged.snap"
        bad.write_bytes(bytes(raw))
        srv = _chaos_server(S, "kernel_dispatch")
        with pytest.raises(S.serve.SnapshotError) as ei:
            srv.restore_snapshot(bad)
        assert len(srv.plan_cache) == 0
        futs = srv.submit_many(pool, wait=True)
        assert [f.result().result_set() for f in futs] == oracle
        return ei.value.reason, outcomes(futs)
    assert twin(scenario)[0] == "checksum"


# --------------------- rung memory: measured proof ---------------------- #
def _classify(cfg, base):
    if cfg.check_policy == "selective":
        return "primary"
    if cfg.plan_mode != "greedy":
        return "skip_check"
    if cfg.join_impl != "nested":
        return "greedy_plan"
    if cfg.max_rows == base.max_rows:
        return "force_simple_impls"
    return "truncate"


def _spy_attempts(S, m, srv):
    attempts = []
    base = srv.engine.cfg
    real = S.engine_mod.Engine.execute_prepared

    def spy(self, pq, budget=None):
        attempts.append(_classify(self.cfg, base))
        return real(self, pq, budget=budget)
    m.setattr(S.engine_mod.Engine, "execute_prepared", spy)
    return attempts


def test_rung_memory_jump_probe_and_recovery_measured(monkeypatch):
    def scenario(S):
        _, pool, _ = fx(S)
        q = pool[0]
        srv = _chaos_server(S, "kernel_dispatch", transient_retry=False,
                            reprobe_interval_s=60.0)
        gov = srv.governor
        clk = [0.0]
        gov.clock = lambda: clk[0]
        srv.query(q)
        srv.query(q)
        log = []
        with monkeypatch.context() as m:
            attempts = _spy_attempts(S, m, srv)
            with S.testing.FaultInjector(
                    S.testing.Fault("kernel_dispatch", "raise", every=1)):
                for step in range(8):
                    if step == 5:
                        clk[0] += 61.0
                    res = srv.query(q)
                    log.append((list(attempts), res.stats.degraded_steps))
                    attempts.clear()
            for _ in range(2):
                clk[0] += 61.0
                res = srv.query(q)
                log.append((list(attempts), res.stats.degraded_steps))
                attempts.clear()
        assert log[0][0] == LADDER[:4]
        assert log[1][0] == ["force_simple_impls"]
        assert log[5][0] == ["primary", "force_simple_impls"]
        assert log[8] == (["primary"], [])
        return log, telemetry_view(srv)["governor"]["rung_memory"]
    twin(scenario)


def test_rung_memory_disabled_rewalks_ladder_every_time(monkeypatch):
    def scenario(S):
        _, pool, _ = fx(S)
        srv = _chaos_server(S, "kernel_dispatch", transient_retry=False,
                            rung_memory=False)
        srv.query(pool[0])
        srv.query(pool[0])
        with monkeypatch.context() as m:
            attempts = _spy_attempts(S, m, srv)
            with S.testing.FaultInjector(
                    S.testing.Fault("kernel_dispatch", "raise", every=1)):
                for _ in range(3):
                    srv.query(pool[0])
        assert attempts == LADDER[:4] * 3
        return attempts
    twin(scenario)


# ------------------- transient-fault classification --------------------- #
@pytest.mark.parametrize("point", POINTS)
def test_transient_first1_fault_exact_no_stamp_no_strike(point):
    def scenario(S):
        _, pool, oracle = fx(S)
        srv = _chaos_server(S, point, retry_backoff_s=0.001)
        _warm(srv, pool)
        with S.testing.FaultInjector(
                S.testing.Fault(point, "raise", first=1)) as fi:
            futs = srv.submit_many(pool, wait=True)
            for i, f in enumerate(futs):
                assert f.result().result_set() == oracle[i]
                assert f.result().stats.degraded_steps == []
        gov = telemetry_view(srv)["governor"]
        assert gov["transient_retries"] == gov["transient_recoveries"] == 1
        assert gov["ladder_entries"] == gov["degraded_queries"] == 0
        assert gov["breaker"]["trips"] == 0
        return outcomes(futs), fi.calls, fi.fired, gov
    twin(scenario)


def test_budget_failure_skips_transient_retry(monkeypatch):
    def scenario(S):
        _, pool, _ = fx(S)
        srv = _chaos_server(S, max_rows=1)
        first = srv.submit(pool[0])
        srv.flush()
        retried = []
        monkeypatch.setattr(srv.engine, "prepare",
                            lambda *a, **k: retried.append(1) or
                            (_ for _ in ()).throw(AssertionError(
                                "transient retry ran for a budget abort")))
        f = srv.submit(pool[0])
        srv.flush()
        assert not retried
        gov = telemetry_view(srv)["governor"]
        assert gov["transient_retries"] == 0
        assert gov["budget_exceeded"] == 2 == gov["ladder_entries"]
        return outcome(first), outcome(f), gov
    twin(scenario)


def test_chronic_degradation_surfaces_for_replan():
    def scenario(S):
        _, pool, _ = fx(S)
        q = pool[0]
        srv = _chaos_server(S, "kernel_dispatch", transient_retry=False,
                            chronic_after=3, reprobe_interval_s=3600.0)
        srv.query(q)
        srv.query(q)
        fp = S.serve.template_fingerprint(q)
        v0 = srv.calibrator.version
        with S.testing.FaultInjector(
                S.testing.Fault("kernel_dispatch", "raise", every=1)):
            steps = [srv.query(q).stats.degraded_steps for _ in range(3)]
            assert srv.calibrator.chronic_fps == [fp]
            assert srv.calibrator.version == v0 + 1
            assert srv.plan_cache.get(srv.dataset_id, fp) is None
            steps.append(srv.query(q).stats.degraded_steps)
        assert steps[-1]
        return steps, srv.plan_cache.drops, telemetry_view(srv)["governor"]
    twin(scenario)


@pytest.mark.parametrize("where", ["primary", "retry", "rung"])
def test_kernel_failure_is_raised_not_retried_or_degraded(monkeypatch,
                                                          where):
    """A kernel that did not build or launch (``KernelError``) fails its
    query with phase 'execute': neither the transient retry nor a ladder
    rung answers it, since on the card that answer would come from the
    plain versions in the kernels' place.  'retry' and 'rung' raise it
    after a first, ordinary error sent the query there."""
    from repro_torch.kernels import KernelError
    g, pool, oracle = fx(PORT)
    srv = PORT.server(g, cfg=forcing_cfg(PORT, "join_expand"),
                      batching=False,
                      governor=PORT.serve.GovernorConfig(
                          transient_retry=where != "rung",
                          retry_backoff_s=0.0))
    calls = [0]

    def failing(*a, **kw):
        calls[0] += 1
        if where == "primary" or calls[0] > 1:
            raise KernelError("CUDA kernel expand_gather failed to launch "
                              "(cudaError 1)")
        raise RuntimeError("an ordinary error first")
    monkeypatch.setattr(PORT.matching, "_merge_expand", failing)
    failed = 0
    for q, want in zip(pool, oracle):
        calls[0] = 0
        f = srv.submit(q)
        srv.flush()
        if not calls[0]:
            assert f.result().result_set() == want
            continue
        failed += 1
        with pytest.raises(PORT.serve.QueryError) as ei:
            f.result()
        assert ei.value.phase == "execute"
        assert isinstance(ei.value.__cause__, KernelError)
        assert calls[0] == (1 if where == "primary" else 2)
    assert failed
    tel = srv.governor.snapshot()
    assert tel["degraded_queries"] == tel["exhausted"] == 0
    assert tel["transient_recoveries"] == 0
    assert tel["transient_retries"] == (failed if where == "retry" else 0)
    assert tel["ladder_entries"] == (failed if where == "rung" else 0)
