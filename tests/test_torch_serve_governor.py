"""Resource governance of the port against the reference: budgets,
circuit breaker, rung memory, the degradation ladder, the reach cache's
byte budget and capacity replay (twin of ``tests/test_governor.py``).

Each test runs the reference test's scenario on both stacks
(``torch_twin.twin``) with the same injected clock readings, and holds the
governor's counters, the breaker's and rung memory's states, the ladder's
configs and the engine's learned capacities equal.
"""
import time

import numpy as np
import pytest

from torch_twin import PORT, REF, per_stack, run_stats, twin


# ------------------------------ Budget --------------------------------- #
def _budget_error(S, fn):
    with pytest.raises(S.serve.BudgetExceeded) as ei:
        fn()
    e = ei.value
    return e.reason, e.phase, e.rows


def test_budget_rows_and_capacity_bounds():
    def scenario(S):
        b = S.serve.Budget(max_rows=100)
        b.checkpoint("match", rows=60)
        rows = _budget_error(S, lambda: b.checkpoint("match", rows=60))
        c = S.serve.Budget(max_capacity=1 << 10)
        c.checkpoint("match", cap=1 << 10)
        cap = _budget_error(S, lambda: c.checkpoint("connections",
                                                    cap=1 << 11))
        assert rows[:2] == ("rows", "match") and rows[2] == 120
        assert cap[:2] == ("capacity", "connections")
        return rows, cap, b.checks, c.checks
    twin(scenario)


def test_budget_deadline_bound():
    def scenario(S):
        b = S.serve.Budget(deadline_s=1e-9)
        time.sleep(0.001)
        return _budget_error(S, lambda: b.checkpoint("check"))
    assert twin(scenario)[0] == "deadline"


def test_budget_carries_partial_stats_and_unbounded_never_raises():
    def scenario(S):
        qs = S.core.QueryStats()
        qs.join_actual_rows = 7
        b = S.serve.Budget(max_rows=1)
        with pytest.raises(S.serve.BudgetExceeded) as ei:
            b.checkpoint("match", rows=2, stats=qs)
        assert ei.value.stats is qs
        free = S.serve.Budget()
        for _ in range(100):
            free.checkpoint("match", rows=1 << 30, cap=1 << 30)
        return ei.value.stats.join_actual_rows, free.checks, ei.value.reason
    twin(scenario)


# -------------------------- CircuitBreaker ----------------------------- #
def test_breaker_trips_after_threshold_and_recovers():
    def scenario(S):
        cb = S.serve.CircuitBreaker(threshold=3, cooldown_s=10.0)
        seen = []
        for _ in range(2):
            cb.record("fp-a", ok=False, now=1000.0)
            seen.append(cb.admit("fp-a", now=1000.0))
        cb.record("fp-a", ok=False, now=1000.0)
        seen += [cb.state("fp-a"), cb.admit("fp-a", now=1001.0),
                 cb.retry_after("fp-a", now=1001.0),
                 cb.admit("fp-a", now=1011.0)]
        cb.record("fp-a", ok=True, now=1011.0)
        seen += [cb.state("fp-a"), cb.admit("fp-a", now=1011.0)]
        assert seen == ["allow", "allow", "open", "deny",
                        pytest.approx(9.0), "probe", "closed", "allow"]
        return seen, cb.snapshot()
    twin(scenario)


def test_breaker_backoff_saturation_and_isolation():
    def scenario(S):
        cb = S.serve.CircuitBreaker(threshold=1, cooldown_s=10.0,
                                    backoff=2.0)
        cb.record("fp-b", ok=False, now=0.0)
        seen = [cb.admit("fp-b", now=5.0), cb.admit("fp-b", now=11.0)]
        cb.record("fp-b", ok=False, now=11.0)
        seen += [cb.admit("fp-b", now=25.0), cb.admit("fp-b", now=32.0),
                 cb.admit("good", now=32.0)]
        sat = S.serve.CircuitBreaker(threshold=1, cooldown_s=10.0,
                                     backoff=2.0, max_cooldown_s=60.0)
        now = 0.0
        sat.record("fp", ok=False, now=now)
        for _ in range(12):
            now = sat._st["fp"]["until"] + 0.001
            seen.append(sat.admit("fp", now=now))
            sat.record("fp", ok=False, now=now)
            seen.append(sat._st["fp"]["cooldown"])
        assert seen[-1] == 60.0 and sat.retry_after("fp", now=now) <= 60.0
        return seen, cb.snapshot(), sat.snapshot()
    twin(scenario)


def test_breaker_success_resets_and_backwards_clock():
    def scenario(S):
        cb = S.serve.CircuitBreaker(threshold=3)
        for _ in range(5):
            cb.record("fp-c", ok=False, now=0.0)
            cb.record("fp-c", ok=True, now=0.0)
        assert cb.state("fp-c") == "closed" and cb.trips == 0
        mono = S.serve.CircuitBreaker(threshold=1, cooldown_s=10.0)
        mono.record("fp", ok=False, now=100.0)
        seen = [mono.admit("fp", now=111.0)]
        mono.record("fp", ok=True, now=111.0)
        seen += [mono.admit("fp", now=50.0), mono.state("fp"),
                 mono.retry_after("fp", now=50.0)]
        mono.record("fp", ok=False, now=40.0)
        assert mono._st["fp"]["until"] >= 121.0
        return seen, mono._st["fp"]["until"], cb.snapshot()
    twin(scenario)


def test_breaker_eviction_bounds_tracked_states():
    def scenario(S):
        cb = S.serve.CircuitBreaker(threshold=1, cooldown_s=1e6,
                                    max_tracked=4)
        cb.record("quarantined", ok=False, now=0.0)
        for i in range(10):
            cb.record(f"ok-{i}", ok=True, now=0.0)
        assert cb.state("quarantined") == "open" and len(cb._st) == 4
        pref = S.serve.CircuitBreaker(threshold=5, max_tracked=2)
        pref.record("failing", ok=False, now=0.0)
        pref.record("clean-1", ok=True, now=0.0)
        pref.record("clean-2", ok=True, now=0.0)
        assert "failing" in pref._st
        return sorted(cb._st), cb.snapshot(), sorted(pref._st)
    twin(scenario)


def test_breaker_state_roundtrip_rebases_cooldowns():
    def scenario(S):
        cb = S.serve.CircuitBreaker(threshold=1, cooldown_s=10.0)
        cb.record("open-fp", ok=False, now=1000.0)
        cb.record("ok-fp", ok=True, now=1000.0)
        state = cb.save_state(now=1004.0)
        cb2 = S.serve.CircuitBreaker(threshold=1, cooldown_s=10.0)
        cb2.load_state(state, now=7.0)
        seen = [cb2.state("open-fp"), cb2.retry_after("open-fp", now=7.0),
                cb2.admit("open-fp", now=8.0),
                cb2.admit("open-fp", now=13.5), cb2.admit("ok-fp", now=7.0)]
        assert seen[1] == pytest.approx(6.0)
        return state, seen, cb2.trips
    twin(scenario)


# ---------------------------- RungMemory ------------------------------- #
def test_rung_memory_routes_primary_then_jump_then_probe():
    def scenario(S):
        mem = S.serve.RungMemory(reprobe_interval_s=30.0, chronic_after=100)
        seen = [mem.route("fp-r", now=0.0)]
        mem.record_degraded("fp-r", "force_simple_impls", now=0.0)
        seen += [mem.route("fp-r", now=t) for t in (1.0, 10.0, 29.0, 31.0,
                                                    31.0)]
        assert seen[-2] == ("probe", "force_simple_impls")
        return seen, mem.snapshot()
    twin(scenario)


def test_rung_memory_recovery_chronic_and_lru():
    def scenario(S):
        mem = S.serve.RungMemory(reprobe_interval_s=10.0, chronic_after=100)
        mem.record_degraded("fp", "skip_check", now=0.0)
        seen = [mem.route("fp", now=11.0)]
        mem.record_primary_ok("fp")
        seen.append(mem.route("fp", now=12.0))
        chronic = S.serve.RungMemory(chronic_after=3)
        flags = [chronic.record_degraded("fp", "truncate", now=0.0)
                 for _ in range(5)]
        assert flags == [False, False, True, False, False]
        chronic.clear("fp")
        lru = S.serve.RungMemory(max_tracked=3)
        for i in range(6):
            lru.record_degraded(f"fp-{i}", "skip_check", now=0.0)
        return (seen, mem.snapshot(), flags, chronic.snapshot(),
                lru.snapshot(), lru.rung("fp-5"), lru.rung("fp-0"))
    twin(scenario)


def test_rung_memory_state_roundtrip_rebases_next_probe():
    def scenario(S):
        mem = S.serve.RungMemory(reprobe_interval_s=30.0)
        mem.record_degraded("fp", "greedy_plan", now=100.0)
        state = mem.save_state(now=110.0)
        mem2 = S.serve.RungMemory(reprobe_interval_s=30.0)
        mem2.load_state(state, now=5.0)
        return state, [mem2.route("fp", now=6.0), mem2.route("fp", now=26.0)]
    twin(scenario)


# --------------------------- Fault triggers ---------------------------- #
def test_fault_triggers_and_points_match():
    def scenario(S):
        F = S.testing.Fault
        grid = {}
        for mode in ({"first": 2}, {"at": 3}, {"every": 2}):
            f = F("kernel_dispatch", "raise", **mode)
            grid[str(mode)] = [f.triggers(i) for i in range(1, 7)]
        with pytest.raises(ValueError):
            F("no_such_point", "raise")
        with pytest.raises(ValueError):
            F("kernel_dispatch", "no_such_kind")
        points = {p: tuple(attr for _, attr in targets)
                  for p, targets in S.testing.INJECTION_POINTS.items()}
        return grid, points, S.faults.FAULT_KINDS
    twin(scenario)


# ------------------------- degradation ladder -------------------------- #
def test_default_ladder_is_cumulative_and_exact_except_last():
    def scenario(S):
        cfg = S.cfg()
        gov = S.serve.GovernorConfig(degraded_row_cap=1 << 10)
        rungs = S.serve.default_ladder()
        cfgs = [r.apply(cfg, gov) for r in rungs]
        assert cfg.check_policy == "selective" and cfg.max_rows == 1 << 20
        tight = rungs[3].apply(
            S.cfg(max_rows=100),
            S.serve.GovernorConfig(degraded_row_cap=1 << 14))
        assert tight.max_rows == 100    # a tighter existing cap is kept
        return ([r.name for r in rungs], [r.truncate for r in rungs],
                [(c.check_policy, c.plan_mode, c.join_impl,
                  c.connection_impl, c.max_rows, c.impl) for c in cfgs])
    names, truncs, cfgs = twin(scenario)
    assert names == ["skip_check", "greedy_plan", "force_simple_impls",
                     "truncate"]
    assert truncs == [False, False, False, True]
    assert all(PORT.serve.default_ladder()[i].apply(
        PORT.cfg(), PORT.serve.GovernorConfig()).device == "cpu"
        for i in range(4))


def test_with_config_shares_dataset_state_not_reach_cache():
    def scenario(S):
        g = S.graph(n_nodes=40, n_edges=100, n_preds=3, seed=5)
        eng = S.engine(g)
        eng.reach_cache = S.core.ReachCache(max_entries=10)
        sib = eng.with_config(S.cfg(check_policy="never"))
        assert sib.graph is eng.graph and sib.ni is eng.ni
        assert sib.stats is eng.stats and sib._dev_cache is eng._dev_cache
        assert sib.reach_cache is None and sib.tracer is eng.tracer
        assert eng.cfg.check_policy == "selective"
        if S.port:
            assert sib.device == eng.device
        q = S.query(g, size=3, seed=6)
        return (eng.execute(q).result_set(), sib.execute(q).result_set(),
                sib.cfg.check_policy)
    twin(scenario)


def test_with_config_sibling_has_every_engine_attribute():
    """A sibling engine gets every attribute an engine has, so an
    attribute added to Engine.__init__ and not to Engine._SHARED fails
    here instead of failing every ladder rung; it is a fresh instance, so
    what was set on the primary's own dict (a patched method) stays
    there."""
    g = PORT.graph(n_nodes=40, n_edges=100, n_preds=3, seed=5)
    eng = PORT.engine(g)
    sib = eng.with_config(PORT.cfg(check_policy="never"))
    assert set(vars(sib)) == set(vars(eng))
    assert set(vars(eng)) == {*PORT.engine_mod.Engine._SHARED, "cfg",
                              "reach_cache"}
    eng.prepare = lambda *a, **k: None
    assert "prepare" not in vars(eng.with_config(eng.cfg))


# ----------------------- ReachCache byte budget ------------------------ #
def test_reach_cache_byte_budget_evicts_lru():
    def scenario(S):
        rc = S.core.ReachCache(max_bytes=10 * 4 * 100)
        for i in range(25):
            rc.put_array(i, 1, 1, np.arange(100, dtype=np.int32))
        assert rc.total_bytes <= rc.max_bytes
        return (rc.evictions, len(rc), rc.get_array(24, 1, 1) is not None,
                rc.get_array(0, 1, 1))
    assert twin(scenario)[:2] == (15, 10)


def test_reach_cache_mirrors_oversized_and_entry_bound():
    def scenario(S):
        rc = S.core.ReachCache()
        rc.put_array(7, 2, 1, np.arange(50, dtype=np.int32))
        b = [rc.total_bytes]
        rc.get_set(7, 2, 1)
        b.append(rc.total_bytes)
        rc.put_set(8, 2, 1, set(range(10)))
        b.append(rc.total_bytes)
        big = S.core.ReachCache(max_bytes=64)
        big.put_array(1, 1, 1, np.arange(1000, dtype=np.int32))
        n1 = len(big)
        big.put_array(2, 1, 1, np.arange(1000, dtype=np.int32))
        ent = S.core.ReachCache(max_entries=3, max_bytes=None)
        for i in range(6):
            ent.put_set(i, 1, 1, {i})
        return (b, n1, len(big), big.evictions, len(ent), ent.evictions,
                ent.total_bytes)
    assert twin(scenario)[0] == [200, 600, 680]


# -------------------------- capacity replay ---------------------------- #
def _table(S, cols, rows):
    arr = np.asarray(rows, dtype=np.int32)
    cap = S.matching._pow2(len(arr))
    full = np.vstack([arr, np.full((cap - len(arr), arr.shape[1]), -1,
                                   np.int32)])
    if S.port:
        import torch
        dev = torch.as_tensor(full)
    else:
        import jax.numpy as jnp
        dev = jnp.asarray(full)
    return S.matching.CandidateTable(cols=tuple(cols), rows=dev,
                                     count=len(arr))


def test_planned_join_pins_and_records_capacity():
    def scenario(S):
        a = _table(S, (0, 1), [[i, i % 4] for i in range(20)])
        b = _table(S, (1, 2), [[i % 4, i + 100] for i in range(20)])
        recorded = []
        out = S.matching.planned_join(
            a, b, est=S.core.CapEstimate(100, 1 << 9), impl="nested",
            record=lambda *r: recorded.append(r))
        assert out.cap == 1 << 9
        out2 = S.matching.planned_join(a, b, est=100, impl="nested")
        assert out2.cap != 1 << 9
        assert out.result_set() == out2.result_set()
        rec2 = []
        out3 = S.matching.planned_join(a, b, est=4, impl="nested",
                                       record=lambda *r: rec2.append(r))
        impl, est, actual, retried, cap = rec2[0]
        assert actual == out3.count and cap == out3.cap
        return ([tuple(int(x) if not isinstance(x, str) else x for x in r)
                 for r in recorded + rec2],
                out.result_set(), out2.cap, out3.cap)
    twin(scenario)


@per_stack
def replay_graph(S):
    return S.graph(n_nodes=100, n_edges=300, n_preds=3, seed=11)


def test_cold_run_records_caps_and_warm_replays_them(monkeypatch):
    def scenario(S):
        g = replay_graph(S)
        q = S.query(g, size=4, seed=21, n_connection=1, d_c=2)
        eng = S.engine(g)
        caps_per_run = []
        real = S.matching.planned_join

        def spy(a, b, est, **kw):
            out = real(a, b, est, **kw)
            if est is not None:
                caps_per_run[-1].append(out.cap)
            return out
        with monkeypatch.context() as m:
            m.setattr(S.matching, "planned_join", spy)
            m.setattr(S.engine_mod, "planned_join", spy)
            pq = eng.prepare(q)
            caps_per_run.append([])
            cold = eng.execute_prepared(pq)
            caps_per_run.append([])
            warm = eng.execute_prepared(pq)
        assert [c for _, c, _ in pq.join_seq] == caps_per_run[0]
        assert warm.stats.cache_hit and warm.stats.join_retries == 0
        assert caps_per_run[1] == caps_per_run[0]
        assert warm.result_set() == cold.result_set()
        return pq.join_seq, caps_per_run, run_stats(cold), run_stats(warm)
    twin(scenario)


def test_warm_replay_reuses_retry_capacity(monkeypatch):
    def scenario(S):
        g = replay_graph(S)
        q = S.query(g, size=5, seed=28, n_connection=0)
        eng = S.engine(g)
        with monkeypatch.context() as m:
            m.setattr(S.planner.JoinEstimator, "edge_join",
                      lambda self, *a, **k: 1)
            m.setattr(S.planner.JoinEstimator, "table_join",
                      lambda self, *a, **k: 1)
            pq = eng.prepare(q)
            cold = eng.execute_prepared(pq)
            warm = eng.execute_prepared(pq)
        assert warm.stats.join_retries == 0
        assert warm.result_set() == cold.result_set()
        return (cold.stats.join_retries, pq.join_seq, run_stats(warm),
                warm.result_set())
    twin(scenario)


# ---------------------- budgets inside the engine ---------------------- #
class _Counting:
    """A budget that never raises and records every checkpoint."""

    def __init__(self):
        self.seen = []

    def checkpoint(self, phase, rows=0, cap=0, stats=None):
        self.seen.append((phase, int(rows), int(cap)))


@per_stack
def budget_fx(S):
    g = S.graph(n_nodes=120, n_edges=360, n_preds=4, n_literals=30, seed=3)
    return g, S.pool(g, 10)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("conn", ["auto", "reach", "cross"])
def test_budget_checkpoints_match_reference(fuse, conn):
    """execute_prepared(budget=) calls the budget at the reference's
    places, in the reference's phases, with the same rows and capacities:
    ``budget_checks`` and the whole checkpoint sequence are equal, cold
    and warm."""
    def scenario(S):
        g, pool = budget_fx(S)
        eng = S.engine(g)
        eng.cfg.fuse_joins = fuse
        eng.cfg.connection_impl = conn
        out = []
        for q in pool:
            pq = eng.prepare(q)
            for _ in ("cold", "warm"):
                b = _Counting()
                res = eng.execute_prepared(pq, budget=b)
                assert res.stats.budget_checks == len(b.seen) > 0
                out.append((res.result_set(), b.seen))
            assert eng.execute_prepared(pq).stats.budget_checks == 0
        return out
    twin(scenario)
