"""QueryServer: the user-facing serving API.

Wraps one Engine over one immutable dataset with:

  * a plan cache (`plan_cache.PlanCache`, LRU) of PreparedQuery objects
    keyed by canonical template fingerprint — repeat templates skip
    planning and recompilation;
  * a server-owned LRU-bounded reach cache installed on the engine, so
    connection edges of *different* queries sharing endpoint nodes reuse
    reach sets;
  * shape-batched execution (`batching.ShapeBatcher`): submitted queries
    are bucketed by (fingerprint, pow2 capacity class) at flush time,
    each bucket executed once, results fanned out (renumbered clients get
    their own column mapping);
  * online calibration (`calibrate.Calibrator`) of the τ thresholds and
    cost-model constants from the executed queries' own stats;
  * resource governance (`governor`): admission control with load
    shedding, per-execution deadline/row/capacity budgets, a degradation
    ladder that retries failed or over-budget queries on exact-but-
    cheaper settings, and a per-fingerprint circuit breaker that
    quarantines repeatedly failing templates;
  * latency/cache telemetry: p50/p99 overall and split cold vs. warm,
    plan/reach cache hit rates, batch dedup factor, governor counters,
    and a rollup of QueryStats.to_dict() sums.

Submission is future-based: `submit` enqueues and returns a
`ResultFuture`; execution happens at `flush()` (called explicitly, by
`submit_many(..., wait=True)`, or lazily by the first `.result()`).
`query()` is the synchronous one-call convenience.

Failure containment invariant: a flush NEVER leaves a submitted future
unresolved and NEVER lets one query's failure leak into another's
result.  Every future resolves with either an exact result or its own
typed error; `ResultFuture.result()` re-raises serving errors as-is and
wraps engine exceptions in `QueryError` carrying the template
fingerprint and the failing phase (prepare vs. execute vs.
degraded-retry) with the original as __cause__.
"""
from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import replace

import torch

from ..core.engine import (Engine, EngineConfig, MatchResult, QueryStats,
                           make_engine)
from ..core.connectivity import ReachCache
from ..core.dataset import Dataset
from ..core.matching import _pow2
from ..core.query import QueryTemplate
from ..kernels import KernelError
from ..obs.trace import NULL_TRACER
from ..obs.metrics import MetricsRegistry
from ..obs.explain import render_explain
from .plan_cache import (PlanCache, canonicalize, dataset_key,  # noqa: F401
                         prepare_cached, remap_result)
from .result_cache import ResultCache
from .batching import ShapeBatcher
from .calibrate import Calibrator
from .governor import (Governor, GovernorConfig, BudgetExceeded,
                       ServingError, RejectedError, QuarantinedError,
                       QueryError, IncompleteFlushError,
                       DegradationExhausted)

# a kernel that did not build or launch, or a fault the card reported
# later: never retried and never served from a degraded rung, which would
# answer with the plain versions on the card in the kernels' place
KERNEL_FAILURES = (KernelError,
                   *((torch.AcceleratorError,)
                     if hasattr(torch, "AcceleratorError") else ()))


class ResultFuture:
    """Handle for one submitted query.  `result()` drains the server's
    pending batch if this future is still unresolved (lazy flush), so
    async submission needs no background thread.  An execution failure
    resolves the future with the error (re-raised by `result()`) instead
    of aborting the flush — one poisoned bucket cannot orphan the rest
    of the batch.

    A failed future is terminal: the error is stored at resolution time,
    so repeated `.result()` calls re-raise it without draining the
    server again."""

    def __init__(self, server: "QueryServer", query: QueryTemplate):
        self._server = server
        self.query = query
        self._result: MatchResult | None = None
        self._error: BaseException | None = None
        self._phase: str = "execute"        # phase the stored error hit
        self.fingerprint: str | None = None
        self.latency: float | None = None   # seconds, set at resolution
        self.cache_hit: bool = False        # plan-cache hit at flush time
        self.trace_id: str | None = None    # obs trace id (None when off)

    def done(self) -> bool:
        return self._result is not None or self._error is not None

    def result(self) -> MatchResult:
        if not self.done():
            self._server.flush()
            if not self.done():
                # flush() guarantees resolution; if that invariant ever
                # breaks, surface a typed terminal error instead of
                # asserting — and never re-drain on the next call
                self._fail(IncompleteFlushError(
                    "flush completed without resolving this future"),
                    phase="flush")
        if self._error is not None:
            err = self._error
            if isinstance(err, ServingError):
                raise err
            raise QueryError(self.fingerprint, self._phase, err,
                             trace_id=self.trace_id) from err
        return self._result

    def _resolve(self, result: MatchResult, latency: float) -> None:
        self._result = result
        self.latency = latency

    def _fail(self, error: BaseException, phase: str = "execute") -> None:
        self._error = error
        self._phase = phase


class QueryServer:
    """Serve template queries over one `repro_torch.core.Dataset`.

    Construct from a Dataset (`QueryServer(Dataset.build(graph, ...))`);
    passing a bare graph still works as a deprecated shim that wraps it
    in a version-0 Dataset.  `apply_delta` moves the server to the next
    dataset version in place, migrating warm state (see its docstring).
    `result_cache_size > 0` enables the exact-repeat ResultCache: a
    repeated template on an unchanged dataset version is answered from
    stored rows without any engine execution.

    calibrate=False freezes the thresholds/cost model at their configured
    values (A/B baseline); batching=False executes submissions one at a
    time in arrival order (still through the plan cache).  `cfg`, when
    given, is the complete engine configuration — `variant` is then
    ignored and passing thresholds/impl/device alongside raises.
    `device` is where the engine's tables and kernels run: "cuda" unless
    the caller asks for "cpu" (with `cfg`, `cfg.device` rules).  `governor`
    (a GovernorConfig) enables resource governance: admission control,
    per-execution budgets, the degradation ladder, and the circuit
    breaker; None (the default) keeps the ungoverned behavior.

    `tracer` (an obs.trace.Tracer) enables per-query tracing: every
    submission gets a trace id and its submit/prepare/governor/engine
    spans (the answer's copy to the host as ``copy_out``; each
    ``execute`` segment counts the engine's device reads and the time
    blocked in them as ``host_syncs`` and ``sync_wait_ns``), on
    torch.profiler's clock, exportable via `tracer.export_chrome(path)`;
    None keeps the ~zero-cost NULL_TRACER.  `slow_query_s` retains any query slower
    than the threshold in a bounded slow-query log with its rendered
    EXPLAIN (`slow_queries()`).  `latency_window` is accepted for
    API compatibility; latency percentiles now come from the metrics
    registry's O(1)-memory log-bucketed histograms."""

    def __init__(self, dataset, variant: str = "rdf_h", ni=None, stats=None,
                 thresholds=None, cfg: EngineConfig | None = None,
                 impl: str = "auto",
                 plan_cache_size: int = 64,
                 reach_cache_size: int = 200_000,
                 reach_cache_bytes: int | None = None,
                 result_cache_size: int = 0,
                 result_cache_bytes: int | None = None,
                 calibrate: bool = True, batching: bool = True,
                 latency_window: int = 4096,
                 governor: GovernorConfig | None = None,
                 tracer=None, slow_query_s: float | None = None,
                 slow_log_max: int = 32, device: str | None = None):
        if cfg is not None:
            # cfg is the complete engine configuration: silently dropping
            # a tuned thresholds/impl/device next to it would corrupt A/B
            # runs
            if (thresholds is not None or impl != "auto"
                    or device is not None):
                raise ValueError("pass either cfg or thresholds/impl/device, "
                                 "not both (cfg already carries them)")
            if isinstance(dataset, Dataset):
                if ni is not None or stats is not None:
                    raise ValueError("pass ni/stats via the Dataset, "
                                     "not alongside it")
                self.engine = Engine(dataset, cfg)
            else:
                if ni is None:
                    from ..core.ni_index import build_ni_index
                    ni = build_ni_index(dataset, d_max=cfg.d_check)
                self.engine = Engine(dataset, ni, cfg, stats=stats)
        else:
            self.engine = make_engine(dataset, variant, ni=ni, stats=stats,
                                      thresholds=thresholds, impl=impl,
                                      device=device or "cuda")
        self.dataset = self.engine.dataset
        # the calibrator mutates Thresholds/CostModel in place so every
        # later plan sees calibrated values — give the engine private
        # copies first, so a caller-supplied (possibly shared or tuned)
        # object is never corrupted by this server's online calibration
        if calibrate:
            self.engine.cfg.thresholds = replace(self.engine.cfg.thresholds)
            self.engine.cfg.cost_model = replace(self.engine.cfg.cost_model)
        self.calibrator = (Calibrator(self.engine.cfg.thresholds,
                                      self.engine.cfg.cost_model)
                           if calibrate else None)
        self.plan_cache = PlanCache(plan_cache_size)
        # the result cache is opt-in (size 0 disables): serving rows
        # without execution also skips calibration observations and the
        # governor, which a tuning-focused deployment may not want
        self.result_cache = (ResultCache(result_cache_size,
                                         result_cache_bytes)
                             if result_cache_size else None)
        self.engine.reach_cache = ReachCache(max_entries=reach_cache_size,
                                             max_bytes=reach_cache_bytes)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.engine.tracer = self.tracer
        self.metrics = MetricsRegistry()
        self.slow_query_s = slow_query_s
        self._slow_log: deque = deque(maxlen=int(slow_log_max))
        self.batcher = ShapeBatcher(metrics=self.metrics)
        self.batching = batching
        self.governor = Governor(governor) if governor is not None else None
        self.dataset_id = self.dataset.cache_key
        self._pending: list[ResultFuture] = []
        self._rollup: dict = {}
        self.queries_served = 0
        self.query_errors = 0
        self.queries_shed = 0
        # (action, format version, monotonic stamp) of the last
        # save_snapshot/restore_snapshot, for telemetry age reporting
        self._snapshot_meta: tuple[str, int, float] | None = None

    # ------------------------------------------------------------------ #
    def submit(self, query: QueryTemplate) -> ResultFuture:
        f = ResultFuture(self, query)
        f.trace_id = self.tracer.start()
        gov = self.governor
        with self.tracer.segment("submit", f.trace_id) as sp:
            if gov is not None and gov.cfg.max_pending is not None \
                    and len(self._pending) >= gov.cfg.max_pending:
                # admission control: shed at submit time, before any
                # engine work — the future resolves immediately with
                # RejectedError
                gov.shed_submit += 1
                self.queries_shed += 1
                self.metrics.counter("queries_shed").inc()
                err = RejectedError(
                    f"pending queue full ({gov.cfg.max_pending}), "
                    "load shed at admission")
                err.trace_id = f.trace_id
                f._fail(err, phase="admit")
                sp.set(outcome="shed", pending=len(self._pending))
                self.tracer.finish(f.trace_id)
                return f
            self._pending.append(f)
            sp.set(outcome="admitted", pending=len(self._pending))
        return f

    def submit_many(self, queries, wait: bool = False) -> list[ResultFuture]:
        futures = [self.submit(q) for q in queries]
        if wait:
            self.flush()
        return futures

    def query(self, query: QueryTemplate) -> MatchResult:
        """Synchronous single-query convenience."""
        return self.submit(query).result()

    # ------------------------------------------------------------------ #
    def _version(self) -> int:
        return self.calibrator.version if self.calibrator is not None else 0

    def flush(self) -> None:
        """Execute every pending submission (batched or serial).  Every
        popped future is resolved by the time this returns — with a
        result, a typed serving error, or its own engine error — even if
        the flush body itself raises unexpectedly."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        try:
            self._flush_body(pending)
        finally:
            # failure-containment backstop: a bug escaping the per-future
            # error handling must not leave siblings hanging (a hung
            # future would re-drain the server from .result() forever)
            for f in pending:
                if not f.done():
                    f._fail(IncompleteFlushError(
                        "flush aborted before this future ran"),
                        phase="flush")
                    self.query_errors += 1

    def _flush_body(self, pending: list[ResultFuture]) -> None:
        t_flush = time.perf_counter()
        # canonicalize + plan-cache lookup per future; a failure here
        # resolves that future with the error and spares the rest
        prepped = []
        for f in pending:
            t0 = time.perf_counter()
            failed = None
            with self.tracer.segment("prepare", f.trace_id) as sp:
                try:
                    pq, order, hit = prepare_cached(self.engine, f.query,
                                                    self.plan_cache,
                                                    self.dataset_id,
                                                    self._version())
                except Exception as e:       # noqa: BLE001
                    failed = e
                    sp.set(outcome="error", error_type=type(e).__name__)
                else:
                    f.cache_hit = hit
                    f.fingerprint = pq.fingerprint
                    sp.set(outcome="ok", cache_hit=hit,
                           fingerprint=(pq.fingerprint or "")[:40])
            prep_s = time.perf_counter() - t0
            if failed is not None:
                f._fail(failed, phase="prepare")
                self.query_errors += 1
                self.metrics.counter("query_errors").inc()
                self.tracer.finish(f.trace_id)
                continue
            self.metrics.histogram("prepare_s").observe(prep_s)
            if self.result_cache is not None:
                cached = self.result_cache.get(self.dataset_id,
                                               pq.fingerprint)
                if cached is not None:
                    # exact repeat on the current dataset version: serve
                    # the stored canonical rows without any engine work
                    # (no batcher, no governor, no calibration observe —
                    # nothing executed, so there is nothing to learn from)
                    cols, rows = cached
                    qs = QueryStats(used_check=pq.use_check,
                                    cache_hit=True, result_cache_hit=True,
                                    plan=pq.decision)
                    qs.candidates_before = sum(pq.cand_sizes.values())
                    self.metrics.counter("result_cache_hits").inc()
                    self._observe_stats(qs)
                    self._finish(f, MatchResult(cols=cols, rows=rows,
                                                stats=qs),
                                 order, time.perf_counter() - t0)
                    continue
            prepped.append((f, pq, order, prep_s))
        stopper = self._flush_stopper(t_flush)
        if self.batching:
            for f, pq, order, prep_s in prepped:
                cap_class = _pow2(sum(pq.cand_sizes.values()))
                self.batcher.add((f, pq, order, prep_s),
                                 pq.fingerprint, cap_class)
            # the batcher pairs every member of a bucket with the SAME
            # result tuple (one execution, fanned out); the first future
            # seen per result object is the representative whose trace
            # carries the execute spans — the rest get a "fanout"
            # segment pointing at it
            rep_trace: dict[int, str | None] = {}
            for (f, pq, order, prep_s), res in \
                    self.batcher.flush(self._execute_item,
                                       should_stop=stopper):
                if isinstance(res, BaseException):
                    # bucket shed by the flush wall budget: the batcher
                    # pairs unexecuted items with the stop exception
                    self._finish(f, res, order, prep_s)
                    continue
                out, lat = res
                rid = id(res)
                if rid in rep_trace:
                    with self.tracer.segment("fanout", f.trace_id) as sp:
                        sp.set(executed_in=rep_trace[rid])
                else:
                    rep_trace[rid] = f.trace_id
                self._finish(f, out, order, prep_s + lat)
        else:
            for f, pq, order, prep_s in prepped:
                shed = stopper() if stopper is not None else None
                if shed is not None:
                    self._finish(f, shed, order, prep_s)
                    continue
                res, lat = self._execute_item((f, pq, order, prep_s))
                self._finish(f, res, order, prep_s + lat)

    def _flush_stopper(self, t0: float):
        """None, or a callable returning None (continue) / a
        RejectedError (shed the rest of this flush) once the per-flush
        wall budget is spent."""
        gov = self.governor
        if gov is None or gov.cfg.flush_wall_s is None:
            return None

        def stop():
            spent = time.perf_counter() - t0
            if spent > gov.cfg.flush_wall_s:
                gov.shed_flush += 1
                return RejectedError(
                    f"flush wall budget ({gov.cfg.flush_wall_s:.3f}s) "
                    f"exhausted after {spent:.3f}s, tail shed")
            return None

        return stop

    # ------------------------------------------------------------------ #
    def _execute_item(self, item):
        """Execute one bucket representative.  Returns (MatchResult |
        exception, latency) — failures are values so that one bad bucket
        resolves only its own futures with the error.  The circuit
        breaker gates the execution per template fingerprint; the
        degradation ladder runs inside `_execute_governed`."""
        f, pq, _, _ = item
        gov = self.governor
        t0 = time.perf_counter()
        with self.tracer.segment("execute", f.trace_id,
                                 fingerprint=(pq.fingerprint or "")[:40]
                                 ) as seg:
            if gov is not None:
                with self.tracer.span("breaker") as sp:
                    verdict = gov.breaker.admit(pq.fingerprint,
                                                now=gov.clock())
                    sp.set(verdict=verdict)
                if verdict == "deny":
                    seg.set(outcome="quarantined")
                    return QuarantinedError(
                        pq.fingerprint or "?",
                        gov.breaker.retry_after(pq.fingerprint,
                                                now=gov.clock())), \
                        time.perf_counter() - t0
            try:
                res = self._execute_governed(pq)
            except Exception as e:           # noqa: BLE001
                if gov is not None:
                    gov.breaker.record(pq.fingerprint, ok=False,
                                       now=gov.clock())
                seg.set(outcome="error", error_type=type(e).__name__)
                return e, time.perf_counter() - t0
            lat = time.perf_counter() - t0
            if gov is not None:
                gov.breaker.record(pq.fingerprint, ok=True,
                                   now=gov.clock())
            if self.calibrator is not None:
                self.calibrator.observe(res.stats)
            self._observe_stats(res.stats)
            if self.result_cache is not None and not res.stats.truncated \
                    and not res.stats.degraded_steps:
                # only clean primary results are cached: truncated rows
                # are not THE answer, and degraded-rung results came from
                # a sibling plan we don't want to pin as the repeat answer
                self.result_cache.put(self.dataset_id, pq.fingerprint,
                                      res.cols, res.rows,
                                      bool(pq.query.connections), pq.iv)
            seg.set(outcome="ok", warm=bool(res.stats.cache_hit),
                    rows=res.count)
        return res, lat

    def _execute_governed(self, pq) -> MatchResult:
        """Primary execution under the configured budget; on a failure
        (budget abort, capacity blow-up, injected fault) walk the
        degradation ladder instead of failing outright.  A kernel that
        did not build or launch (KERNEL_FAILURES) is raised: no retry,
        no rung.

        Rung memory routes repeat traffic first: a fingerprint known to
        be degraded jumps straight to its last-good rung (no primary
        attempt, no intermediate rungs); once per re-probe interval the
        primary config is probed instead — success claws full quality
        back, failure falls straight back to the remembered rung.
        Probes skip the transient retry (at most ONE primary attempt
        per interval is the contract)."""
        gov = self.governor
        if gov is None:
            return self.engine.execute_prepared(pq)
        mem = gov.rung_memory
        if mem is not None and pq.fingerprint is not None:
            with self.tracer.span("route") as sp:
                verdict, rung = mem.route(pq.fingerprint, gov.clock())
                sp.set(verdict=verdict, rung=rung)
            if verdict == "jump":
                return self._degraded_retry(pq, None, start=rung)
            if verdict == "probe":
                try:
                    res = self._attempt_primary(pq, retry=False)
                except KERNEL_FAILURES:
                    raise
                except Exception as primary:     # noqa: BLE001
                    if isinstance(primary, BudgetExceeded):
                        gov.budget_exceeded += 1
                    mem.record_probe_failed(pq.fingerprint)
                    return self._degraded_retry(pq, primary, start=rung)
                mem.record_primary_ok(pq.fingerprint)
                return res
        try:
            return self._attempt_primary(pq, retry=gov.cfg.transient_retry)
        except KERNEL_FAILURES:
            raise
        except Exception as primary:             # noqa: BLE001
            if isinstance(primary, BudgetExceeded):
                gov.budget_exceeded += 1
            return self._degraded_retry(pq, primary)

    def _attempt_primary(self, pq, retry: bool) -> MatchResult:
        """One primary execution under a fresh budget; with `retry`,
        a failure that is NOT budget/capacity-typed gets exactly one
        jittered-backoff retry on the primary config with a FRESH
        prepare and a fresh budget — a transient blip costs
        neither a ladder walk, nor a degraded-result stamp, nor a
        breaker strike.  A budget abort is deterministic (re-running
        can only re-blow the same bound), so it goes straight to the
        ladder; so does a repeat failure."""
        gov = self.governor
        budget = gov.make_budget()
        try:
            with self.tracer.span("primary") as sp:
                res = (self.engine.execute_prepared(pq) if budget is None
                       else self.engine.execute_prepared(pq, budget=budget))
                sp.set(outcome="ok")
                return res
        except (BudgetExceeded, *KERNEL_FAILURES):
            raise
        except Exception:                        # noqa: BLE001
            if not retry:
                raise
            gov.transient_retries += 1
            with self.tracer.span("transient_retry") as sp:
                backoff = gov.cfg.retry_backoff_s
                if backoff > 0:
                    time.sleep(backoff * (1.0 + gov.cfg.retry_jitter
                                          * random.random()))
                fresh = self.engine.prepare(pq.query,
                                            fingerprint=pq.fingerprint,
                                            version=pq.version)
                budget = gov.make_budget()
                res = (self.engine.execute_prepared(fresh)
                       if budget is None
                       else self.engine.execute_prepared(fresh,
                                                         budget=budget))
                gov.transient_recoveries += 1
                sp.set(outcome="recovered")
                return res

    def _degraded_retry(self, pq, primary: BaseException | None,
                        start: str | None = None) -> MatchResult:
        """Walk the ladder: each rung gets a sibling engine with the
        rung's exact-but-cheaper config, a FRESH prepare (the primary
        plan may be the thing that failed) and a fresh budget.  The plan
        cache is never polluted with degraded plans, and degraded stats
        carry `degraded_steps` so the Calibrator ignores them.  Raises
        DegradationExhausted (primary error as __cause__) if every rung
        fails.

        `start` (a rung name from rung memory) begins the walk at that
        rung — intermediate rungs are never attempted on a jump; an
        unknown name falls back to a full walk.  `primary is None`
        marks a memory jump (no primary failure happened), so it is
        counted as a jump, not a ladder entry."""
        gov = self.governor
        mem = gov.rung_memory
        attempts: list[tuple[str, BaseException]] = \
            [] if primary is None else [("primary", primary)]
        steps: list[str] = []
        ladder = gov.cfg.ladder
        first = 0
        if start is not None:
            for i, rung in enumerate(ladder):
                if rung.name == start:
                    first = i
                    break
        if primary is not None:
            gov.ladder_entries += 1
        with self.tracer.span(
                "ladder",
                entry="jump" if primary is None else "failure",
                start=start) as lsp:
            for rung in ladder[first:]:
                steps.append(rung.name)
                with self.tracer.span("rung", rung=rung.name) as rsp:
                    eng = self.engine.with_config(
                        rung.apply(self.engine.cfg, gov.cfg))
                    budget = gov.make_budget()
                    try:
                        dpq = eng.prepare(pq.query,
                                          fingerprint=pq.fingerprint)
                        res = (eng.execute_prepared(dpq)
                               if budget is None
                               else eng.execute_prepared(dpq,
                                                         budget=budget))
                    except KERNEL_FAILURES:
                        raise
                    except Exception as e:   # noqa: BLE001
                        attempts.append((rung.name, e))
                        rsp.set(outcome="failed",
                                error_type=type(e).__name__)
                        continue
                    rsp.set(outcome="ok")
                res.stats.degraded_steps = list(steps)
                gov.note_degraded(rung.name)
                if mem is not None and pq.fingerprint is not None:
                    if mem.record_degraded(pq.fingerprint, rung.name,
                                           gov.clock()):
                        self._note_chronic(pq)
                lsp.set(outcome="degraded", rung=rung.name)
                return res
            lsp.set(outcome="exhausted")
        gov.exhausted += 1
        if mem is not None and pq.fingerprint is not None:
            # even the remembered rung failed: forget it so the next
            # request re-walks (the fault moved out from under us)
            mem.clear(pq.fingerprint)
        err = DegradationExhausted(pq.fingerprint, attempts,
                                   trace_id=self.tracer.current_trace_id())
        if primary is not None:
            raise err from primary
        raise err

    def _note_chronic(self, pq) -> None:
        """A fingerprint stayed degraded past `chronic_after`: surface
        it for RE-PLANNING instead of re-trying — drop its cached plan,
        tell the Calibrator, and forget the rung so the next request
        plans fresh against the calibrated thresholds."""
        self.plan_cache.drop(self.dataset_id, pq.fingerprint)
        if self.calibrator is not None:
            self.calibrator.note_chronic(pq.fingerprint)
        self.governor.rung_memory.clear(pq.fingerprint)

    def _finish(self, f: ResultFuture, res, order, latency: float) -> None:
        if isinstance(res, BaseException):
            phase = ("degraded-retry" if isinstance(res,
                                                    DegradationExhausted)
                     else "execute")
            if isinstance(res, ServingError) and res.trace_id is None:
                # stamp the trace id so the raised error names the trace
                # holding its rung-attempt spans (shed errors shared
                # across futures keep the first future's id)
                res.trace_id = f.trace_id
            f._fail(res, phase=phase)
            self.query_errors += 1
            self.metrics.counter("query_errors").inc()
            self.tracer.finish(f.trace_id)
            return
        warm = bool(res.stats.cache_hit)
        f._resolve(remap_result(res, order), latency)
        self.queries_served += 1
        m = self.metrics
        m.counter("queries_served").inc()
        m.histogram("latency_s").observe(latency)
        m.histogram("latency_warm_s" if warm
                    else "latency_cold_s").observe(latency)
        m.histogram("result_rows").observe(res.count)
        if self.slow_query_s is not None and latency >= self.slow_query_s:
            m.counter("slow_queries").inc()
            pq = (self.plan_cache.peek(self.dataset_id, f.fingerprint)
                  if f.fingerprint is not None else None)
            self._slow_log.append({
                "fingerprint": f.fingerprint,
                "trace_id": f.trace_id,
                "latency_s": latency,
                "warm": warm,
                "explain": (None if pq is None else
                            render_explain(pq,
                                           self.engine.cfg.thresholds)),
            })
        self.tracer.finish(f.trace_id)

    def _observe_stats(self, qs) -> None:
        for k, v in qs.to_dict().items():
            if isinstance(v, bool):
                self._rollup[k] = self._rollup.get(k, 0) + int(v)
            elif isinstance(v, (int, float)):
                self._rollup[k] = self._rollup.get(k, 0) + v
            elif isinstance(v, dict) and k in ("join_strategies",
                                               "conn_strategies"):
                d = self._rollup.setdefault(k, {})
                for kk, vv in v.items():
                    d[kk] = d.get(kk, 0) + vv

    # ------------------------------------------------------------------ #
    def apply_delta(self, inserts=(), deletes=(),
                    churn_threshold: float = 0.05) -> dict:
        """Absorb a triple delta into the served dataset WITHOUT a cold
        start: pending work is flushed, `Dataset.apply_delta` produces
        the next immutable dataset version (incremental when the delta is
        small, full rebuild past the churn threshold), and every warm
        structure is migrated rather than thrown away:

          * device-resident NI tensors and the bloom signatures carry
            over for every NI entry the incremental path left untouched
            (shared by object identity with the old dataset), the edge
            tensors only while the graph object is the same;
          * reach-cache entries survive unless their stored reach set (or
            seed node) intersects the delta's edge endpoints; a rebuild
            clears the cache;
          * plan-cache entries are re-keyed to the new versioned dataset
            id, their learned state kept when the delta provably missed
            their candidate intervals AND the recomputed §4.3 decision is
            unchanged (otherwise the entry stays cached but its learned
            masks/orders reset); a rebuild drops all plans — node ids may
            have been renumbered;
          * result-cache entries survive only with an untouched interval
            footprint and no connection edges (see ResultCache.migrate);
          * governor rung memory and breaker state are fingerprint-keyed
            and survive as-is (worst case the next probe re-learns).

        The previous Dataset object is untouched — anything still holding
        it keeps getting pre-delta answers (snapshot isolation).  Returns
        an info dict: the delta mode/reason plus per-cache migration
        counts."""
        self.flush()
        old_ds, old_engine = self.dataset, self.engine
        old_id = self.dataset_id
        new_ds = old_ds.apply_delta(inserts, deletes,
                                    churn_threshold=churn_threshold)
        # same cfg object: the Calibrator keeps mutating the live
        # thresholds/cost model the new engine plans with
        eng = Engine(new_ds, old_engine.cfg)
        eng.tracer = self.tracer
        eng.check_counts = old_engine.check_counts
        for key, dev in old_engine._dev_cache.items():
            if key == "edges":
                keep = new_ds.graph is old_ds.graph
            else:                 # "bloom" is built from the 1-hop entry
                e = 1 if key == "bloom" else key[0] * key[1]
                keep = new_ds.ni.entries.get(e) is old_ds.ni.entries.get(e)
            if keep:
                eng._dev_cache[key] = dev
        rc = old_engine.reach_cache
        if new_ds.touched is None:
            reach_dropped = rc.clear()
        else:
            reach_dropped = rc.invalidate_delta(new_ds.delta_endpoints)
        eng.reach_cache = rc
        if self.calibrator is not None:
            self.calibrator.note_delta()
        new_version = self._version()
        new_id = new_ds.cache_key
        plans_kept = plans_invalidated = 0
        if new_ds.touched is None:
            _, plans_dropped = self.plan_cache.migrate(
                old_id, new_id, revalidate=lambda pq: False)
        else:
            touched = new_ds.touched

            def _reval(pq):
                nonlocal plans_kept, plans_invalidated
                ok = eng.revalidate_delta(pq, touched)
                ok = eng.revalidate(pq, new_version) and ok
                self.plan_cache.revalidations += 1
                if ok:
                    plans_kept += 1
                else:
                    plans_invalidated += 1
                    self.plan_cache.invalidations += 1
                return True

            _, plans_dropped = self.plan_cache.migrate(old_id, new_id,
                                                       revalidate=_reval)
        results_kept = results_dropped = 0
        if self.result_cache is not None:
            results_kept, results_dropped = self.result_cache.migrate(
                old_id, new_id, new_ds.touched)
        self.dataset = new_ds
        self.dataset_id = new_id
        self.engine = eng
        self.metrics.counter("deltas_applied").inc()
        self.metrics.gauge("dataset_version").set(new_ds.version)
        info = dict(new_ds.delta_info)
        info.update({
            "version": new_ds.version,
            "dataset_id": new_id,
            "plans_kept": plans_kept,
            "plans_invalidated": plans_invalidated,
            "plans_dropped": plans_dropped,
            "reach_dropped": reach_dropped,
            "results_kept": results_kept,
            "results_dropped": results_dropped,
        })
        return info

    # ------------------------------------------------------------------ #
    def save_snapshot(self, path) -> dict:
        """Serialize every piece of learned serving state (calibrator
        separators/scales, governor rung memory + breaker, plan-cache
        entries with their learned join/connection plans) to `path`.
        Returns the snapshot manifest.  See repro_torch.serve.snapshot."""
        from .snapshot import save_snapshot as _save
        manifest = _save(self, path)
        self._snapshot_meta = ("saved", manifest["format_version"],
                               time.monotonic())
        return manifest

    def restore_snapshot(self, path, max_age_s: float | None = None) -> dict:
        """Load learned serving state saved by `save_snapshot`.  A
        corrupt, version-mismatched, stale, or wrong-dataset snapshot
        raises SnapshotError and leaves this server untouched (a clean
        cold start) — never a wrong or stale answer.  Returns the
        restored manifest."""
        from .snapshot import restore_snapshot as _restore
        manifest = _restore(self, path, max_age_s=max_age_s)
        self._snapshot_meta = ("restored", manifest["format_version"],
                               time.monotonic())
        return manifest

    def _snapshot_info(self) -> dict | None:
        if self._snapshot_meta is None:
            return None
        action, version, stamp = self._snapshot_meta
        return {"action": action, "format_version": version,
                "age_s": time.monotonic() - stamp}

    # ------------------------------------------------------------------ #
    def explain(self, query: QueryTemplate) -> str:
        """Rendered EXPLAIN report for `query`'s plan: the §4.3 check
        decision with its τ terms, per-node candidate intervals, D-tree
        decomposition, learned join/connection orders, and the recorded
        join sequence (estimated vs. observed rows).  Uses the cached
        plan when present (without perturbing LRU order or hit/miss
        telemetry); a never-seen template is prepared — and cached — so
        EXPLAIN shows exactly the plan the next execution will run."""
        _, _, fingerprint = canonicalize(query)
        pq = self.plan_cache.peek(self.dataset_id, fingerprint)
        if pq is None:
            pq, _, _ = prepare_cached(self.engine, query, self.plan_cache,
                                      self.dataset_id, self._version())
        return render_explain(pq, self.engine.cfg.thresholds)

    def slow_queries(self) -> list[dict]:
        """The bounded slow-query log (oldest first): one dict per query
        slower than `slow_query_s`, carrying fingerprint, trace id,
        latency, warm/cold, and the rendered EXPLAIN of the plan that
        ran it."""
        return list(self._slow_log)

    def telemetry(self) -> dict:
        """One JSON-serializable snapshot of everything the server knows
        about itself: latency percentiles (seconds), cache hit rates,
        batching dedup, calibration state, governance counters, the
        metrics-registry snapshot, the QueryStats rollup, and what the
        signature check did (``check``: ``CheckCounts`` since start)."""
        rc = self.engine.reach_cache
        gov_t = None
        if self.governor is not None:
            gov_t = self.governor.snapshot()
            gov_t["snapshot"] = self._snapshot_info()
        m = self.metrics
        m.gauge("pending").set(len(self._pending))
        m.gauge("plan_cache_entries").set(len(self.plan_cache))
        m.gauge("reach_cache_bytes").set(rc.total_bytes)
        lat = m.histogram("latency_s")
        cold = m.histogram("latency_cold_s")
        warm = m.histogram("latency_warm_s")
        out = {
            "queries_served": self.queries_served,
            "query_errors": self.query_errors,
            "queries_shed": self.queries_shed,
            "latency": {
                "p50": lat.percentile(50),
                "p99": lat.percentile(99),
                "cold_p50": cold.percentile(50),
                "cold_p99": cold.percentile(99),
                "warm_p50": warm.percentile(50),
                "warm_p99": warm.percentile(99),
                "n_cold": cold.count,
                "n_warm": warm.count,
            },
            "metrics": m.snapshot(),
            "dataset": {
                "id": self.dataset_id,
                "digest": self.dataset.digest,
                "version": self.dataset.version,
                "nodes": self.dataset.num_nodes,
                "edges": self.dataset.num_edges,
            },
            "plan_cache": self.plan_cache.snapshot(),
            "result_cache": (None if self.result_cache is None
                             else self.result_cache.snapshot()),
            "reach_cache": {
                "entries": len(rc), "hits": rc.hits, "misses": rc.misses,
                "evictions": rc.evictions,
                "bytes": rc.total_bytes, "max_bytes": rc.max_bytes,
            },
            "batch": self.batcher.telemetry.snapshot(),
            "calibration": (None if self.calibrator is None
                            else self.calibrator.snapshot()),
            "governor": gov_t,
            "stats_rollup": dict(self._rollup),
            # the port's own: what the signature check did, cumulative
            "check": self.engine.check_counts.snapshot(),
        }
        return out
