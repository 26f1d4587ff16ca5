"""Resource governance and failure containment for the serving tier.

Worst-case subgraph matching is exponential in the template, and the
serving layer makes pruning/plan decisions online — so a mispredicted
plan, an adversarial template, or a capacity blow-up must be *bounded*,
*shed*, *degraded*, or *quarantined* instead of stalling every query
behind it in the flush.  Four mechanisms compose:

  * `Budget` — a cooperative per-execution budget (wall deadline, total
    materialized join rows, largest single-table capacity) threaded
    through `Engine.execute_prepared` and checked at every join and
    connection-edge boundary.  A blown budget raises `BudgetExceeded`
    carrying the partial QueryStats, so telemetry survives the abort.
  * admission control (in `QueryServer`) — a bounded pending queue that
    sheds submissions with `RejectedError` when full, plus a per-flush
    wall budget that sheds the *tail* of an over-long flush instead of
    letting one flush absorb the server.
  * the degradation ladder — a failed or over-budget query is retried on
    exact-but-cheaper settings, one rung at a time: skip the signature
    check, force the greedy plan, force the nested/cross join impls
    (avoiding the sort-merge kernel and reach-gather machinery
    entirely), and finally re-run under a reduced row cap with the
    truncation explicitly flagged.  Every rung except the last returns
    exact results; `QueryStats.degraded_steps` records the walk.
  * a per-fingerprint `CircuitBreaker` — templates that keep failing
    even through the ladder are quarantined (fail-fast
    `QuarantinedError`) for a cooldown, then probed half-open; a
    successful probe closes the breaker, a failed one re-opens it with
    exponential backoff.  One poisoned template cannot re-poison every
    flush.
  * a per-fingerprint `RungMemory` — once a template has succeeded on a
    ladder rung, repeat traffic jumps straight to that rung instead of
    re-walking the ladder from the top; a periodic primary re-probe
    (breaker-style half-open, but for *quality* rather than admission)
    claws full quality back when the underlying fault clears, and a
    template that stays degraded past `chronic_after` consecutive
    requests is surfaced for re-planning (plan-cache drop + calibrator
    notice) instead of being re-tried forever.

Both per-fingerprint state holders are bounded (`max_tracked` LRU) and
serializable (`save_state`/`load_state`) so the learned failure
knowledge survives a warm restart — see `repro_torch.serve.snapshot`.
Cross-process clocks don't compare, so saved deadlines are *relative*
remaining durations, rebased against the restoring process's clock.

The engine depends on none of this: `Budget` is duck-typed (the engine
just calls ``budget.checkpoint(...)``), so ``repro_torch.core`` never imports
``repro_torch.serve``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace


# ---------------------------------------------------------------------- #
# Typed serving errors.
# ---------------------------------------------------------------------- #
class ServingError(RuntimeError):
    """Base class of every typed serving-layer failure.  Subclasses carry
    their own context and are raised as-is by ResultFuture.result().

    `trace_id` is the query trace id (repro_torch.obs.trace) when tracing was
    enabled — the server stamps it at resolution time, so every chaos-
    suite failure is attributable to one exported trace."""

    trace_id: str | None = None


class RejectedError(ServingError):
    """Load shed: the pending queue was full at submit time, or the
    per-flush wall budget ran out before this query's bucket ran."""


class QuarantinedError(ServingError):
    """The query's template fingerprint is quarantined by the circuit
    breaker; it was failed fast without touching the engine."""

    def __init__(self, fingerprint: str, retry_after_s: float):
        self.fingerprint = fingerprint
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"template {fingerprint[:24]!r}... quarantined, "
            f"retry after {retry_after_s:.2f}s")


class QueryError(ServingError):
    """Wrapper re-raised by ResultFuture.result() around non-serving
    exceptions, adding the query fingerprint and the phase that failed
    (prepare vs. execute vs. degraded-retry).  The original exception is
    the __cause__ (``raise ... from``)."""

    def __init__(self, fingerprint: str | None, phase: str,
                 cause: BaseException, trace_id: str | None = None):
        self.fingerprint = fingerprint
        self.phase = phase
        self.trace_id = trace_id
        fp = "?" if fingerprint is None else fingerprint[:24] + "..."
        tr = "" if trace_id is None else f" [trace {trace_id}]"
        super().__init__(f"query {fp} failed during {phase}{tr}: {cause}")


class IncompleteFlushError(ServingError):
    """A flush completed without resolving this future (an internal
    serving bug surfaced as a typed error instead of a hang: the future
    is permanently failed, so repeated .result() calls never re-drain
    the server)."""


class DegradationExhausted(ServingError):
    """The primary execution and every ladder rung failed.  `attempts`
    lists (rung name, error) in order; the primary error is __cause__.
    `attempt_history` is the rendered multi-line walk (one line per
    attempted rung with its full error text) and `trace_id` ties the
    failure to its exported trace."""

    def __init__(self, fingerprint: str | None,
                 attempts: list[tuple[str, BaseException]],
                 trace_id: str | None = None):
        self.fingerprint = fingerprint
        self.attempts = attempts
        self.trace_id = trace_id
        self.attempt_history = "\n".join(
            f"  {name}: {type(err).__name__}: {err}"
            for name, err in attempts)
        steps = ", ".join(f"{name}: {type(err).__name__}"
                          for name, err in attempts)
        tr = "" if trace_id is None else f" [trace {trace_id}]"
        super().__init__(f"degradation ladder exhausted ({steps}){tr}")


class BudgetExceeded(Exception):
    """A cooperative budget check failed mid-execution.

    reason: 'deadline' | 'rows' | 'capacity'; `stats` is the partial
    QueryStats of the aborted execution (telemetry survives the abort),
    `phase` the pipeline phase that tripped the check."""

    def __init__(self, reason: str, phase: str, elapsed_s: float,
                 rows: int, stats=None):
        self.reason = reason
        self.phase = phase
        self.elapsed_s = float(elapsed_s)
        self.rows = int(rows)
        self.stats = stats
        super().__init__(
            f"budget exceeded ({reason}) in phase {phase!r} after "
            f"{elapsed_s * 1e3:.1f}ms / {rows} rows")


# ---------------------------------------------------------------------- #
# Cooperative per-execution budget.
# ---------------------------------------------------------------------- #
@dataclass
class Budget:
    """Per-execution resource budget, checked cooperatively by the engine
    at join and connection-edge boundaries (``checkpoint``).

    deadline_s bounds wall time for ONE execution attempt; max_rows
    bounds the cumulative materialized join output rows; max_capacity
    bounds the largest single table capacity the execution may allocate.
    All three are optional — None disables that bound."""
    deadline_s: float | None = None
    max_rows: int | None = None
    max_capacity: int | None = None
    started: float = field(default_factory=time.perf_counter)
    rows: int = 0
    checks: int = 0

    def elapsed(self) -> float:
        return time.perf_counter() - self.started

    def checkpoint(self, phase: str, rows: int = 0, cap: int = 0,
                   stats=None) -> None:
        """Record `rows` newly materialized rows / a table of capacity
        `cap` and raise BudgetExceeded if any bound is now blown."""
        self.checks += 1
        self.rows += int(rows)
        if self.deadline_s is not None:
            el = self.elapsed()
            if el > self.deadline_s:
                raise BudgetExceeded("deadline", phase, el, self.rows,
                                     stats=stats)
        if self.max_rows is not None and self.rows > self.max_rows:
            raise BudgetExceeded("rows", phase, self.elapsed(), self.rows,
                                 stats=stats)
        if self.max_capacity is not None and cap > self.max_capacity:
            raise BudgetExceeded("capacity", phase, self.elapsed(),
                                 self.rows, stats=stats)


# ---------------------------------------------------------------------- #
# Degradation ladder.
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class LadderRung:
    """One exact-but-cheaper retry configuration.  `overrides` are
    EngineConfig field replacements (cumulative by construction — each
    rung's dict includes every earlier rung's overrides); `truncate`
    additionally caps max_rows at GovernorConfig.degraded_row_cap, the
    only rung that may return non-exact (explicitly flagged truncated)
    results."""
    name: str
    overrides: dict
    truncate: bool = False

    def apply(self, cfg, gov_cfg: "GovernorConfig"):
        kw = dict(self.overrides)
        if self.truncate:
            cap = gov_cfg.degraded_row_cap
            kw["max_rows"] = cap if cfg.max_rows is None \
                else min(cfg.max_rows, cap)
        return replace(cfg, **kw)


def default_ladder() -> tuple[LadderRung, ...]:
    """skip signature check -> greedy plan -> forced nested/cross impls
    -> reduced row cap.  Rung 3 avoids the sort-merge kernel, the join
    expand, and the reach-gather machinery entirely (nested joins +
    cross-product connection edges), so a fault localized to any of
    those still has an exact escape hatch."""
    skip = {"check_policy": "never"}
    greedy = {**skip, "plan_mode": "greedy"}
    simple = {**greedy, "join_impl": "nested", "connection_impl": "cross"}
    return (
        LadderRung("skip_check", skip),
        LadderRung("greedy_plan", greedy),
        LadderRung("force_simple_impls", simple),
        LadderRung("truncate", simple, truncate=True),
    )


# ---------------------------------------------------------------------- #
# Per-fingerprint circuit breaker.
# ---------------------------------------------------------------------- #
class CircuitBreaker:
    """closed -> (threshold consecutive failures) -> open (fail-fast for
    cooldown) -> half-open (one probe) -> closed on success, re-open with
    exponentially backed-off cooldown on failure.

    Failures are counted per template fingerprint and only for queries
    that failed *through* the degradation ladder — a template served
    exactly by a degraded rung is a success.  `now` is injectable for
    deterministic tests; values are clamped to a high-water mark so a
    clock passed backwards can never re-open a recovered breaker or
    resurrect an expired cooldown.

    The per-fingerprint state dict is bounded: at `max_tracked` entries
    the least-recently-touched *closed, fully recovered* entry is
    evicted (open/half-open entries are never evicted — quarantine
    state must not be forgettable under fingerprint churn)."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 backoff: float = 2.0, max_cooldown_s: float = 300.0,
                 max_tracked: int = 1024):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.backoff = float(backoff)
        self.max_cooldown_s = float(max_cooldown_s)
        self.max_tracked = int(max_tracked)
        self._st: OrderedDict[str, dict] = OrderedDict()
        self._hwm = 0.0                 # high-water mark of observed `now`
        self.trips = 0
        self.denials = 0
        self.probes = 0
        self.recoveries = 0
        self.evictions = 0

    def _now(self, now: float | None) -> float:
        now = time.monotonic() if now is None else float(now)
        self._hwm = max(self._hwm, now)
        return self._hwm

    def _touch(self, fp: str) -> None:
        self._st.move_to_end(fp)

    def _evict(self) -> None:
        """Drop LRU closed entries until under `max_tracked`.  Entries
        with residual failure counts go only after fully-recovered ones;
        open/half-open entries are never dropped."""
        if len(self._st) <= self.max_tracked:
            return
        for want_clean in (True, False):
            for fp in list(self._st):
                st = self._st[fp]
                if st["state"] != "closed":
                    continue
                if want_clean and st["failures"] != 0:
                    continue
                del self._st[fp]
                self.evictions += 1
                if len(self._st) <= self.max_tracked:
                    return

    def admit(self, fp: str, now: float | None = None) -> str:
        """'allow' | 'deny' | 'probe' for one execution of `fp`."""
        st = self._st.get(fp)
        if st is None or st["state"] == "closed":
            return "allow"
        self._touch(fp)
        now = self._now(now)
        if st["state"] == "open":
            if now < st["until"]:
                self.denials += 1
                return "deny"
            st["state"] = "half_open"
        self.probes += 1
        return "probe"

    def retry_after(self, fp: str, now: float | None = None) -> float:
        st = self._st.get(fp)
        if st is None or st["state"] != "open":
            return 0.0
        return max(0.0, st["until"] - self._now(now))

    def record(self, fp: str, ok: bool, now: float | None = None) -> None:
        st = self._st.setdefault(fp, {"state": "closed", "failures": 0,
                                      "cooldown": self.cooldown_s,
                                      "until": 0.0})
        self._touch(fp)
        self._evict()
        if ok:
            if st["state"] != "closed":
                self.recoveries += 1
            st.update(state="closed", failures=0, cooldown=self.cooldown_s)
            return
        st["failures"] += 1
        if st["state"] == "half_open":
            # failed probe: re-open, back the cooldown off
            st["cooldown"] = min(st["cooldown"] * self.backoff,
                                 self.max_cooldown_s)
            st["failures"] = 0
        elif st["failures"] < self.threshold:
            return
        else:
            st["failures"] = 0
        st["state"] = "open"
        st["until"] = self._now(now) + st["cooldown"]
        self.trips += 1

    def state(self, fp: str) -> str:
        st = self._st.get(fp)
        return "closed" if st is None else st["state"]

    def snapshot(self) -> dict:
        by_state: dict[str, int] = {}
        for st in self._st.values():
            by_state[st["state"]] = by_state.get(st["state"], 0) + 1
        return {
            "tracked": len(self._st),
            "trips": self.trips,
            "denials": self.denials,
            "probes": self.probes,
            "recoveries": self.recoveries,
            "evictions": self.evictions,
            "open": by_state.get("open", 0),
            "half_open": by_state.get("half_open", 0),
        }

    def save_state(self, now: float | None = None) -> dict:
        """Serializable state.  ``time.monotonic`` values are meaningless
        across processes, so open-cooldown deadlines are stored as
        *remaining* durations and rebased at ``load_state``."""
        now = self._now(now)
        entries = []
        for fp, st in self._st.items():        # LRU order preserved
            entries.append({
                "fp": fp, "state": st["state"],
                "failures": int(st["failures"]),
                "cooldown": float(st["cooldown"]),
                "until_rel": max(0.0, st["until"] - now),
            })
        return {"entries": entries,
                "counters": {"trips": self.trips, "denials": self.denials,
                             "probes": self.probes,
                             "recoveries": self.recoveries,
                             "evictions": self.evictions}}

    def load_state(self, state: dict, now: float | None = None) -> None:
        now = self._now(now)
        self._st.clear()
        for e in state.get("entries", []):
            self._st[str(e["fp"])] = {
                "state": str(e["state"]),
                "failures": int(e["failures"]),
                "cooldown": float(e["cooldown"]),
                "until": now + float(e.get("until_rel", 0.0)),
            }
        c = state.get("counters", {})
        self.trips = int(c.get("trips", 0))
        self.denials = int(c.get("denials", 0))
        self.probes = int(c.get("probes", 0))
        self.recoveries = int(c.get("recoveries", 0))
        self.evictions = int(c.get("evictions", 0))
        self._evict()


# ---------------------------------------------------------------------- #
# Per-fingerprint rung memory.
# ---------------------------------------------------------------------- #
class RungMemory:
    """Remembers, per template fingerprint, the last degradation rung
    that *succeeded*, so repeat traffic on a known-degraded template
    jumps straight to that rung instead of re-walking the ladder from
    the top on every request.

    ``route(fp)`` returns one of:

      * ``("primary", None)`` — no memory for `fp`: run the primary
        config (walking the ladder only if it actually fails).
      * ``("jump", rung)``    — known degraded: execute `rung` directly,
        zero primary or intermediate-rung attempts.
      * ``("probe", rung)``   — the re-probe interval elapsed: try the
        primary config ONCE; on success the memory is cleared (quality
        clawed back), on failure fall straight back to `rung`.  Routing
        a probe *claims* the interval slot (``next_probe`` advances
        immediately), so concurrent traffic keeps jumping — at most one
        primary attempt per `reprobe_interval_s`.

    ``record_degraded`` returns True exactly once, when a fingerprint
    has stayed degraded for `chronic_after` consecutive requests — the
    caller surfaces it for re-planning (plan-cache drop + calibrator
    notice) rather than re-trying forever.

    Bounded like the breaker: LRU eviction at `max_tracked` (forgetting
    a rung only costs one extra ladder walk).  `now` is injectable."""

    def __init__(self, reprobe_interval_s: float = 30.0,
                 chronic_after: int = 8, max_tracked: int = 1024):
        self.reprobe_interval_s = float(reprobe_interval_s)
        self.chronic_after = int(chronic_after)
        self.max_tracked = int(max_tracked)
        self._st: OrderedDict[str, dict] = OrderedDict()
        self.hits = 0               # routed requests with memory present
        self.jumps = 0              # direct-to-rung executions
        self.probes = 0             # primary re-probe attempts routed
        self.probe_recoveries = 0   # probes that restored full quality
        self.probe_failures = 0     # probes that fell back to the rung
        self.chronic = 0            # fingerprints surfaced for re-plan
        self.evictions = 0

    def _now(self, now: float | None) -> float:
        return time.monotonic() if now is None else float(now)

    def route(self, fp: str, now: float | None = None):
        st = self._st.get(fp)
        if st is None:
            return ("primary", None)
        self._st.move_to_end(fp)
        self.hits += 1
        now = self._now(now)
        if now >= st["next_probe"]:
            st["next_probe"] = now + self.reprobe_interval_s
            self.probes += 1
            return ("probe", st["rung"])
        self.jumps += 1
        return ("jump", st["rung"])

    def record_degraded(self, fp: str, rung: str,
                        now: float | None = None) -> bool:
        """A request on `fp` was served by `rung`.  Returns True exactly
        when the fingerprint crosses the chronic threshold."""
        now = self._now(now)
        st = self._st.get(fp)
        if st is None:
            st = {"rung": rung, "consecutive": 0,
                  "next_probe": now + self.reprobe_interval_s}
            self._st[fp] = st
            self._evict()
        else:
            self._st.move_to_end(fp)
        st["rung"] = rung
        st["consecutive"] += 1
        if st["consecutive"] == self.chronic_after:
            self.chronic += 1
            return True
        return False

    def record_primary_ok(self, fp: str) -> None:
        """Primary config succeeded (a re-probe paid off): forget."""
        if self._st.pop(fp, None) is not None:
            self.probe_recoveries += 1

    def record_probe_failed(self, fp: str) -> None:
        self.probe_failures += 1

    def clear(self, fp: str) -> None:
        self._st.pop(fp, None)

    def rung(self, fp: str) -> str | None:
        st = self._st.get(fp)
        return None if st is None else st["rung"]

    def _evict(self) -> None:
        while len(self._st) > self.max_tracked:
            self._st.popitem(last=False)
            self.evictions += 1

    def snapshot(self) -> dict:
        return {
            "tracked": len(self._st),
            "hits": self.hits,
            "jumps": self.jumps,
            "probes": self.probes,
            "probe_recoveries": self.probe_recoveries,
            "probe_failures": self.probe_failures,
            "chronic": self.chronic,
            "evictions": self.evictions,
        }

    def save_state(self, now: float | None = None) -> dict:
        now = self._now(now)
        entries = [{"fp": fp, "rung": st["rung"],
                    "consecutive": int(st["consecutive"]),
                    "next_probe_rel": max(0.0, st["next_probe"] - now)}
                   for fp, st in self._st.items()]
        return {"entries": entries,
                "counters": {"hits": self.hits, "jumps": self.jumps,
                             "probes": self.probes,
                             "probe_recoveries": self.probe_recoveries,
                             "probe_failures": self.probe_failures,
                             "chronic": self.chronic,
                             "evictions": self.evictions}}

    def load_state(self, state: dict, now: float | None = None) -> None:
        now = self._now(now)
        self._st.clear()
        for e in state.get("entries", []):
            self._st[str(e["fp"])] = {
                "rung": str(e["rung"]),
                "consecutive": int(e["consecutive"]),
                "next_probe": now + float(e.get("next_probe_rel", 0.0)),
            }
        c = state.get("counters", {})
        self.hits = int(c.get("hits", 0))
        self.jumps = int(c.get("jumps", 0))
        self.probes = int(c.get("probes", 0))
        self.probe_recoveries = int(c.get("probe_recoveries", 0))
        self.probe_failures = int(c.get("probe_failures", 0))
        self.chronic = int(c.get("chronic", 0))
        self.evictions = int(c.get("evictions", 0))
        self._evict()


# ---------------------------------------------------------------------- #
# Governor: configuration + runtime state.
# ---------------------------------------------------------------------- #
@dataclass
class GovernorConfig:
    """Resource-governance policy for one QueryServer.  Every bound is
    optional — a default-constructed config enables only the degradation
    ladder and the circuit breaker (no budgets, no shedding)."""
    deadline_s: float | None = None     # per-execution-attempt wall budget
    max_rows: int | None = None         # cumulative join output rows
    max_capacity: int | None = None     # largest single table capacity
    max_pending: int | None = None      # admission: pending-queue bound
    flush_wall_s: float | None = None   # per-flush wall budget
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    breaker_backoff: float = 2.0
    breaker_max_cooldown_s: float = 300.0
    breaker_max_tracked: int = 1024     # bound on per-fp breaker states
    degraded_row_cap: int = 1 << 14     # 'truncate' rung row cap
    ladder: tuple = field(default_factory=default_ladder)
    # --- rung memory (fault memory for the ladder) ---
    rung_memory: bool = True            # remember last-good rung per fp
    reprobe_interval_s: float = 30.0    # primary re-probe cadence
    chronic_after: int = 8              # consecutive degraded -> re-plan
    rung_memory_max: int = 1024         # bound on remembered fps
    # --- transient-fault classification ---
    transient_retry: bool = True        # one retry before the ladder
    retry_backoff_s: float = 0.01       # base backoff before the retry
    retry_jitter: float = 1.0           # backoff *= 1 + U(0,jitter)


class Governor:
    """Runtime state for one server's governance policy: the circuit
    breaker plus counters for shedding, budget aborts, and ladder use."""

    def __init__(self, cfg: GovernorConfig):
        self.cfg = cfg
        self.clock = time.monotonic     # injectable for deterministic tests
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_cooldown_s,
                                      cfg.breaker_backoff,
                                      cfg.breaker_max_cooldown_s,
                                      max_tracked=cfg.breaker_max_tracked)
        self.rung_memory = RungMemory(cfg.reprobe_interval_s,
                                      cfg.chronic_after,
                                      cfg.rung_memory_max) \
            if cfg.rung_memory else None
        self.shed_submit = 0            # submissions rejected at admission
        self.shed_flush = 0             # futures shed by the flush budget
        self.budget_exceeded = 0        # primary attempts aborted by Budget
        self.degraded: dict[str, int] = {}   # successful rung -> count
        self.degraded_queries = 0
        self.exhausted = 0              # ladder walked fully, still failed
        self.transient_retries = 0      # primary retried after a blip
        self.transient_recoveries = 0   # retries that succeeded exactly
        self.ladder_entries = 0         # requests that entered the ladder

    def make_budget(self) -> Budget | None:
        c = self.cfg
        if c.deadline_s is None and c.max_rows is None \
                and c.max_capacity is None:
            return None
        return Budget(deadline_s=c.deadline_s, max_rows=c.max_rows,
                      max_capacity=c.max_capacity)

    def note_degraded(self, rung: str) -> None:
        self.degraded_queries += 1
        self.degraded[rung] = self.degraded.get(rung, 0) + 1

    def snapshot(self) -> dict:
        c = self.cfg
        return {
            "limits": {
                "deadline_s": c.deadline_s, "max_rows": c.max_rows,
                "max_capacity": c.max_capacity,
                "max_pending": c.max_pending,
                "flush_wall_s": c.flush_wall_s,
            },
            "shed_submit": self.shed_submit,
            "shed_flush": self.shed_flush,
            "budget_exceeded": self.budget_exceeded,
            "degraded_queries": self.degraded_queries,
            "degraded_by_rung": dict(self.degraded),
            "exhausted": self.exhausted,
            "transient_retries": self.transient_retries,
            "transient_recoveries": self.transient_recoveries,
            "ladder_entries": self.ladder_entries,
            "breaker": self.breaker.snapshot(),
            "rung_memory": (None if self.rung_memory is None
                            else self.rung_memory.snapshot()),
        }

    def save_state(self, now: float | None = None) -> dict:
        return {
            "breaker": self.breaker.save_state(now),
            "rung_memory": (None if self.rung_memory is None
                            else self.rung_memory.save_state(now)),
            "counters": {
                "shed_submit": self.shed_submit,
                "shed_flush": self.shed_flush,
                "budget_exceeded": self.budget_exceeded,
                "degraded": dict(self.degraded),
                "degraded_queries": self.degraded_queries,
                "exhausted": self.exhausted,
                "transient_retries": self.transient_retries,
                "transient_recoveries": self.transient_recoveries,
                "ladder_entries": self.ladder_entries,
            },
        }

    def load_state(self, state: dict, now: float | None = None) -> None:
        self.breaker.load_state(state.get("breaker", {}), now)
        rm = state.get("rung_memory")
        if self.rung_memory is not None and rm is not None:
            self.rung_memory.load_state(rm, now)
        c = state.get("counters", {})
        self.shed_submit = int(c.get("shed_submit", 0))
        self.shed_flush = int(c.get("shed_flush", 0))
        self.budget_exceeded = int(c.get("budget_exceeded", 0))
        self.degraded = {str(k): int(v)
                         for k, v in c.get("degraded", {}).items()}
        self.degraded_queries = int(c.get("degraded_queries", 0))
        self.exhausted = int(c.get("exhausted", 0))
        self.transient_retries = int(c.get("transient_retries", 0))
        self.transient_recoveries = int(c.get("transient_recoveries", 0))
        self.ladder_entries = int(c.get("ladder_entries", 0))
