"""Query serving subsystem: template plan cache, shape-batched execution,
and self-calibrating pruning decisions — the serving tier of
``repro.serve``, module for module, over the PyTorch engine.  The
server's engine runs on ``cuda`` unless the caller asks for
``device="cpu"``.

RDF-ℏ's thesis — signature pruning should be applied *selectively* per
dataset and per query template (§4.3) — only pays off in a serving
setting where the same templates arrive repeatedly and the system can
learn from its own executions.  This package is that setting:

  * `plan_cache`  — canonical template fingerprints and an LRU cache of
                    `PreparedQuery` objects (the engine's prepare/execute
                    split), so repeat templates skip planning and
                    recompilation entirely.
  * `batching`    — shape-batched execution: queries bucketed by template
                    fingerprint and pow2 capacity class, each bucket
                    executed once through shared padded shapes.
  * `calibrate`   — online calibration of the τ1–τ3 pruning thresholds
                    and the planner cost-model constants from per-query
                    QueryStats telemetry.
  * `governor`    — resource governance and failure containment:
                    per-execution deadline/row/capacity budgets, the
                    exact-but-cheaper degradation ladder, admission
                    control, and the per-fingerprint circuit breaker.
  * `server`      — the user-facing `QueryServer` (submit / submit_many,
                    sync + async result futures, LRU-bounded plan and
                    reach caches, p50/p99 latency + cache-hit telemetry,
                    and `apply_delta` for in-place dataset version bumps
                    with warm-state migration).
  * `result_cache`— opt-in exact-repeat result rows keyed by versioned
                    dataset id + template fingerprint, migrated across
                    deltas by interval-footprint proof.
  * `snapshot`    — warm-restart durability: versioned, checksummed
                    serialization of all learned serving state
                    (calibration, rung memory, breaker, cached plans),
                    restored all-or-nothing with typed `SnapshotError`
                    fallbacks to a clean cold start.
"""
from .plan_cache import (PreparedQuery, PlanCache, template_fingerprint,
                         canonicalize, prepare_cached, dataset_key)
from .result_cache import ResultCache
from .batching import ShapeBatcher, BatchTelemetry
from .calibrate import Calibrator, Ewma
from .governor import (Budget, BudgetExceeded, CircuitBreaker,
                       DegradationExhausted, Governor, GovernorConfig,
                       IncompleteFlushError, LadderRung, QueryError,
                       QuarantinedError, RejectedError, RungMemory,
                       ServingError, default_ladder)
from .server import QueryServer, ResultFuture
from .snapshot import SnapshotError, save_snapshot, restore_snapshot

__all__ = [
    "PreparedQuery", "PlanCache", "template_fingerprint", "canonicalize",
    "prepare_cached", "dataset_key", "ResultCache",
    "ShapeBatcher", "BatchTelemetry",
    "Calibrator", "Ewma", "QueryServer", "ResultFuture",
    "Budget", "BudgetExceeded", "CircuitBreaker", "DegradationExhausted",
    "Governor", "GovernorConfig", "IncompleteFlushError", "LadderRung",
    "QueryError", "QuarantinedError", "RejectedError", "RungMemory",
    "ServingError", "default_ladder",
    "SnapshotError", "save_snapshot", "restore_snapshot",
]
