"""RDF-ℏ query engine (paper Fig. 2 pipeline), split into prepare/execute
phases for the serving layer.

Pipeline per query: separate connection edges → IDMap candidate intervals →
(policy-dependent) neighborhood check → per-component D-tree decomposition →
edge-parallel D-tree candidate generation → cost-based whole-query join plan
(planner.plan_table_joins over System-R estimates, sort-run-reuse aware) →
connection-edge evaluation (intra-table filters first, then cross-component
connectivity joins in planner.plan_connections order) → final match table.
EngineConfig.plan_mode='greedy' keeps the seed's smallest-first heuristics
for A/B comparison.

Prepare/execute split (`Engine.prepare` / `Engine.execute_prepared`):
everything that depends only on (dataset, template) — candidate intervals,
D-tree decomposition, the §4.3 check decision — is computed once into a
`PreparedQuery`.  The first execution additionally *learns* the
data-determined parts of the plan into it: per-component join orders, the
connection-edge order, the candidate masks, and the exact join output
sizes (`join_seq`).  Repeat executions replay all of that — no planning
DP, no signature check, no capacity-overflow retries, and the same table
capacities.  The serving layer (`repro_torch.serve`) caches PreparedQuery
objects keyed by canonical template fingerprint; `Engine.execute` keeps the
one-shot behavior by preparing fresh per call.

The engine runs on ``EngineConfig.device`` ("cuda" by default): the graph's
edge tensors, the NI tensors and the candidate masks are uploaded there once
per engine, every table lives there, and the kernels of ``repro_torch.kernels``
run there.  Asking for "cuda" without CUDA raises; the CPU runs only when the
caller asks for ``device="cpu"``.

Engine variants (paper §6):
  STWIG+      check_policy='never',     any index (1-hop suffices)
  SPath(NI2)  check_policy='always',    d_check=2
  ℏ-2Hops     check_policy='selective', d_check=2
  ℏ-3Hops     check_policy='selective', d_check=3
  ℏ-VC        check_policy='selective', d_check=2, NI variant='vc'
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .graph import RDFGraph
from .ni_index import NIIndex
from .dataset import Dataset, ENGINE_VARIANTS, interval_footprint_hit
from .query import QueryTemplate, ConnectionEdge
from .signature import (build_requirements, check_interval_candidates,
                        bloom_prefilter, build_bloom)
from .decompose import decompose, join_order, DTree
from .matching import (Table, CapacityOverflow, dtree_candidates,
                       cross_join, single_node_table, filter_rows,
                       injective_filter, planned_join, _pow2,
                       JoinTelemetry, graph_edges)
from .connectivity import (connectivity_mask, reach_join, reach_filter,
                           ReachCache, ReachJoinInfo,
                           distinct_column_values, hop_split)
from .planner import (Thresholds, CostModel, PlanDecision, decide,
                      JoinEstimator, ReplayEstimator,
                      plan_table_joins, plan_connections, ConnFeatures,
                      choose_connection_impl)
from .stats import DatasetStats, connection_selectivity, endpoint_reach
from ..kernels.ops import bits32, resolve_device
from ..obs.trace import NULL_TRACER


@dataclass
class EngineConfig:
    check_policy: str = "selective"     # never | always | selective
    d_check: int = 2                    # hops used by the neighborhood check
    impl: str = "auto"                  # kernel impl (auto|cuda|sorted|ref)
    thresholds: Thresholds = field(default_factory=Thresholds)
    chunk: int = 8192
    max_rows: int | None = 1 << 20   # LIMIT guard for explosive joins
    use_bloom: bool = False          # gStore-style bloom prefilter first
    join_impl: str = "auto"     # auto (planner per-join) | sorted | radix | nested
    plan_mode: str = "cost"          # whole-query join order: cost | greedy
    # fused sort-merge chain (kernels.fused_join: pack→sort→probe→expand
    # in one dispatch).  False = staged per-op dispatches (A/B baseline,
    # also what the chaos harness uses to exercise the staged seams).
    fuse_joins: bool = True
    # connection-edge strategy: 'reach' = device-resident reach-join
    # (distinct endpoints -> reach-set pair tables -> one sort-merge join
    # on reach_id -> equi-joins back; O(matches) output work), 'cross' =
    # the seed cross-product + per-pair connectivity_mask filter
    # (O(|A|*|B|), kept for A/B), 'auto' = per-edge cost-model choice.
    connection_impl: str = "auto"    # auto | reach | cross
    # calibrated multiplicative corrections to the analytic cost model
    # (serve.Calibrator learns these online; defaults = hardcoded model)
    cost_model: CostModel = field(default_factory=CostModel)
    # where tables, NI tensors and masks live and the kernels run
    device: str = "cuda"


@dataclass
class QueryStats:
    used_check: bool = False
    truncated: bool = False
    plan: PlanDecision | None = None
    candidates_before: int = 0
    candidates_after: int = 0
    prepare_time: float = 0.0           # template planning (0 on cache hits)
    check_time: float = 0.0
    match_time: float = 0.0
    conn_time: float = 0.0
    total_time: float = 0.0
    cache_hit: bool = False             # executed from a warm PreparedQuery
    result_cache_hit: bool = False      # served from the ResultCache
    join_work: int = 0                  # Σ |A|*|B| over joins (work proxy)
    dtree_work: int = 0                 # Σ D-tree candidate rows generated
    # join planner telemetry
    join_strategies: dict = field(default_factory=dict)  # impl -> #joins
    join_retries: int = 0               # capacity-overflow recompiles
    n_estimated_joins: int = 0
    join_est_rows: int = 0              # Σ estimated output rows
    join_actual_rows: int = 0           # Σ actual output rows
    join_est_log_err: float = 0.0       # Σ |ln(est/actual)| (accuracy)
    join_est_log_bias: float = 0.0      # Σ ln(est/actual) (signed bias)
    # whole-query plan telemetry
    plan_mode: str = "cost"             # join order used (cost | greedy)
    sorts_performed: int = 0            # sort-merge sorts actually run
    sorts_avoided: int = 0              # skipped via sort-order/cached runs
    plan_cost: float = 0.0              # Σ est cost of executed join plans
    greedy_plan_cost: float = 0.0       # same cost model, greedy order
    # connection-edge telemetry (reach-join subsystem)
    conn_strategies: dict = field(default_factory=dict)  # impl -> #edges
    conn_reach_pairs: int = 0           # Σ (node, reach_id) pairs gathered
    conn_connected_pairs: int = 0       # Σ deduped connected endpoint pairs
    conn_endpoint_rows: int = 0         # Σ endpoint-column rows seen
    conn_endpoint_distinct: int = 0     # Σ distinct endpoint nodes seen
    conn_est_pairs: float = 0.0         # Σ predicted connected pairs
    conn_est_reach_pairs: float = 0.0   # Σ predicted pair-table rows
    # serving-tier degradation ladder (repro.serve.governor): names of the
    # rungs walked before this execution succeeded, in order — empty for a
    # healthy primary execution.  The Calibrator skips degraded stats.
    degraded_steps: list = field(default_factory=list)
    budget_checks: int = 0              # cooperative budget checkpoints hit

    # Stable flat schema: scalar counters first, then the two strategy
    # dicts and a plan summary.  Server telemetry rollups and benchmarks
    # consume this instead of re-plucking fields ad hoc; a schema test
    # pins the key set, so extend it deliberately.
    _SCALAR_FIELDS = (
        "used_check", "truncated", "cache_hit", "result_cache_hit",
        "candidates_before", "candidates_after",
        "prepare_time", "check_time", "match_time", "conn_time",
        "total_time",
        "join_work", "dtree_work",
        "join_retries", "n_estimated_joins",
        "join_est_rows", "join_actual_rows",
        "join_est_log_err", "join_est_log_bias",
        "plan_mode", "sorts_performed", "sorts_avoided",
        "plan_cost", "greedy_plan_cost",
        "conn_reach_pairs", "conn_connected_pairs",
        "conn_endpoint_rows", "conn_endpoint_distinct",
        "conn_est_pairs", "conn_est_reach_pairs",
        "budget_checks",
    )

    def to_dict(self) -> dict:
        """JSON-serializable snapshot with a stable key set."""
        out = {}
        for k in self._SCALAR_FIELDS:
            v = getattr(self, k)
            if isinstance(v, (bool, str)):
                out[k] = v
            elif isinstance(v, float):
                out[k] = float(v)
            else:
                out[k] = int(v)
        out["degraded_steps"] = [str(s) for s in self.degraded_steps]
        out["join_strategies"] = {str(k): int(v)
                                  for k, v in self.join_strategies.items()}
        out["conn_strategies"] = {str(k): int(v)
                                  for k, v in self.conn_strategies.items()}
        p = self.plan
        out["plan"] = None if p is None else {
            "use_check": bool(p.use_check),
            "complex_query": bool(p.complex_query),
            "max_selectivity": float(p.max_selectivity),
            "est_iterations": float(p.est_iterations),
            "est_join_product": float(p.est_join_product),
        }
        return out


@dataclass
class MatchResult:
    cols: tuple[int, ...]
    rows: np.ndarray                    # [count, num query nodes]
    stats: QueryStats

    @property
    def count(self) -> int:
        return int(self.rows.shape[0])

    def result_set(self) -> set[tuple[int, ...]]:
        order = np.argsort(self.cols)
        return {tuple(int(r[i]) for i in order) for r in self.rows}


@dataclass
class PreparedQuery:
    """Template-level execution state: computed once by `Engine.prepare`,
    enriched by the first `execute_prepared` run, replayed by every later
    one.  `repro_torch.serve.plan_cache.PlanCache` LRU-caches these keyed by
    (dataset id, canonical template fingerprint).

    prepare() fills the template-dependent fields: candidate intervals,
    component split, D-tree decomposition, and the §4.3 pruning decision.
    The first execution learns the data-determined plan — per-component
    join orders (`comp_orders`, from the Selinger DP over *actual* table
    counts), the connection-edge order (`conn_order`), the candidate pass
    masks (`masks`, device-resident), and the exact output size of every
    estimator-sized join in engine call order (`join_seq`).  Execution of
    a fixed template against an immutable dataset is deterministic, so
    replaying them is exact: warm runs skip the planning DP, the
    signature check, and all capacity-overflow retries, and allocate the
    same capacities every time."""
    query: QueryTemplate
    iv: np.ndarray                      # [Q, 2] candidate intervals
    cand_sizes: dict[int, int]
    comps: list[list[int]]
    trees_per_comp: list[list[DTree]]
    decision: PlanDecision | None
    use_check: bool
    fingerprint: str | None = None
    version: int = 0                    # calibration version at prepare time
    prepare_time: float = 0.0
    # learned on first execution ------------------------------------- #
    executions: int = 0
    masks: tuple | None = None          # (pass_masks, pass_np, after)
    # host-only serializable form of `masks` — (pass_np, after) with no
    # device tensors.  Written by snapshot serialization
    # (repro_torch.serve.snapshot); `_candidate_masks` rebuilds the device
    # tensors from it lazily on the first post-restore execution, so a
    # restored plan never re-runs the signature check
    masks_host: tuple | None = None
    comp_orders: dict = field(default_factory=dict)   # comp idx -> order
    comp_costs: dict = field(default_factory=dict)    # comp idx -> (c, g)
    conn_order: list[int] | None = None
    conn_costs: tuple[float, float] = (0.0, 0.0)
    # per-edge strategy choices in processing order: replayed on warm
    # runs so a calibrator-moved cost model cannot flip a strategy
    # mid-replay and desync the recorded join_seq
    conn_impls: list[str] | None = None
    # (actual output rows, executed pow2 capacity, join strategy) per
    # estimator-sized join, in engine call order.  Replaying the capacity
    # (not just the row count) means warm run 1 allocates the exact
    # steady-state capacities the cold run ended at — including joins
    # whose cold run took an overflow retry, where the final capacity
    # differs from what the row count alone would re-derive.  Replaying
    # the strategy keeps the per-join sorted/radix/nested choice — which
    # depends on sort-run state that only exists mid-execution — stable
    # across warm runs (join_strategies round-trips exactly).
    join_seq: list[tuple[int, int, str]] = field(default_factory=list)
    # planner estimate per join_seq entry (None for unestimated joins),
    # recorded cold alongside join_seq — EXPLAIN renders estimated vs.
    # observed cardinality per join from the two in lockstep
    join_est_seq: list[int | None] = field(default_factory=list)

    @property
    def warm(self) -> bool:
        return self.executions > 0

    def reset_learned(self) -> None:
        """Drop everything the first execution learned (masks, join
        orders, join_seq) while keeping the template-level fields.  Used
        when a revalidation decides the learned state can't be replayed —
        a flipped §4.3 decision, or a delta that touched the template's
        candidate footprint."""
        self.masks = None
        self.masks_host = None
        self.comp_orders = {}
        self.comp_costs = {}
        self.conn_order = None
        self.conn_costs = (0.0, 0.0)
        self.conn_impls = None
        self.join_seq = []
        self.join_est_seq = []
        self.executions = 0


class Engine:
    # what a with_config sibling shares: every attribute __init__ sets but
    # cfg and the server-owned reach cache (a test holds the two lists
    # equal); the tracer too, so degraded-rung spans land in the
    # primary's trace
    _SHARED = ("dataset", "graph", "ni", "device", "idmap", "stats",
               "_dev_cache", "tracer")

    def __init__(self, dataset: "Dataset | RDFGraph",
                 ni: "NIIndex | EngineConfig | None" = None,
                 cfg: EngineConfig | None = None,
                 stats: DatasetStats | None = None):
        """Primary form: ``Engine(dataset, cfg)`` over a ``Dataset``.  The legacy ``Engine(graph, ni, cfg,
        stats)`` form still works and wraps its pieces in a version-0
        Dataset."""
        if isinstance(dataset, Dataset):
            if isinstance(ni, EngineConfig) and cfg is None:
                cfg = ni
                ni = None
            if ni is not None or stats is not None:
                raise ValueError(
                    "pass ni/stats via the Dataset, not alongside it")
            ds = dataset
        else:
            if not isinstance(ni, NIIndex):
                raise TypeError("Engine(graph, ...) requires an NI index; "
                                "construct a Dataset instead")
            ds = Dataset.build(dataset, ni=ni, stats=stats)
        self.dataset = ds
        self.graph = ds.graph
        self.ni = ds.ni
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(self.cfg.device)
        self.idmap = ds.idmap
        self.stats = ds.stats
        # device-resident NI tensors ((sign, d) keys), edge tensors and
        # bloom signatures
        self._dev_cache: dict = {}
        # optional server-owned reach cache shared across queries (reach
        # sets go stale only via Dataset.apply_delta, which the serving
        # tier pairs with ReachCache.invalidate_delta); when None each
        # execution gets its own per-query cache as before
        self.reach_cache: ReachCache | None = None
        # observability: the serving layer installs its Tracer here; the
        # default no-op tracer keeps bare-engine hot paths at ~zero cost
        self.tracer = NULL_TRACER

    # -------------------------------------------------------------- #
    def prepare(self, query: QueryTemplate,
                fingerprint: str | None = None,
                version: int = 0) -> PreparedQuery:
        """Template-dependent planning: intervals, decomposition, and the
        §4.3 check decision.  No candidate data is touched."""
        t0 = time.perf_counter()
        cfg = self.cfg
        iv = query.intervals(self.idmap)
        cand_sizes = {q: int(iv[q, 1] - iv[q, 0])
                      for q in range(query.num_nodes)}
        comps = query.components()
        trees_per_comp = [decompose(query, comp, cand_sizes)
                          for comp in comps]
        decision = None
        if cfg.check_policy == "always":
            use_check = True
        elif cfg.check_policy == "never":
            use_check = False
        else:
            decision = decide(query, trees_per_comp, cand_sizes, self.stats,
                              cfg.thresholds, k=cfg.d_check)
            use_check = decision.use_check
        return PreparedQuery(
            query=query, iv=iv, cand_sizes=cand_sizes, comps=comps,
            trees_per_comp=trees_per_comp, decision=decision,
            use_check=use_check, fingerprint=fingerprint, version=version,
            prepare_time=time.perf_counter() - t0)

    def execute(self, query: QueryTemplate) -> MatchResult:
        return self.execute_prepared(self.prepare(query))

    def with_config(self, cfg: EngineConfig) -> "Engine":
        """A sibling engine over the same dataset with a different
        configuration: shares the graph, NI index, IDMap, dataset stats,
        device tensor cache (NI, edge and bloom tensors) and device, but
        NOT the server-owned reach cache — a degraded retry
        (repro_torch.serve.governor) must execute in isolation from state
        a faulty primary run may have touched, so the sibling falls back
        to per-query reach caches."""
        eng = object.__new__(Engine)    # a fresh instance: nothing set on
        for name in self._SHARED:       # this one's dict but what it shares
            setattr(eng, name, getattr(self, name))
        eng.cfg = cfg
        eng.reach_cache = None
        return eng

    def revalidate(self, pq: PreparedQuery, version: int) -> bool:
        """Refresh a PreparedQuery after the calibrated thresholds moved.

        Only the §4.3 check decision depends on the thresholds, and
        re-deciding is cheap (pure template arithmetic) — so instead of
        discarding the plan, re-run `decide` and keep everything learned
        (masks, join orders, join_seq) whenever the decision is stable.
        A flipped decision changes the candidate masks and hence every
        downstream table, so then the learned execution state is reset
        (the template-level fields stay valid).  Returns True iff the
        learned state survived."""
        cfg = self.cfg
        kept = True
        if cfg.check_policy == "selective":
            decision = decide(pq.query, pq.trees_per_comp, pq.cand_sizes,
                              self.stats, cfg.thresholds, k=cfg.d_check)
            if decision.use_check != pq.use_check:
                pq.reset_learned()
                kept = False
            pq.decision = decision
            pq.use_check = decision.use_check
        pq.version = version
        return kept

    def revalidate_delta(self, pq: PreparedQuery,
                         touched: np.ndarray | None) -> bool:
        """Refresh a PreparedQuery after a Dataset delta (same digest
        lineage, bumped version, stable label space).

        The only learned state a data change can make *wrong* is the
        candidate masks — every pass bit is a function of the NI rows of
        the candidates in the template's intervals, and stale join
        orders/capacities/strategies self-heal (planned_join retries on
        overflow, ReplayEstimator falls back to analytic estimates).  So
        the plan survives intact iff no touched node falls inside any of
        its candidate intervals; otherwise the learned state resets and
        the next execution re-learns against the new data.  Returns True
        iff the learned state survived."""
        iv_pairs = [(int(pq.iv[q, 0]), int(pq.iv[q, 1]))
                    for q in range(pq.query.num_nodes)]
        if interval_footprint_hit(iv_pairs, touched):
            pq.reset_learned()
            return False
        return True

    # -------------------------------------------------------------- #
    def _candidate_masks(self, pq: PreparedQuery) -> tuple:
        """Per-node candidate pass specs.  With the check on, each node
        gets a [N] bool mask.  Without it the candidate set IS the IDMap
        interval — represented as a (lo, hi) pair instead of materializing
        an all-true [N] mask per query node (edge_pairs and
        single_node_table consume both forms), so the wildcard path
        allocates nothing per node.  Deterministic per (dataset,
        template): cached on the PreparedQuery, so warm executions skip
        the whole signature check."""
        if pq.masks is not None:
            return pq.masks
        if pq.masks_host is not None:
            # warm restart: rebuild device tensors from the snapshot's
            # host-form masks — no signature check, no bloom, no NI
            # touch; the restored plan replays exactly like a warm one
            host_np, after = pq.masks_host
            pass_masks = {}
            for comp in pq.comps:
                for q in comp:
                    m = host_np.get(q)
                    if m is not None:
                        pass_masks[q] = torch.as_tensor(m, device=self.device)
                    else:
                        pass_masks[q] = (int(pq.iv[q, 0]), int(pq.iv[q, 1]))
            pq.masks = (pass_masks, host_np, after)
            return pq.masks
        cfg = self.cfg
        query, iv = pq.query, pq.iv
        n = self.graph.num_nodes
        pass_masks: dict[int, object] = {}
        pass_np: dict[int, np.ndarray | None] = {}
        after = 0
        for comp in pq.comps:
            for q in comp:
                lo, hi = int(iv[q, 0]), int(iv[q, 1])
                if pq.use_check:
                    mask = np.zeros(n, dtype=bool)
                    reqs = build_requirements(query, comp, q,
                                              min(cfg.d_check, self.ni.d_max), iv)
                    ok = np.ones(hi - lo, dtype=bool)
                    if cfg.use_bloom and hi > lo:
                        ok &= bloom_prefilter(self._bloom_sigs(),
                                              self.ni.entries[1], reqs,
                                              lo, hi, impl=cfg.impl,
                                              device=self.device)
                    if ok.any():
                        ok &= check_interval_candidates(
                            self.ni, reqs, lo, hi,
                            min(cfg.d_check, self.ni.d_max),
                            impl=cfg.impl, chunk=cfg.chunk,
                            device_cache=self._dev_cache,
                            device=self.device)
                    mask[lo:hi] = ok
                    pass_np[q] = mask
                    pass_masks[q] = torch.as_tensor(mask, device=self.device)
                    after += int(mask.sum())
                else:
                    pass_np[q] = None
                    pass_masks[q] = (lo, hi)
                    after += hi - lo
        pq.masks = (pass_masks, pass_np, after)
        return pq.masks

    def execute_prepared(self, pq: PreparedQuery,
                         budget=None) -> MatchResult:
        """`budget` is an optional duck-typed cooperative budget (see
        repro_torch.serve.governor.Budget): the engine calls
        ``budget.checkpoint(phase, rows=..., cap=..., stats=qs)`` at every
        estimator-sized join and at each pipeline phase boundary, and the
        budget raises its own typed error (carrying the partial QueryStats
        it was handed) when a bound is blown.  The core never imports the
        serving layer — any object with that method works."""
        t0 = time.perf_counter()
        qs = QueryStats()
        cfg = self.cfg
        query, iv, cand_sizes = pq.query, pq.iv, pq.cand_sizes
        qs.candidates_before = sum(cand_sizes.values())
        qs.plan = pq.decision
        qs.used_check = pq.use_check
        qs.cache_hit = pq.warm
        qs.prepare_time = 0.0 if pq.warm else pq.prepare_time
        # current pipeline phase, mutated at phase boundaries so the
        # record_join checkpoint attributes budget aborts to the right
        # phase without threading a phase argument through the join stack
        phase = ["check"]

        def checkpoint(rows=0, cap=0):
            if budget is not None:
                qs.budget_checks += 1
                budget.checkpoint(phase[0], rows=rows, cap=cap, stats=qs)

        # ---- candidate masks ------------------------------------------
        t1 = time.perf_counter()
        tracer = self.tracer
        with tracer.span("check") as sp:
            pass_masks, pass_np, after = self._candidate_masks(pq)
            if sp.live:
                sp.set(used_check=pq.use_check,
                       before=qs.candidates_before, after=after,
                       warm=pq.warm)
        qs.candidates_after = after
        qs.check_time = time.perf_counter() - t1
        # deadline-only checkpoint: candidate counts are not join rows,
        # so they don't charge the max_rows budget
        checkpoint()

        # ---- per-component matching -----------------------------------
        t2 = time.perf_counter()
        base_est = JoinEstimator(self.stats, cand_sizes,
                                 scale=cfg.cost_model.join_est_scale)
        # warm runs replay the exact join sizes observed on the first
        # execution; cold runs record them as they happen (restarting the
        # recording, so a previously failed partial run can't corrupt it)
        warm_replay = pq.warm and bool(pq.join_seq)
        if not warm_replay:
            pq.join_seq = []
            pq.join_est_seq = []
        estimator = (ReplayEstimator(base_est, pq.join_seq)
                     if warm_replay else base_est)
        qs.plan_mode = cfg.plan_mode
        tel = JoinTelemetry()

        def record_join(impl, est, actual, retried, cap=0):
            qs.join_strategies[impl] = qs.join_strategies.get(impl, 0) + 1
            qs.join_retries += int(retried)
            if est is not None:
                qs.n_estimated_joins += 1
                qs.join_est_rows += int(est)
                qs.join_actual_rows += int(actual)
                err = math.log((est + 1) / (actual + 1))
                qs.join_est_log_err += abs(err)
                qs.join_est_log_bias += err
                if not warm_replay:
                    pq.join_seq.append((int(actual), int(cap), str(impl)))
                    pq.join_est_seq.append(int(est))
            # every estimator-sized join is a budget boundary: actual
            # output rows charge max_rows, the executed capacity is
            # checked against max_capacity, and the deadline is re-read
            checkpoint(rows=int(actual), cap=int(cap))

        comp_tables: list[Table] = []
        phase[0] = "match"
        for ci, (comp, trees) in enumerate(zip(pq.comps,
                                               pq.trees_per_comp)):
            with tracer.span("component", index=ci) as csp:
                if not query.component_edges(comp):
                    # isolated node(s)
                    tab = None
                    for q in comp:
                        t = single_node_table(q, int(iv[q, 0]),
                                              int(iv[q, 1]), pass_np[q],
                                              device=self.device)
                        tab = t if tab is None else injective_filter(
                            self._retry(cross_join, tab, t))
                    comp_tables.append(tab)
                    continue
                cand_tables = []
                for tr in trees:
                    tab = dtree_candidates(
                        self.graph, tr, pass_masks,
                        row_limit=self.cfg.max_rows,
                        join_impl=self.cfg.join_impl,
                        nested_max=self.cfg.thresholds.nested_join_max,
                        probe_impl=self._probe_impl(),
                        estimator=estimator.edge_join, record=record_join,
                        telemetry=tel, fuse=self.cfg.fuse_joins,
                        tracer=tracer, edges=self._edges())
                    qs.truncated |= tab.truncated
                    qs.dtree_work += tab.count
                    cand_tables.append(injective_filter(tab))
                counts = [t.count for t in cand_tables]
                if cfg.plan_mode == "cost" and len(cand_tables) > 1:
                    if ci in pq.comp_orders:
                        order = pq.comp_orders[ci]
                        pc, gc = pq.comp_costs[ci]
                    else:
                        greedy = join_order(trees, counts)
                        plan = plan_table_joins(
                            [set(tr.nodes) for tr in trees], counts,
                            base_est,
                            cfg.thresholds.nested_join_max,
                            sort_orders=[t.sort_order
                                         for t in cand_tables],
                            greedy_order=greedy)
                        order = plan.order
                        pc, gc = plan.est_cost, plan.greedy_cost
                        pq.comp_orders[ci] = order
                        pq.comp_costs[ci] = (pc, gc)
                    qs.plan_cost += pc
                    qs.greedy_plan_cost += gc
                else:
                    order = join_order(trees, counts)
                tab = cand_tables[order[0]]
                for i in order[1:]:
                    qs.join_work += (max(tab.count, 1)
                                     * max(cand_tables[i].count, 1))
                    tab = injective_filter(self._join(
                        tab, cand_tables[i], estimator,
                        row_limit=self.cfg.max_rows, record=record_join,
                        telemetry=tel))
                    qs.truncated |= tab.truncated
                if csp.live:
                    csp.set(rows=tab.count, trees=len(trees))
                comp_tables.append(tab)
                checkpoint(cap=tab.cap)
        qs.match_time = time.perf_counter() - t2

        # ---- connection edges ------------------------------------------
        t3 = time.perf_counter()
        phase[0] = "connections"
        with tracer.span("connections",
                         edges=len(query.connections)) as sp:
            final = self._process_connections(query, pq.comps,
                                              comp_tables, qs,
                                              record_join, tel, pq=pq,
                                              checkpoint=checkpoint)
            if sp.live:
                sp.set(rows=final.count)
        qs.conn_time = time.perf_counter() - t3
        qs.sorts_performed = tel.sorts_performed
        qs.sorts_avoided = tel.sorts_avoided

        pq.executions += 1
        qs.total_time = time.perf_counter() - t0
        rows = final.rows[: final.count].cpu().numpy()
        return MatchResult(cols=final.cols, rows=rows, stats=qs)

    # -------------------------------------------------------------- #
    def _edges(self) -> tuple:
        """The graph's (src, dst, pred) tensors on the engine's device,
        uploaded once per engine."""
        if "edges" not in self._dev_cache:
            self._dev_cache["edges"] = graph_edges(self.graph, self.device)
        return self._dev_cache["edges"]

    def _bloom_sigs(self) -> torch.Tensor:
        """The 1-hop bloom signatures on the engine's device: built on the
        host at first use and uploaded once per engine."""
        if "bloom" not in self._dev_cache:
            self._dev_cache["bloom"] = bits32(
                build_bloom(self.ni.entries[1])).to(self.device)
        return self._dev_cache["bloom"]

    def _probe_impl(self) -> str:
        """merge-probe kernel impl for sort-merge joins.  The 'ref' engine
        impl maps to the semantically identical searchsorted path: the
        O(A*B) probe oracle exists for kernel validation, not for running
        real joins."""
        impl = self.cfg.impl
        return "sorted" if impl == "ref" else impl

    def _join(self, a: Table, b: Table, estimator,
              row_limit: int | None = None, record=None,
              telemetry: JoinTelemetry | None = None) -> Table:
        """Planned equi-join: strategy by table size, capacity pre-sized
        from the stats-driven cardinality estimate, single exact-size
        retry on overflow."""
        shared = tuple(c for c in a.cols if c in b.cols)
        est = estimator.table_join(a.count, b.count, shared)
        return planned_join(a, b, est, row_limit=row_limit,
                            impl=self.cfg.join_impl,
                            nested_max=self.cfg.thresholds.nested_join_max,
                            probe_impl=self._probe_impl(), record=record,
                            telemetry=telemetry, fuse=self.cfg.fuse_joins,
                            tracer=self.tracer)

    def _retry(self, fn, *args, **kw):
        cap = None
        for _ in range(8):
            try:
                return fn(*args, **kw) if cap is None else fn(*args, cap=cap, **kw)
            except CapacityOverflow as e:
                cap = _pow2(e.needed)
        raise RuntimeError("capacity retry loop failed")

    def _process_connections(self, query: QueryTemplate, comps,
                             comp_tables: list[Table],
                             qs: QueryStats, record_join=None,
                             tel: JoinTelemetry | None = None,
                             pq: PreparedQuery | None = None,
                             checkpoint=None) -> Table:
        """Connection-edge evaluation (Alg. 3): intra filters first (linear
        in table size), then cross-component merges.  The merge order comes
        from planner.plan_connections (cost-based with per-edge
        reach-vs-cross pricing) under plan_mode='cost'; plan_mode='greedy'
        keeps the seed's dynamic smallest-current-product rule as an A/B
        baseline.  Each edge is evaluated either by the reach-join (no
        cross product, O(matches) output work) or the seed cross+filter
        path, per EngineConfig.connection_impl / the cost model.  A warm
        PreparedQuery supplies the cached edge order directly."""
        ck = checkpoint if checkpoint is not None else (lambda **kw: None)
        tables = list(comp_tables)
        owner = {}
        for i, comp in enumerate(comps):
            for q in comp:
                owner[q] = i
        group = list(range(len(tables)))       # table index per original comp
        # reach cache: connection edges sharing endpoint nodes (or
        # re-filtered after merges) reuse each other's reach sets; a
        # server-owned bounded cache extends the reuse across queries
        rcache = (self.reach_cache if self.reach_cache is not None
                  else ReachCache())
        n = self.graph.num_nodes
        cost_model = self.cfg.cost_model

        def find(i):
            while group[i] != i:
                group[i] = group[group[i]]
                i = group[i]
            return i

        # distinct endpoint values per (group root, column): one
        # device-to-host column sync + unique each, shared between the
        # plan-time feature pass and execution, invalidated when a
        # group's table is replaced (filter or merge)
        dvals: dict[tuple[int, int], np.ndarray] = {}

        # per-edge strategy: warm runs replay the choices recorded by the
        # first execution (same reason as join_seq — the live calibrated
        # cost model may have moved since, and a flipped strategy would
        # change the join call sequence the replay depends on)
        replay_impls = (pq.conn_impls
                        if pq is not None and pq.executions > 0
                        and pq.conn_impls else None)
        impl_cursor = [0]
        record_impls = ([] if pq is not None and replay_impls is None
                        else None)

        def edge_choice(count_a, count_b, a_vals, b_vals, c, intra):
            """(impl, sel, feat) for one connection edge.  Warm replays
            return the recorded impl without evaluating the cost model at
            all (sel/feat None) — both consumers of those values, the
            strategy choice and the calibration accrual, are disabled on
            the warm path, so computing endpoint_reach per edge there
            would be pure warm-latency overhead."""
            if replay_impls is not None \
                    and impl_cursor[0] < len(replay_impls):
                impl = replay_impls[impl_cursor[0]]
                impl_cursor[0] += 1
                return impl, None, None
            feat = conn_feat(a_vals, b_vals, c)
            sel = sel_of(c, a_vals, b_vals)
            impl = choose_connection_impl(
                count_a, count_b, feat, sel, n,
                impl=self.cfg.connection_impl, intra=intra,
                model=cost_model)
            if record_impls is not None:
                record_impls.append(impl)
            return impl, sel, feat

        def distinct_of(gi: int, col: int) -> np.ndarray:
            key = (gi, col)
            if key not in dvals:
                dvals[key] = distinct_column_values(tables[gi], col)
            return dvals[key]

        def invalidate(*groups: int) -> None:
            for k in [k for k in dvals if k[0] in groups]:
                del dvals[k]

        def conn_feat(a_vals: np.ndarray, b_vals: np.ndarray,
                      c) -> ConnFeatures:
            # candidate-aware reach: the first expansion hop uses the
            # actual degrees of the distinct endpoint candidates
            h_fwd, h_bwd = hop_split(c.max_dist)
            return ConnFeatures(len(a_vals), len(b_vals),
                                endpoint_reach(self.stats, n, h_fwd,
                                               a_vals, +1),
                                endpoint_reach(self.stats, n, h_bwd,
                                               b_vals, -1))

        def record_conn(impl: str, info: ReachJoinInfo,
                        sel: float | None,
                        feat: ConnFeatures | None) -> None:
            qs.conn_strategies[impl] = qs.conn_strategies.get(impl, 0) + 1
            qs.conn_reach_pairs += info.reach_pairs
            qs.conn_connected_pairs += info.connected_pairs
            qs.conn_endpoint_rows += info.rows_a + info.rows_b
            qs.conn_endpoint_distinct += info.distinct_a + info.distinct_b
            # predictions are accrued only for edges whose impl measures
            # the observed side (the cross path never fills
            # connected_pairs/reach_pairs) — otherwise every cross edge
            # would look like "predicted N, observed 0" to the Calibrator
            # and drag conn_sel_scale/reach_scale to the floor.  Warm
            # replays skip the cost model entirely (sel/feat None); the
            # Calibrator ignores warm stats anyway.
            if impl == "reach" and sel is not None:
                qs.conn_est_pairs += sel * info.distinct_a * info.distinct_b
                qs.conn_est_reach_pairs += (
                    info.distinct_a * feat.reach_fwd
                    + info.distinct_b * feat.reach_bwd)

        def sel_of(c, a_vals=None, b_vals=None) -> float:
            return connection_selectivity(self.stats, n, c.max_dist,
                                          c.bidirectional,
                                          a_nodes=a_vals, b_nodes=b_vals)

        tracer = self.tracer

        def intra_filter(gi: int, c) -> None:
            # no early-out on an empty table: both impls handle it, and
            # conn_strategies must count every connection edge processed
            with tracer.span("conn_edge", kind="intra") as sp:
                tab = tables[gi]
                a_vals = distinct_of(gi, c.src)
                b_vals = distinct_of(gi, c.dst)
                info = ReachJoinInfo(rows_a=tab.count, rows_b=tab.count,
                                     distinct_a=len(a_vals),
                                     distinct_b=len(b_vals))
                impl, sel, feat = edge_choice(tab.count, tab.count,
                                              a_vals, b_vals, c,
                                              intra=True)
                if impl == "reach":
                    tables[gi] = reach_filter(
                        self.graph, self.ni, tab, c.src, c.dst,
                        c.max_dist,
                        c.bidirectional, a_vals=a_vals, b_vals=b_vals,
                        impl=self.cfg.join_impl,
                        nested_max=self.cfg.thresholds.nested_join_max,
                        probe_impl=self._probe_impl(), cache=rcache,
                        telemetry=tel, record=record_join, info=info,
                        fuse=self.cfg.fuse_joins, tracer=tracer)
                else:
                    rows = tab.rows[: tab.count].cpu().numpy()
                    a = rows[:, tab.cols.index(c.src)]
                    b = rows[:, tab.cols.index(c.dst)]
                    keep = connectivity_mask(self.graph, self.ni, a, b,
                                             c.max_dist, c.bidirectional,
                                             impl=self.cfg.impl,
                                             cache=rcache)
                    tables[gi] = filter_rows(tab, keep)
                invalidate(gi)
                record_conn(impl, info, sel, feat)
                if sp.live:
                    sp.set(impl=impl, src=c.src, dst=c.dst,
                           max_dist=c.max_dist, rows=tables[gi].count,
                           reach_pairs=info.reach_pairs,
                           connected_pairs=info.connected_pairs)
                # connection-edge boundary: deadline + capacity re-check
                # (rows=0 — a filter materializes no new join rows)
                ck(cap=tables[gi].cap)

        def apply_connection(c) -> None:
            gi, gj = find(owner[c.src]), find(owner[c.dst])
            if gi == gj:
                # merged by an earlier join: now an intra filter
                intra_filter(gi, c)
                return
            with tracer.span("conn_edge", kind="merge") as sp:
                ta, tb = tables[gi], tables[gj]
                a_vals = distinct_of(gi, c.src)
                b_vals = distinct_of(gj, c.dst)
                info = ReachJoinInfo(rows_a=ta.count, rows_b=tb.count,
                                     distinct_a=len(a_vals),
                                     distinct_b=len(b_vals))
                impl, sel, feat = edge_choice(ta.count, tb.count,
                                              a_vals, b_vals, c,
                                              intra=False)
                if impl == "reach":
                    joined = injective_filter(reach_join(
                        self.graph, self.ni, ta, tb, c.src, c.dst,
                        c.max_dist,
                        c.bidirectional, a_vals=a_vals, b_vals=b_vals,
                        row_limit=self.cfg.max_rows,
                        impl=self.cfg.join_impl,
                        nested_max=self.cfg.thresholds.nested_join_max,
                        probe_impl=self._probe_impl(), cache=rcache,
                        telemetry=tel, record=record_join, info=info,
                        fuse=self.cfg.fuse_joins, tracer=tracer))
                    qs.join_work += info.reach_pairs + joined.count
                    qs.truncated |= joined.truncated
                else:
                    qs.join_work += max(ta.count, 1) * max(tb.count, 1)
                    joined = injective_filter(self._retry(
                        cross_join, ta, tb, row_limit=self.cfg.max_rows))
                    qs.truncated |= joined.truncated
                    # the cross path bypasses record_join, so charge its
                    # materialized rows to the budget here
                    ck(rows=joined.count, cap=joined.cap)
                    if joined.count:
                        rows = joined.rows[: joined.count].cpu().numpy()
                        a = rows[:, joined.cols.index(c.src)]
                        b = rows[:, joined.cols.index(c.dst)]
                        keep = connectivity_mask(self.graph, self.ni,
                                                 a, b,
                                                 c.max_dist,
                                                 c.bidirectional,
                                                 impl=self.cfg.impl,
                                                 cache=rcache)
                        joined = filter_rows(joined, keep)
                invalidate(gi, gj)
                record_conn(impl, info, sel, feat)
                group[gj] = gi
                tables[gi] = joined
                if sp.live:
                    sp.set(impl=impl, src=c.src, dst=c.dst,
                           max_dist=c.max_dist, rows=joined.count,
                           rows_a=info.rows_a, rows_b=info.rows_b,
                           reach_pairs=info.reach_pairs,
                           connected_pairs=info.connected_pairs)
                ck(cap=joined.cap)

        intra = [c for c in query.connections
                 if find(owner[c.src]) == find(owner[c.dst])]
        inter = [c for c in query.connections
                 if find(owner[c.src]) != find(owner[c.dst])]
        for c in intra:
            intra_filter(find(owner[c.src]), c)

        if inter and self.cfg.plan_mode == "cost":
            if pq is not None and pq.conn_order is not None:
                order, (pc, gc) = pq.conn_order, pq.conn_costs
            else:
                endpoints = [(find(owner[c.src]), find(owner[c.dst]))
                             for c in inter]
                sels = [sel_of(c, distinct_of(gi, c.src),
                               distinct_of(gj, c.dst))
                        for c, (gi, gj) in zip(inter, endpoints)]
                feats = [conn_feat(distinct_of(gi, c.src),
                                   distinct_of(gj, c.dst), c)
                         for c, (gi, gj) in zip(inter, endpoints)]
                plan = plan_connections([t.count for t in tables],
                                        endpoints, sels, feats=feats,
                                        num_nodes=n,
                                        impl=self.cfg.connection_impl,
                                        model=cost_model)
                order, pc, gc = plan.order, plan.est_cost, plan.greedy_cost
                if pq is not None:
                    pq.conn_order = list(order)
                    pq.conn_costs = (pc, gc)
            qs.plan_cost += pc
            qs.greedy_plan_cost += gc
            for k in order:
                apply_connection(inter[k])
        else:
            # seed baseline: smallest current candidate product first
            while inter:
                inter.sort(key=lambda c: tables[find(owner[c.src])].count
                           * tables[find(owner[c.dst])].count)
                apply_connection(inter.pop(0))

        if record_impls is not None:
            pq.conn_impls = record_impls

        # cross-join any remaining disconnected groups
        roots = sorted({find(i) for i in range(len(tables))})
        tab = tables[roots[0]]
        for r in roots[1:]:
            tab = injective_filter(self._retry(
                cross_join, tab, tables[r], row_limit=self.cfg.max_rows))
            qs.truncated |= tab.truncated
            ck(rows=tab.count, cap=tab.cap)
        return tab


# ---------------------------------------------------------------------- #
# Named engine variants (paper §6) — table lives in dataset.ENGINE_VARIANTS
# so Dataset.build can size the NI index without importing this module.
# ---------------------------------------------------------------------- #
def make_engine(dataset: "Dataset | RDFGraph", variant: str = "rdf_h",
                ni: NIIndex | None = None,
                stats: DatasetStats | None = None,
                thresholds: Thresholds | None = None,
                impl: str = "auto", device: str = "cuda") -> Engine:
    """Engine for a named paper variant over a ``Dataset``, on `device`.

    Passing a bare ``RDFGraph`` is deprecated: it wraps the graph in a
    version-0 Dataset (building the variant's NI index and stats) and
    emits a DeprecationWarning.  Construct the Dataset once and reuse it —
    that is also what unlocks ``apply_delta`` and the version-scoped
    serving caches."""
    if variant not in ENGINE_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    b = ENGINE_VARIANTS[variant]
    th = thresholds or Thresholds()
    cfg = EngineConfig(check_policy=b["policy"], d_check=b["d_check"],
                       impl=impl, thresholds=th, device=device)
    if isinstance(dataset, Dataset):
        if ni is not None or stats is not None:
            raise ValueError("pass ni/stats via the Dataset, "
                             "not alongside it")
        if dataset.ni.d_max < b["d_check"]:
            raise ValueError(
                f"variant {variant!r} checks {b['d_check']} hops but the "
                f"Dataset's NI index only stores {dataset.ni.d_max}")
        if b["var"] == "vc" and dataset.ni.variant != "vc":
            raise ValueError(f"variant {variant!r} needs a vertex-cover NI "
                             f"index (Dataset.build(ni_variant='vc'))")
        return Engine(dataset, cfg)
    warnings.warn(
        "make_engine(graph, ...) is deprecated; build a Dataset "
        "(Dataset.build(graph, variant=...)) and pass that instead",
        DeprecationWarning, stacklevel=2)
    ds = Dataset.build(dataset, variant=variant, ni=ni, stats=stats)
    return Engine(ds, cfg)
