"""RDF-ℏ selective pruning decision (§4.2, §4.3) and threshold tuning.

The planner decides, per query template, whether to run the neighborhood
check.  Signature pruning is used iff:

  (complexity)  any D-tree root's candidate-generation iteration count
                exceeds τ1, OR the estimated intermediate-join product
                exceeds τ2,
  AND
  (power)       some query node's Neighborhood Selectivity N_q >= τ3.

N_q = | Σ_{p_r in k-hop} ln s(p_r) + Σ_{p_a in k-hop} ln(s(p_a)·f_{n,p_a}) |
estimates -ln P(random node exhibits q's neighborhood), i.e. the expected
pruning power of checking q's neighborhood structure.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

import numpy as np

from .graph import RDFGraph, IDMap, ATTR
from .query import QueryTemplate
from .stats import DatasetStats
from .decompose import DTree
from .matching import choose_join_strategy, strategy_costs


@dataclass
class Thresholds:
    tau_iter: float = 1000.0       # τ1: D-tree candidate iterations
    tau_join: float = 1.0e6        # τ2: estimated intermediate joins
    tau_sel: float = 8.0           # τ3: min neighborhood selectivity
    nested_join_max: int = 256     # per-join: nested-loop below this size


@dataclass
class CostModel:
    """Multiplicative corrections to the planner's analytic cost model.

    All factors default to 1.0 (the hardcoded model); the serving layer's
    Calibrator learns them online from per-query QueryStats telemetry —
    the paper's 'when to use pruning' decision, adapted to the observed
    dataset instead of fixed constants.  Every factor only rescales an
    *estimate*, so any value yields identical query results.

      join_est_scale  multiplies JoinEstimator cardinalities (learned from
                      the signed join-estimate log error)
      conn_sel_scale  multiplies connection_selectivity estimates (learned
                      from observed vs. predicted connected-pair counts)
      reach_scale     scales the reach-join side of connection_edge_cost
      cross_scale     scales the cross+filter side — a MANUAL A/B knob
                      only: the cross path measures no observed
                      counterpart, so the Calibrator never learns it
    """
    join_est_scale: float = 1.0
    conn_sel_scale: float = 1.0
    reach_scale: float = 1.0
    cross_scale: float = 1.0


DEFAULT_COST_MODEL = CostModel()


@dataclass
class PlanDecision:
    use_check: bool
    complex_query: bool
    max_selectivity: float
    est_iterations: float
    est_join_product: float
    per_node_selectivity: dict[int, float] = field(default_factory=dict)


def neighborhood_selectivity(query: QueryTemplate, q: int,
                             stats: DatasetStats, k: int) -> float:
    """Def. 4.3 over the predicates within k query-hops of q (both
    directions, following template edges)."""
    comp = None
    for c in query.components():
        if q in c:
            comp = set(c)
            break
    assert comp is not None
    # undirected BFS distances within the template, then take every edge
    # with an endpoint at distance <= k-1 from q (its predicate is visible
    # to a k-hop neighborhood check).
    dist = {q: 0}
    comp_edges = [e for e in query.edges if e.src in comp and e.dst in comp]
    for step in range(1, k + 1):
        for e in comp_edges:
            for a, b in ((e.src, e.dst), (e.dst, e.src)):
                if a in dist and dist[a] == step - 1 and b not in dist:
                    dist[b] = step
    inf = k + 1
    seen_edges = [e for e in comp_edges
                  if min(dist.get(e.src, inf), dist.get(e.dst, inf)) <= k - 1]
    total = 0.0
    for e in seen_edges:
        if e.pred is None:
            continue  # wildcard predicate: selectivity 1, ln 1 = 0
        s = float(stats.pred_selectivity[e.pred])
        if s <= 0:
            s = 1.0 / 1e9
        if len(stats.literal_selectivity.get(e.pred, {})):
            n = len(query.keywords[e.dst])
            f = stats.lit_sel(e.pred, max(n, 1))
            total += math.log(max(s * f, 1e-300))
        else:
            total += math.log(s)
    return abs(total)


def estimate_complexity(trees: list[DTree], cand_sizes: dict[int, int]):
    """(max iterations over D-trees, product of root candidate sizes)."""
    iters = [cand_sizes.get(t.root, 0) for t in trees]
    max_iter = max(iters) if iters else 0
    prod = 1.0
    for i in iters:
        prod *= max(i, 1)
    return float(max_iter), float(prod)


def decide(query: QueryTemplate, trees_per_comp: list[list[DTree]],
           cand_sizes: dict[int, int], stats: DatasetStats,
           th: Thresholds, k: int) -> PlanDecision:
    max_iter, prod = 0.0, 1.0
    for trees in trees_per_comp:
        mi, pr = estimate_complexity(trees, cand_sizes)
        max_iter = max(max_iter, mi)
        prod *= pr
    complex_query = (max_iter > th.tau_iter) or (prod > th.tau_join)
    per_node = {q: neighborhood_selectivity(query, q, stats, k)
                for q in range(query.num_nodes)}
    max_sel = max(per_node.values()) if per_node else 0.0
    return PlanDecision(
        use_check=bool(complex_query and max_sel >= th.tau_sel),
        complex_query=bool(complex_query),
        max_selectivity=float(max_sel),
        est_iterations=max_iter,
        est_join_product=prod,
        per_node_selectivity=per_node,
    )


def decision_terms(decision: PlanDecision, th: Thresholds) -> list[dict]:
    """The §4.3 decision decomposed into its three τ comparisons, for
    EXPLAIN rendering and decision audits.  Each term: {name, value, op,
    tau, threshold, hit} — `hit` is whether that comparison fired in the
    direction that pushes toward use_check=True (the complex terms are
    OR-ed, the power term is AND-ed; see `decide`)."""
    return [
        {"name": "complex/iterations", "value": float(decision.est_iterations),
         "op": ">", "tau": "τ_iter", "threshold": float(th.tau_iter),
         "hit": decision.est_iterations > th.tau_iter},
        {"name": "complex/join_product",
         "value": float(decision.est_join_product),
         "op": ">", "tau": "τ_join", "threshold": float(th.tau_join),
         "hit": decision.est_join_product > th.tau_join},
        {"name": "power/max_selectivity",
         "value": float(decision.max_selectivity),
         "op": ">=", "tau": "τ_sel", "threshold": float(th.tau_sel),
         "hit": decision.max_selectivity >= th.tau_sel},
    ]


class JoinEstimator:
    """Stats-driven join-cardinality estimates (§4.1 features reused for
    execution planning).

    The engine uses these to pre-size join capacities so the
    CapacityOverflow -> recompile retry loop becomes the exception;
    estimator accuracy is recorded in QueryStats per query."""

    def __init__(self, stats: DatasetStats, cand_sizes: dict[int, int],
                 scale: float = 1.0):
        self.stats = stats
        self.cand_sizes = cand_sizes
        self.scale = float(scale)      # calibrated correction (CostModel)

    def edge_join(self, left_count: int, pred: int | None, outgoing: bool,
                  pair_count: int) -> int:
        """Candidate table joined with the edge table of `pred` on the
        D-tree root column: expected rows ~= left * per-endpoint fanout."""
        st = self.stats
        if st is None or st.src_fanout is None or pred is None:
            fan = st.avg_fanout if st is not None else 1.0
        else:
            fan = float((st.src_fanout if outgoing else st.dst_fanout)[pred])
        return int(left_count * max(fan, 1.0) * self.scale) + 1

    def table_join(self, a_count: int, b_count: int,
                   shared_cols: tuple[int, ...]) -> int:
        """System R equi-join estimate: |A J B| = |A||B| / V(key), with
        V(key) approximated by the smallest candidate-interval size among
        the shared query nodes, capped by both table sizes."""
        if not shared_cols:
            return a_count * b_count
        v = min(self.cand_sizes.get(q, 1) for q in shared_cols)
        v = max(1, min(v, max(a_count, 1), max(b_count, 1)))
        return int(a_count * b_count * self.scale / v) + 1


class CapEstimate(int):
    """A join-size estimate that also carries the exact pow2 capacity the
    cold run executed that join at — and, when recorded, the join
    strategy it resolved to.  Behaves as the row-count int in all
    arithmetic (min with row_limit, telemetry sums); matching.planned_join
    reads `.cap` to pin the output allocation and `.impl` to pin the
    strategy, so warm run 1 reuses the cold run's steady-state capacities
    and join strategies instead of re-deriving them (which could diverge
    when the cold run took an overflow retry)."""

    def __new__(cls, rows: int, cap: int, impl: str | None = None):
        obj = super().__new__(cls, int(rows))
        obj.cap = int(cap)
        obj.impl = impl
        return obj


class ReplayEstimator:
    """Exact 'estimates' for warm plan-cache executions.

    A query template run against an immutable dataset is deterministic, so
    the join sizes observed on the first execution (PreparedQuery.join_seq,
    recorded in engine call order) ARE the cardinalities of every later
    execution.  Replaying them pre-sizes each join capacity exactly — no
    CapacityOverflow retries and the same table capacities on every warm
    run.  Recorded entries are
    (rows, cap, impl) triples — replayed as `CapEstimate` so the executed
    *capacity* and *join strategy* (not just the row count) are pinned
    too; (rows, cap) pairs and bare-int entries from older recordings
    still replay with whatever they carry.  Falls back to the analytic
    estimator if the call sequence ever diverges (e.g. a row_limit
    change).
    """

    def __init__(self, base: JoinEstimator, recorded: list):
        self.base = base
        self.recorded = recorded
        self.cursor = 0

    def _next(self, fallback: int) -> int:
        if self.cursor < len(self.recorded):
            out = self.recorded[self.cursor]
            self.cursor += 1
            if isinstance(out, tuple):
                return CapEstimate(out[0], out[1],
                                   out[2] if len(out) > 2 else None)
            return out
        return fallback

    def edge_join(self, left_count: int, pred: int | None, outgoing: bool,
                  pair_count: int) -> int:
        return self._next(self.base.edge_join(left_count, pred, outgoing,
                                              pair_count))

    def table_join(self, a_count: int, b_count: int,
                   shared_cols: tuple[int, ...]) -> int:
        return self._next(self.base.table_join(a_count, b_count,
                                               shared_cols))


# ---------------------------------------------------------------------- #
# Whole-query join planning: cost-based join ordering over a component's
# D-tree candidate tables (Selinger-style DP over the System-R estimates
# JoinEstimator already provides) and over the cross-component connection
# edges.  The cost model knows about sort-run reuse: a sort-merge join
# whose left side is already ordered by the join key skips that sort, so
# orders that chain joins on the same key are cheaper.
# ---------------------------------------------------------------------- #
_LOG2 = math.log(2.0)
_PLAN_DP_MAX = 10           # exhaustive subset-DP up to this many tables
_CONN_PERM_MAX = 6          # exhaustive permutations up to this many edges


def _sort_cost(n: int) -> float:
    n = max(int(n), 1)
    return n * math.log(max(n, 2)) / _LOG2


def _pairwise_join_cost(left_rows: int, right_rows: int, est_out: int,
                        nested_max: int, left_sorted: bool,
                        right_sorted: bool, n_shared: int = 1) -> float:
    """Work proxy (row ops) for one equi-join under the engine's strategy
    rule — priced by the SAME matching.strategy_costs the executor's
    'auto' resolution uses (nested-loop below nested_max; sort-merge
    where each unsorted side pays a weighted n log n sort; radix-hash
    where only the build side pays a sort), plus the est_out expand."""
    impl = choose_join_strategy(left_rows, right_rows, nested_max,
                                a_sorted=left_sorted,
                                b_sorted=right_sorted, n_shared=n_shared)
    costs = strategy_costs(left_rows, right_rows, a_sorted=left_sorted,
                           b_sorted=right_sorted, n_shared=n_shared)
    if impl == "nested":
        return costs["nested"]
    return costs[impl] + float(est_out)


@dataclass
class PlannedStep:
    """One join in a component plan: table `index` is merged into the
    accumulated table."""
    index: int
    est_rows: int               # estimated accumulated rows after the join
    est_cost: float             # estimated cost of this join
    key_cols: tuple[int, ...]   # shared query nodes joined on ('' = cross)
    reuses_sort: bool           # left side's order makes the sort skippable


@dataclass
class JoinPlan:
    """Cost-based join order for one component's candidate tables, plus
    the greedy baseline evaluated under the same cost model (telemetry:
    planned vs. greedy cost lands in QueryStats)."""
    order: list[int]
    steps: list[PlannedStep]
    est_cost: float
    greedy_order: list[int]
    greedy_cost: float


def _reusable(sort_key: tuple[int, ...] | None,
              shared: tuple[int, ...]) -> bool:
    """Mirror of matching._reuse_key_order: the join may permute its key
    columns, so a sorted run is reusable iff the first |shared| sorted
    columns are exactly the shared set."""
    return (sort_key is not None and len(sort_key) >= len(shared)
            and set(sort_key[: len(shared)]) == set(shared)
            and len(shared) > 0)


def _join_step(rows, skey, count_i, order_i, shared, est_out, nested_max,
               larger_is_left: bool | None = None):
    """One simulated join: (cost, next sort key, left_reused).

    Mirrors execution fidelity: the nested regime produces an untagged
    table (no downstream reuse); the radix regime never sorts and its
    output keeps the LEFT side's order; and when both sides are sorted
    under *conflicting* permutations of a multi-column key, the executor
    can align the join key with only one of them — credit the larger
    side."""
    left_ok = _reusable(skey, shared)
    right_ok = _reusable(order_i, shared)
    if (left_ok and right_ok and len(shared) > 1
            and tuple(skey[: len(shared)]) != tuple(order_i[: len(shared)])):
        if larger_is_left is None:
            larger_is_left = rows >= count_i
        left_ok, right_ok = larger_is_left, not larger_is_left
    c = _pairwise_join_cost(rows, count_i, est_out, nested_max,
                            left_sorted=left_ok, right_sorted=right_ok,
                            n_shared=len(shared))
    if not shared:
        return c, skey, False  # cross_join propagates the left order
    impl = choose_join_strategy(rows, count_i, nested_max,
                                a_sorted=left_ok, b_sorted=right_ok,
                                n_shared=len(shared))
    if impl == "sorted":
        next_key = shared       # merge output is ordered by the join key
    elif impl == "radix":
        next_key = skey         # probe side's order is preserved
    else:
        next_key = None         # nested output is untagged
    return c, next_key, left_ok and impl == "sorted"


def simulate_join_order(order, node_sets, counts, estimator: JoinEstimator,
                        nested_max: int,
                        sort_orders=None) -> tuple[float, list[PlannedStep]]:
    """Evaluate a join order under the cost model; returns (cost, steps)."""
    if sort_orders is None:
        sort_orders = [None] * len(node_sets)
    steps: list[PlannedStep] = []
    first = order[0]
    rows = counts[first]
    nodes = set(node_sets[first])
    skey = sort_orders[first]
    cost = 0.0
    for i in order[1:]:
        shared = tuple(sorted(nodes & node_sets[i]))
        est_out = estimator.table_join(rows, counts[i], shared)
        c, skey, reused = _join_step(rows, skey, counts[i], sort_orders[i],
                                     shared, est_out, nested_max)
        cost += c
        steps.append(PlannedStep(index=i, est_rows=est_out, est_cost=c,
                                 key_cols=shared, reuses_sort=reused))
        rows = est_out
        nodes |= node_sets[i]
    return cost, steps


def plan_table_joins(node_sets: list[set[int]], counts: list[int],
                     estimator: JoinEstimator, nested_max: int,
                     sort_orders=None,
                     greedy_order: list[int] | None = None) -> JoinPlan:
    """Pick a cost-based join order over a component's candidate tables.

    Selinger-style DP over subsets (exact up to _PLAN_DP_MAX tables, one
    best state kept per subset), falling back to greedy-by-marginal-cost
    beyond that.  `greedy_order` (the seed's smallest-candidate-first
    order) is evaluated under the same model for comparison telemetry."""
    n = len(node_sets)
    node_sets = [set(s) for s in node_sets]
    if sort_orders is None:
        sort_orders = [None] * n
    if greedy_order is None:
        greedy_order = list(range(n))
    if n <= 1:
        order = list(range(n))
        return JoinPlan(order=order, steps=[], est_cost=0.0,
                        greedy_order=list(greedy_order), greedy_cost=0.0)

    def run(order):
        return simulate_join_order(order, node_sets, counts, estimator,
                                   nested_max, sort_orders)

    greedy_cost, _ = run(greedy_order)

    if n <= _PLAN_DP_MAX:
        # best[mask] = (cost, est_rows, order, sort_key)
        best: dict[int, tuple] = {
            1 << i: (0.0, counts[i], (i,), sort_orders[i])
            for i in range(n)}
        full = (1 << n) - 1
        # every nonempty subset is reachable by adding one table at a
        # time, so processing masks in popcount order visits each state
        # after all of its predecessors
        for mask in sorted(range(1, full + 1),
                           key=lambda m: (bin(m).count("1"), m)):
            cost, rows, order, skey = best[mask]
            nodes = set().union(*(node_sets[j] for j in order))
            for i in range(n):
                bit = 1 << i
                if mask & bit:
                    continue
                shared = tuple(sorted(nodes & node_sets[i]))
                est_out = estimator.table_join(rows, counts[i], shared)
                c, nkey, _ = _join_step(rows, skey, counts[i],
                                        sort_orders[i], shared, est_out,
                                        nested_max)
                nk = mask | bit
                if nk not in best or cost + c < best[nk][0]:
                    best[nk] = (cost + c, est_out, order + (i,), nkey)
        _, _, order, _ = best[full]
        order = list(order)
    else:
        # greedy by marginal cost (connected tables win automatically:
        # cross products estimate as |A|x|B|)
        remaining = set(range(n))
        start = min(remaining, key=lambda i: counts[i])
        order = [start]
        remaining.discard(start)
        rows, nodes, skey = counts[start], set(node_sets[start]), \
            sort_orders[start]
        while remaining:
            def marginal(i):
                shared = tuple(sorted(nodes & node_sets[i]))
                est_out = estimator.table_join(rows, counts[i], shared)
                return _join_step(rows, skey, counts[i], sort_orders[i],
                                  shared, est_out, nested_max)[0]
            i = min(remaining, key=marginal)
            shared = tuple(sorted(nodes & node_sets[i]))
            est_out = estimator.table_join(rows, counts[i], shared)
            _, skey, _ = _join_step(rows, skey, counts[i], sort_orders[i],
                                    shared, est_out, nested_max)
            rows = est_out
            nodes |= node_sets[i]
            order.append(i)
            remaining.discard(i)
    est_cost, steps = run(order)
    return JoinPlan(order=order, steps=steps, est_cost=est_cost,
                    greedy_order=list(greedy_order),
                    greedy_cost=greedy_cost)


@dataclass
class ConnFeatures:
    """Cardinality features of one connection edge for the reach-join
    cost model: distinct endpoint nodes per side and expected reach-set
    sizes (stats.expected_reach) for the hop split of its d_c."""
    distinct_a: int
    distinct_b: int
    reach_fwd: float
    reach_bwd: float


def connection_edge_cost(size_a: float, size_b: float, feat: ConnFeatures,
                         sel: float, num_nodes: int,
                         intra: bool = False,
                         model: CostModel | None = None) -> tuple[float, float]:
    """(cross_cost, reach_cost) work proxies for one connection edge.

    Both strategies build the reach sets of the distinct endpoints once
    (connectivity_mask memoizes per node), so that term (pa + pb) is
    billed to both.  On top of it, cross+filter pays one set
    intersection per PAIR — the full product |A|x|B| (an intra edge
    degenerates to a linear scan); reach-join instead pays sorting the
    pair tables, the merge on reach_id (expected key matches ~
    |Pa|*|Pb|/n for independent uniform reach sets), the dedup sort of
    the match stream, and the two output-bounded equi-joins
    (sort + merge + expand).

    `model` (CostModel) applies the calibrated corrections: sel is scaled
    by conn_sel_scale, and the returned (cross, reach) costs by
    cross_scale / reach_scale respectively."""
    model = model if model is not None else DEFAULT_COST_MODEL
    sel = min(1.0, sel * model.conn_sel_scale)
    sa, sb = max(float(size_a), 1.0), max(float(size_b), 1.0)
    if intra:
        pairs = sa
        out = sa * sel
        joins = _sort_cost(sa) + sa + out       # ONE semi-join of the table
    else:
        pairs = sa * sb
        out = sa * sb * sel
        joins = (_sort_cost(sa) + _sort_cost(sb)    # equi-join sorts
                 + sa + sb + 2.0 * out)             # merges + expands
    pa = max(feat.distinct_a, 1) * max(feat.reach_fwd, 1.0)
    pb = max(feat.distinct_b, 1) * max(feat.reach_bwd, 1.0)
    matches = pa * pb / max(num_nodes, 1)
    cross = pa + pb + pairs
    reach = (pa + pb + _sort_cost(pa) + _sort_cost(pb)     # pair tables
             + matches + _sort_cost(max(matches, 1.0))     # merge + dedup
             + joins)
    return cross * model.cross_scale, reach * model.reach_scale


def choose_connection_impl(size_a: float, size_b: float, feat: ConnFeatures,
                           sel: float, num_nodes: int, impl: str = "auto",
                           intra: bool = False,
                           model: CostModel | None = None) -> str:
    """Per-edge strategy choice mirroring matching.resolve_join_impl:
    'auto' picks the cheaper of cross+filter and reach-join under the
    shared work-proxy model; explicit impls force the strategy (A/B)."""
    if impl in ("cross", "reach"):
        return impl
    cross, reach = connection_edge_cost(size_a, size_b, feat, sel,
                                        num_nodes, intra=intra, model=model)
    return "reach" if reach < cross else "cross"


@dataclass
class ConnectionPlan:
    """Cost-based processing order for inter-component connection edges
    (indices into the engine's `inter` list), with the greedy
    smallest-product baseline costed under the same model."""
    order: list[int]
    est_cost: float
    greedy_cost: float


class _GroupSim:
    """Union-find over component groups with estimated sizes — the single
    source of the merge bookkeeping shared by the cost simulation and the
    greedy baseline (so the two stay comparable by construction)."""

    def __init__(self, sizes):
        self.parent = list(range(len(sizes)))
        self.size = [float(s) for s in sizes]

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def product(self, i, j):
        """The seed's sort key: product of the two groups' current sizes
        (same-group edges square their size, exactly as the engine's
        greedy rule computes it)."""
        gi, gj = self.find(i), self.find(j)
        return max(self.size[gi], 1.0) * max(self.size[gj], 1.0)

    def apply(self, i, j, sel):
        """Process one connection edge; returns its estimated work."""
        gi, gj = self.find(i), self.find(j)
        if gi == gj:
            cost = self.size[gi]
            self.size[gi] = max(self.size[gi] * sel, 1.0)
            return cost
        prod = max(self.size[gi], 1.0) * max(self.size[gj], 1.0)
        self.parent[gj] = gi
        self.size[gi] = max(prod * sel, 1.0)
        return prod


def _sim_edge_cost(sim: _GroupSim, i, j, sel, feat, num_nodes, impl,
                   model: CostModel | None = None):
    """Cost of processing one connection edge at the sim's current group
    sizes, under the engine's strategy rule: cross+filter work when no
    features are given (legacy model / forced cross), reach-join work when
    forced, min of both under 'auto' (mirroring the execution choice)."""
    gi, gj = sim.find(i), sim.find(j)
    intra = gi == gj
    sa, sb = sim.size[gi], sim.size[gj]
    cross = sa if intra else max(sa, 1.0) * max(sb, 1.0)
    if feat is None or impl == "cross":
        return cross
    c, r = connection_edge_cost(sa, sb, feat, sel, num_nodes, intra=intra,
                                model=model)
    return r if impl == "reach" else min(c, r)


def _simulate_conn_order(order, sizes, endpoints, sels, feats=None,
                         num_nodes: int = 0, impl: str = "cross",
                         model: CostModel | None = None):
    """Total estimated work for processing connection edges in `order`
    under the per-edge strategy rule (_sim_edge_cost).  Estimated group
    size after a connection is product * selectivity regardless of the
    strategy (both produce the same result set)."""
    sim = _GroupSim(sizes)
    total = 0.0
    for idx in order:
        i, j = endpoints[idx]
        total += _sim_edge_cost(sim, i, j, sels[idx],
                                None if feats is None else feats[idx],
                                num_nodes, impl, model)
        sim.apply(i, j, sels[idx])
    return total


def _greedy_conn_order(sizes, endpoints, sels):
    """The seed engine's rule: repeatedly take the edge whose current group
    product is smallest (simulated sizes, same model as the planner)."""
    sim = _GroupSim(sizes)
    remaining = list(range(len(endpoints)))
    order = []
    while remaining:
        remaining.sort(key=lambda k: sim.product(*endpoints[k]))
        k = remaining.pop(0)
        order.append(k)
        sim.apply(*endpoints[k], sels[k])
    return order


def plan_connections(sizes: list[int], endpoints: list[tuple[int, int]],
                     sels: list[float], feats: list[ConnFeatures] | None = None,
                     num_nodes: int = 0,
                     impl: str = "auto",
                     model: CostModel | None = None) -> ConnectionPlan:
    """Order the inter-component connection edges to minimize estimated
    work.  endpoints[k] are group indices into `sizes`; sels[k] the
    connection's estimated selectivity (stats.connection_selectivity);
    feats[k] (optional) the reach-join cardinality features — when given,
    each edge is priced at the cheaper of cross+filter and reach-join
    under `impl` ('auto'/'reach'/'cross'), mirroring the engine's per-edge
    strategy choice; without them the legacy cross-product model applies.
    Exhaustive over permutations for up to _CONN_PERM_MAX edges
    (connection counts are tiny), else greedy by marginal simulated
    cost."""
    m = len(endpoints)

    def cost(order):
        return _simulate_conn_order(order, sizes, endpoints, sels,
                                    feats, num_nodes, impl, model)

    greedy = _greedy_conn_order(sizes, endpoints, sels)
    greedy_cost = cost(greedy)
    if m <= 1:
        return ConnectionPlan(order=greedy, est_cost=greedy_cost,
                              greedy_cost=greedy_cost)
    if m <= _CONN_PERM_MAX:
        best, best_cost = greedy, greedy_cost
        for perm in itertools.permutations(range(m)):
            c = cost(perm)
            if c < best_cost:
                best, best_cost = list(perm), c
        return ConnectionPlan(order=list(best), est_cost=best_cost,
                              greedy_cost=greedy_cost)
    # greedy by marginal cost of the next edge
    remaining = set(range(m))
    order: list[int] = []
    while remaining:
        k = min(remaining, key=lambda k: cost(order + [k]))
        order.append(k)
        remaining.discard(k)
    return ConnectionPlan(order=order, est_cost=cost(order),
                          greedy_cost=greedy_cost)


def tune_thresholds(run_query, queries: list[QueryTemplate],
                    grid_iter=(100.0, 1000.0, 10000.0),
                    grid_join=(1e4, 1e6, 1e8),
                    grid_sel=(4.0, 8.0, 16.0)) -> Thresholds:
    """Grid-search thresholds minimizing total runtime proxy over a sampled
    workload.  `run_query(query, thresholds) -> cost` is engine-supplied
    (wall time or work counter).  Mirrors the paper's offline tuning [28]."""
    best, best_cost = None, float("inf")
    for ti in grid_iter:
        for tj in grid_join:
            for ts in grid_sel:
                th = Thresholds(ti, tj, ts)
                cost = 0.0
                for q in queries:
                    cost += run_query(q, th)
                if cost < best_cost:
                    best, best_cost = th, cost
    return best or Thresholds()
