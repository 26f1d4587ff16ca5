"""Dataset features (§4.1) and dataset evaluation metrics (§5).

  * predicate selectivity s(p) = |p| / |E|
  * literal selectivity  f_{n,p_a} = m_{n,p_a} / |l(p_a)|
  * dataset coherence (Duan et al. structuredness, coverage-weighted)
  * relationship specialty (occurrence-kurtosis, weighted by |r|)
  * literal diversity (unique words in an M-sample of attribute literals)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import RDFGraph, ATTR, REL, RESOURCE


@dataclass
class DatasetStats:
    pred_selectivity: np.ndarray              # [P] float64
    literal_selectivity: dict[int, dict[int, float]]  # pa -> n -> f
    coherence: float
    specialty: float
    diversity: int
    type_pred: int | None = None
    # join-cardinality features: edges of p per distinct subject/object —
    # the expected fanout when a candidate table is joined with p's edge
    # table on the subject (src) or object (dst) side.
    src_fanout: np.ndarray | None = None      # [P] float64
    dst_fanout: np.ndarray | None = None      # [P] float64
    avg_fanout: float = 1.0                   # fallback for wildcard preds
    # per-node degrees: the first hop of a reach expansion from a known
    # candidate set uses the candidates' actual degrees instead of the
    # global average — on hub-heavy graphs the two differ by orders of
    # magnitude, and connection-edge cost estimates inherit the gap.
    out_degree: np.ndarray | None = None      # [N] float64
    in_degree: np.ndarray | None = None       # [N] float64

    def lit_sel(self, pa: int, n: int) -> float:
        table = self.literal_selectivity.get(pa)
        if not table:
            return 1.0
        if n in table:
            return table[n]
        ks = sorted(table)
        if n < ks[0]:
            return table[ks[0]]
        return table[ks[-1]]


def expected_reach(stats: DatasetStats, num_nodes: int, hops: int) -> float:
    """Expected reach-set size within `hops` hops of a random node: the
    geometric fanout series sum_{i<=h} avg_fanout^i, capped at |N|.
    Shared by connection_selectivity and the planner's reach-join cost
    model (pair-table sizes ~= distinct_endpoints * expected_reach)."""
    fan = max(float(stats.avg_fanout), 1.0)
    n = float(max(num_nodes, 1))
    return min(n, float(sum(fan ** i for i in range(max(hops, 0) + 1))))


def endpoint_reach(stats: DatasetStats, num_nodes: int, hops: int,
                   nodes: np.ndarray | None = None,
                   sign: int = +1) -> float:
    """Candidate-aware expected reach-set size: the first expansion hop
    uses the *actual* mean out-degree (sign=+1) or in-degree (sign=-1) of
    the given endpoint candidate nodes; later hops fall back to the global
    average fanout.

      R(h) = 1 + d1 * sum_{i<h} fan^i      (capped at |N|)

    With d1 == avg_fanout this collapses to expected_reach exactly, so
    callers without candidate values lose nothing.  On hub-heavy graphs a
    hub endpoint (d1 >> avg) gets the large reach estimate it deserves and
    a leaf endpoint a small one — which is what lets ConnectionPlan order
    hub edges after selective ones."""
    n = float(max(num_nodes, 1))
    if hops <= 0:
        return 1.0
    fan = max(float(stats.avg_fanout), 1.0)
    deg = stats.out_degree if sign > 0 else stats.in_degree
    if nodes is None or deg is None or len(nodes) == 0:
        d1 = fan
    else:
        d1 = float(np.mean(deg[np.asarray(nodes, dtype=np.int64)]))
    d1 = max(d1, 0.0)
    series = float(sum(fan ** i for i in range(hops)))   # 1 + fan + ...
    return min(n, 1.0 + d1 * series)


def connection_selectivity(stats: DatasetStats, num_nodes: int, d_c: int,
                           bidirectional: bool = False,
                           a_nodes: np.ndarray | None = None,
                           b_nodes: np.ndarray | None = None) -> float:
    """P(random node pair is connected within d_c hops) — the cardinality
    feature the whole-query join plan uses to order connection edges.

    Mirrors Algorithm 3's split: a forward reach set within ceil(d_c/2)
    hops must intersect a backward reach set within the remaining hops.
    Expected reach-set sizes come from endpoint_reach: candidate-aware
    (mean degree of the actual endpoint candidates for the first hop) when
    a_nodes/b_nodes are given, the global geometric fanout series
    otherwise.  Two independent uniform sets of sizes R_f, R_b over n
    nodes intersect with probability ~= R_f * R_b / n."""
    from .connectivity import hop_split
    h_fwd, h_bwd = hop_split(d_c)
    n = max(num_nodes, 1)
    sel = min(1.0, endpoint_reach(stats, n, h_fwd, a_nodes, +1)
              * endpoint_reach(stats, n, h_bwd, b_nodes, -1) / n)
    if bidirectional:
        sel = min(1.0, 2.0 * sel)
    return max(sel, 1.0 / (float(n) * n))


def predicate_selectivity(graph: RDFGraph) -> np.ndarray:
    counts = np.bincount(graph.pred, minlength=graph.num_predicates)
    return counts / max(graph.num_edges, 1)


def predicate_fanout(graph: RDFGraph) -> tuple[np.ndarray, np.ndarray, float]:
    """Per-predicate join fanout: |edges(p)| / #distinct src(p) (and dst).

    Feeds the sort-merge join planner's cardinality estimates: joining a
    table on node column q with the edge table of p multiplies its size by
    roughly this factor."""
    p_count = graph.num_predicates
    counts = np.bincount(graph.pred, minlength=p_count).astype(np.float64)
    src_fan = np.ones(p_count)
    dst_fan = np.ones(p_count)
    for ends, fan in ((graph.src, src_fan), (graph.dst, dst_fan)):
        pairs = np.unique(graph.pred.astype(np.int64) * (graph.num_nodes + 1)
                          + ends.astype(np.int64))
        distinct = np.bincount((pairs // (graph.num_nodes + 1)).astype(int),
                               minlength=p_count).astype(np.float64)
        np.divide(counts, np.maximum(distinct, 1.0), out=fan,
                  where=counts > 0)
    avg = float(graph.num_edges / max(graph.num_nodes, 1))
    return src_fan, dst_fan, max(avg, 1.0)


def node_degrees(graph: RDFGraph) -> tuple[np.ndarray, np.ndarray]:
    """Per-node (out_degree, in_degree) over all edges — the first-hop
    branching factors endpoint_reach uses for candidate-aware reach."""
    out_deg = np.bincount(graph.src, minlength=graph.num_nodes)
    in_deg = np.bincount(graph.dst, minlength=graph.num_nodes)
    return out_deg.astype(np.float64), in_deg.astype(np.float64)


def literal_selectivity(graph: RDFGraph, ns=(1, 2, 3, 4, 5, 6, 8),
                        sample: int = 20000,
                        seed: int = 0,
                        preds=None) -> dict[int, dict[int, float]]:
    """f_{n,pa}: avg #literals of pa matching a prefix n-gram, over the set
    of prefix n-grams of pa's literals, normalized by #unique literals.

    preds: optional predicate-id subset to compute.  The sampling rng is
    seeded per predicate, so a single predicate's table is identical
    whether computed alone (delta patching) or in a full pass.
    """
    out: dict[int, dict[int, float]] = {}
    for pa in (range(graph.num_predicates) if preds is None else preds):
        if graph.pred_kind[pa] != ATTR:
            continue
        mask = graph.pred == pa
        lits = np.unique(graph.dst[mask])
        labels = graph.labels[lits]
        if len(labels) > sample:
            rng = np.random.default_rng((seed, int(pa)))
            labels = rng.choice(labels, size=sample, replace=False)
        if len(labels) == 0:
            continue
        table = {}
        for n in ns:
            prefixes = np.asarray([s[:n] for s in labels])
            uniq, counts = np.unique(prefixes, return_counts=True)
            # avg #literals matching a prefix n-gram
            m = counts.mean()
            table[n] = float(m / len(labels))
        out[pa] = table
    return out


def _find_type_predicate(graph: RDFGraph) -> int | None:
    for name in ("type", "rdf:type", "a", "isA"):
        hits = np.nonzero(graph.predicates == name)[0]
        if len(hits):
            return int(hits[0])
    return None


def coherence_terms(graph: RDFGraph, type_pred: int,
                    types=None) -> dict[int, tuple[float, float]]:
    """Per-type coherence terms {type_id: (weight, coverage)}.

    ``types`` restricts computation to a subset (delta patching); types with
    no members or no member edges contribute no term, matching the skips of
    the historical single-pass loop."""
    tmask = graph.pred == type_pred
    inst, typ = graph.src[tmask], graph.dst[tmask]
    # predicates set per instance (excluding type edges)
    emask = ~tmask
    esrc, epred = graph.src[emask], graph.pred[emask]

    terms: dict[int, tuple[float, float]] = {}
    for t in (np.unique(typ) if types is None else types):
        members = inst[typ == t]
        if len(members) == 0:
            continue
        sel = np.isin(esrc, members)
        if not sel.any():
            continue
        ps, pinv = np.unique(epred[sel], return_inverse=True)
        ss = esrc[sel]
        # OC(p, T): #instances of T with >=1 edge of p
        pairs = np.unique(np.stack([pinv, ss]), axis=1)
        oc = np.bincount(pairs[0], minlength=len(ps))
        cv = oc.sum() / (len(ps) * len(members))
        w = len(ps) + len(members)
        terms[int(t)] = (float(w), float(cv))
    return terms


def coherence_from_terms(terms: dict[int, tuple[float, float]]) -> float:
    """Weighted sum over terms in ascending type order — the same
    accumulation order (np.unique is sorted) and arithmetic as the
    single-pass loop, so patched and from-scratch coherence agree
    bit-for-bit."""
    total_w = 0.0
    score = 0.0
    for t in sorted(terms):
        w, cv = terms[t]
        score += w * cv
        total_w += w
    return float(score / total_w) if total_w else 0.0


def coherence(graph: RDFGraph, type_pred: int | None = None) -> float:
    """Duan et al. SIGMOD'11 structuredness: coverage CV(T) = fraction of
    (instance, predicate) slots filled, weighted by (|P(T)| + |I(T)|)."""
    if type_pred is None:
        type_pred = _find_type_predicate(graph)
    if type_pred is None:
        return 0.0
    return coherence_from_terms(coherence_terms(graph, type_pred))


def _pearson_kurtosis(x: np.ndarray) -> float:
    x = np.asarray(x, dtype=np.float64)
    if len(x) < 2:
        return 1.0
    m = x.mean()
    v = ((x - m) ** 2).mean()
    if v <= 1e-12:
        return 1.0
    m4 = ((x - m) ** 4).mean()
    return float(m4 / (v * v))


def specialty_terms(graph: RDFGraph,
                    preds=None) -> dict[int, tuple[float, float]]:
    """Per-REL-predicate specialty terms {pred_id: (count, kurtosis)}.

    ``preds`` restricts computation to a subset (delta patching); non-REL
    or empty predicates contribute no term."""
    terms: dict[int, tuple[float, float]] = {}
    for p in (range(graph.num_predicates) if preds is None else preds):
        if graph.pred_kind[p] != REL:
            continue
        mask = graph.pred == p
        cnt = int(mask.sum())
        if cnt == 0:
            continue
        ks = _pearson_kurtosis(np.bincount(graph.src[mask]).astype(float)[
            np.bincount(graph.src[mask]) > 0])
        ko = _pearson_kurtosis(np.bincount(graph.dst[mask]).astype(float)[
            np.bincount(graph.dst[mask]) > 0])
        terms[int(p)] = (float(cnt), max(ks, ko))
    return terms


def specialty_from_terms(terms: dict[int, tuple[float, float]]) -> float:
    """Weighted mean over terms in ascending predicate order — same
    accumulation order and arithmetic as the single-pass loop."""
    total = 0.0
    wsum = 0.0
    for p in sorted(terms):
        cnt, kurt = terms[p]
        total += cnt * kurt
        wsum += cnt
    return float(total / wsum) if wsum else 0.0


def relationship_specialty(graph: RDFGraph) -> float:
    """Weighted Pearson-kurtosis of per-node occurrence counts of each
    relationship predicate.  Hubs can sit on either end (e.g. a prolific
    author is the *object* of many `author` edges), so we take the max of
    subject-side and object-side kurtosis per predicate."""
    return specialty_from_terms(specialty_terms(graph))


def literal_diversity(graph: RDFGraph, m_sample: int = 100_000,
                      seed: int = 0) -> int:
    """#unique whitespace words among literals of M sampled attribute edges."""
    attr_mask = graph.pred_kind[graph.pred] == ATTR
    idx = np.nonzero(attr_mask)[0]
    if len(idx) == 0:
        return 0
    rng = np.random.default_rng(seed)
    if len(idx) > m_sample:
        idx = rng.choice(idx, size=m_sample, replace=False)
    words = set()
    for lab in graph.labels[graph.dst[idx]]:
        words.update(lab.split())
    return len(words)


def compute_stats(graph: RDFGraph, m_sample: int = 100_000) -> DatasetStats:
    tp = _find_type_predicate(graph)
    src_fan, dst_fan, avg_fan = predicate_fanout(graph)
    out_deg, in_deg = node_degrees(graph)
    return DatasetStats(
        pred_selectivity=predicate_selectivity(graph),
        literal_selectivity=literal_selectivity(graph),
        coherence=coherence(graph, tp),
        specialty=relationship_specialty(graph),
        diversity=literal_diversity(graph, m_sample),
        type_pred=tp,
        src_fanout=src_fan,
        dst_fanout=dst_fan,
        avg_fanout=avg_fan,
        out_degree=out_deg,
        in_degree=in_deg,
    )
