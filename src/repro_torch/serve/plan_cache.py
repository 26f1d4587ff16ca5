"""Template plan cache: canonical fingerprints + LRU over PreparedQuery.

A serving workload repeats templates — often renumbered by the client
(node 0 of one request is node 3 of the next).  The cache therefore keys
on a *canonical* form of the template: nodes are relabeled by an
individualization-refinement canonical ordering (1-WL color refinement
over keywords / incident predicate edges / connection constraints, with
exhaustive branching on tied color cells — templates have <= ~10 nodes,
so the worst case is tiny).  Two isomorphic templates map to the same
fingerprint and share one `PreparedQuery`; results are mapped back to the
caller's node numbering through the canonicalization permutation.

`PreparedQuery` itself lives in `repro_torch.core.engine` (it is the engine's
prepare/execute state machine) and is re-exported here as its public
serving-layer home.
"""
from __future__ import annotations

from collections import OrderedDict

from ..core.engine import Engine, MatchResult, PreparedQuery  # noqa: F401
from ..core.query import QueryTemplate, QueryEdge, ConnectionEdge


# ---------------------------------------------------------------------- #
# Canonical form.
# ---------------------------------------------------------------------- #
def _initial_colors(query: QueryTemplate) -> list:
    """Per-node invariant: keyword plus incident-edge/connection shape."""
    n = query.num_nodes
    sigs = []
    for q in range(n):
        out_e = tuple(sorted(-1 if e.pred is None else e.pred
                             for e in query.edges if e.src == q))
        in_e = tuple(sorted(-1 if e.pred is None else e.pred
                            for e in query.edges if e.dst == q))
        # a bidirectional connection is symmetric (a->b or b->a both
        # satisfy it), so its endpoints play one undistinguished role
        conn = tuple(sorted(("u" if c.bidirectional
                             else ("s" if c.src == q else "d"),
                             c.max_dist, bool(c.bidirectional))
                            for c in query.connections
                            if q in (c.src, c.dst)))
        sigs.append((query.keywords[q], out_e, in_e, conn))
    return sigs


def _compress(sigs: list) -> list[int]:
    """Map arbitrary hashable signatures to dense ints by sorted order
    (stable across processes — no hash() involved)."""
    ranks = {s: i for i, s in enumerate(sorted(set(sigs)))}
    return [ranks[s] for s in sigs]


def _refine(query: QueryTemplate, colors: list[int]) -> list[int]:
    """1-WL refinement until the color partition is stable."""
    n = query.num_nodes
    while True:
        sigs = []
        for q in range(n):
            nb = []
            for e in query.edges:
                p = -1 if e.pred is None else e.pred
                if e.src == q:
                    nb.append(("e>", p, colors[e.dst]))
                if e.dst == q:
                    nb.append(("e<", p, colors[e.src]))
            for c in query.connections:
                if c.src == q:
                    role = "c=" if c.bidirectional else "c>"
                    nb.append((role, c.max_dist, bool(c.bidirectional),
                               colors[c.dst]))
                if c.dst == q:
                    role = "c=" if c.bidirectional else "c<"
                    nb.append((role, c.max_dist, bool(c.bidirectional),
                               colors[c.src]))
            sigs.append((colors[q], tuple(sorted(nb))))
        new = _compress(sigs)
        if new == colors:
            return colors
        colors = new


def _encode(query: QueryTemplate, order: list[int]):
    """Canonical encoding of `query` relabeled so order[i] becomes node i.
    `order` lists original node ids in canonical sequence."""
    pos = {orig: i for i, orig in enumerate(order)}
    kws = tuple(query.keywords[orig] for orig in order)
    edges = tuple(sorted((pos[e.src], pos[e.dst],
                          -1 if e.pred is None else e.pred)
                         for e in query.edges))
    # bidirectional connections are symmetric: canonical endpoint order
    conns = tuple(sorted(
        ((min(pos[c.src], pos[c.dst]), max(pos[c.src], pos[c.dst]),
          c.max_dist, True) if c.bidirectional
         else (pos[c.src], pos[c.dst], c.max_dist, False))
        for c in query.connections))
    return (kws, edges, conns)


# Individualization branch budget: exhaustive branching is factorial on
# fully symmetric templates (n identical unconnected nodes => n!
# encodings), and canonicalization runs on every submission.  Realistic
# templates discriminate almost immediately; past this many branch
# expansions the search degrades to greedy first-member
# individualization — still deterministic for a GIVEN numbering (same
# query object always maps to the same fingerprint, so repeats still
# hit), merely no longer guaranteed to unify every exotic renumbering of
# a highly symmetric template (those become separate cache entries,
# never wrong results).
_CANON_BUDGET = 64


def _canonical_order(query: QueryTemplate, colors: list[int],
                     budget: list[int] | None = None) -> list[int]:
    """Individualization-refinement canonical node order: refine, then
    branch on every member of the first tied color cell and keep the
    lexicographically smallest encoding.  Exact — isomorphic templates
    produce identical encodings regardless of input numbering — while
    the branch budget lasts (see _CANON_BUDGET)."""
    if budget is None:
        budget = [_CANON_BUDGET]
    colors = _refine(query, colors)
    n = query.num_nodes
    cells: dict[int, list[int]] = {}
    for q, c in enumerate(colors):
        cells.setdefault(c, []).append(q)
    tied = [m for _, m in sorted(cells.items()) if len(m) > 1]
    if not tied:
        return sorted(range(n), key=lambda q: colors[q])
    members = tied[0] if budget[0] > 0 else tied[0][:1]
    budget[0] -= len(members)
    best = None
    for v in members:
        # individualize v: a fresh color below its cell, preserving the
        # relative order of all other colors
        ind = [2 * c + (0 if q == v else 1) for q, c in enumerate(colors)]
        order = _canonical_order(query, _compress(ind), budget)
        enc = _encode(query, order)
        if best is None or enc < best[0]:
            best = (enc, order)
    return best[1]


def canonicalize(query: QueryTemplate
                 ) -> tuple[QueryTemplate, list[int], str]:
    """(canonical query, order, fingerprint).

    `order[i]` is the original node id that became canonical node i; the
    fingerprint is a stable string of the canonical encoding (keywords,
    predicate edges, connection edges)."""
    order = _canonical_order(query, _compress(_initial_colors(query)))
    kws, edges, conns = _encode(query, order)
    canon = QueryTemplate(
        keywords=list(kws),
        edges=[QueryEdge(s, d, None if p < 0 else p) for s, d, p in edges],
        connections=[ConnectionEdge(s, d, md, bd)
                     for s, d, md, bd in conns])
    return canon, order, repr((kws, edges, conns))


def template_fingerprint(query: QueryTemplate) -> str:
    """Canonical template fingerprint: equal for isomorphic templates."""
    return canonicalize(query)[2]


def dataset_key(dataset) -> str:
    """Cache key component identifying one loaded dataset by CONTENT.

    Keying on id(graph) would be a wrong-results trap for caches that
    outlive a graph (CPython recycles ids, and a recycled id plus equal
    node/edge counts would replay another graph's cached masks and join
    sizes).  The digest covers the FULL edge arrays — a sampled digest
    would re-open the same trap for graphs differing only outside the
    sample — at ~tens of ms per GB of edges, paid once per server.
    Equal datasets sharing cache entries is a bonus.

    A `repro_torch.core.Dataset` additionally carries a delta version, so its
    key is the versioned ``digest:vN`` form (`Dataset.cache_key`): two
    states of one mutable dataset never share cache entries.  A bare
    graph keys to the plain content digest."""
    from ..core.dataset import Dataset, content_digest
    if isinstance(dataset, Dataset):
        return dataset.cache_key
    return content_digest(dataset)


# ---------------------------------------------------------------------- #
# LRU plan cache.
# ---------------------------------------------------------------------- #
class PlanCache:
    """LRU cache of PreparedQuery keyed by (dataset id, fingerprint).

    Entries carry the calibration `version` they were prepared under: the
    τ thresholds feed the §4.3 check decision baked into the plan, so a
    stale entry must not be served as-is.  But discarding it would throw
    away the learned execution state (masks, join orders, exact join
    sizes) every time the Calibrator nudges a threshold — so
    `prepare_cached` instead *revalidates* stale entries through
    `Engine.revalidate`, which re-runs only the cheap §4.3 decision and
    keeps everything learned whenever the decision is unchanged."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = int(max_entries)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.revalidations = 0          # stale entries re-decided
        self.invalidations = 0          # ... whose decision flipped
        self.drops = 0                  # chronic-degradation re-plans

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, dataset_id: str, fingerprint: str) -> PreparedQuery | None:
        key = (dataset_id, fingerprint)
        pq = self._entries.get(key)
        if pq is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return pq

    def peek(self, dataset_id: str,
             fingerprint: str) -> PreparedQuery | None:
        """`get` without side effects: no LRU touch, no hit/miss count.
        Observability reads (EXPLAIN, the slow-query log) use this so
        inspecting a plan never perturbs cache telemetry or eviction
        order."""
        return self._entries.get((dataset_id, fingerprint))

    def put(self, dataset_id: str, fingerprint: str,
            pq: PreparedQuery) -> None:
        key = (dataset_id, fingerprint)
        self._entries[key] = pq
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1

    def drop(self, dataset_id: str, fingerprint: str) -> bool:
        """Remove one entry (chronic-degradation re-planning: the next
        request on this fingerprint prepares fresh).  Returns whether an
        entry was present."""
        if self._entries.pop((dataset_id, fingerprint), None) is None:
            return False
        self.drops += 1
        return True

    def entries(self):
        """((dataset_id, fingerprint), PreparedQuery) pairs in LRU order
        (least recent first) — snapshot serialization preserves it."""
        return list(self._entries.items())

    def migrate(self, old_id: str, new_id: str,
                revalidate=None) -> tuple[int, int]:
        """Dataset-delta migration: move every entry keyed under `old_id`
        to `new_id`, preserving their relative LRU order.  `revalidate`
        (if given) is called with each PreparedQuery before the move and
        may return False to drop the entry instead (counted in `drops`).
        Returns (moved, dropped)."""
        moved = dropped = 0
        for (dsid, fp), pq in list(self._entries.items()):
            if dsid != old_id:
                continue
            del self._entries[(dsid, fp)]
            if revalidate is not None and revalidate(pq) is False:
                self.drops += 1
                dropped += 1
                continue
            self._entries[(new_id, fp)] = pq
            moved += 1
        return moved, dropped

    def snapshot(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
            "revalidations": self.revalidations,
            "invalidations": self.invalidations,
            "drops": self.drops,
        }


def prepare_cached(engine: Engine, query: QueryTemplate, cache: PlanCache,
                   dataset_id: str, version: int = 0
                   ) -> tuple[PreparedQuery, list[int], bool]:
    """Canonicalize `query`, look its plan up in `cache` (preparing and
    inserting on miss, revalidating on a calibration-version mismatch).
    Returns (prepared canonical query, order, hit) where `order[i]` is
    the caller's node id of canonical node i — `remap_result` uses it to
    translate executed results back."""
    canon, order, fingerprint = canonicalize(query)
    pq = cache.get(dataset_id, fingerprint)
    hit = pq is not None
    if pq is None:
        pq = engine.prepare(canon, fingerprint=fingerprint, version=version)
        cache.put(dataset_id, fingerprint, pq)
    elif pq.version != version:
        cache.revalidations += 1
        if not engine.revalidate(pq, version):
            cache.invalidations += 1
    return pq, order, hit


def remap_result(result: MatchResult, order: list[int]) -> MatchResult:
    """Translate a canonical-template MatchResult back to the caller's
    node numbering (rows are shared, only the column labels change)."""
    cols = tuple(order[c] for c in result.cols)
    return MatchResult(cols=cols, rows=result.rows, stats=result.stats)
