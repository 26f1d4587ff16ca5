"""Query templates (paper §1.1).

A template is a small directed graph whose nodes carry *partial keywords*
(prefixes of RDF labels; '' = wildcard) and whose edges are either predicate
edges (pred id, or None for wildcard predicate) or *connection edges* with a
distance constraint.

Matching semantics: **subgraph isomorphism** (injective node mapping), per
the paper's §1 ("graph template matching (based on subgraph isomorphism)").
Injectivity is what makes the count-based neighborhood check (Algorithm 1's
{Distance, Count} pairs) a sound pruning rule: c distinct query nodes with
keyword p within d hops force >= c distinct matching neighbors.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import RDFGraph, IDMap


@dataclass(frozen=True)
class QueryEdge:
    src: int
    dst: int
    pred: int | None = None      # None = wildcard predicate


@dataclass(frozen=True)
class ConnectionEdge:
    src: int
    dst: int
    max_dist: int                # E: distance (shortest path) <= max_dist
    bidirectional: bool = False  # if True, also accept dst ->* src


@dataclass
class QueryTemplate:
    keywords: list[str]                       # per query node
    edges: list[QueryEdge] = field(default_factory=list)
    connections: list[ConnectionEdge] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.keywords)

    @property
    def size(self) -> int:
        """Paper's "query size" = number of template nodes."""
        return self.num_nodes

    # -------------------------------------------------------------- #
    def components(self) -> list[list[int]]:
        """Connected components after removing connection edges."""
        parent = list(range(self.num_nodes))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for e in self.edges:
            a, b = find(e.src), find(e.dst)
            if a != b:
                parent[a] = b
        comps: dict[int, list[int]] = {}
        for v in range(self.num_nodes):
            comps.setdefault(find(v), []).append(v)
        return list(comps.values())

    def component_edges(self, comp: list[int]) -> list[QueryEdge]:
        s = set(comp)
        return [e for e in self.edges if e.src in s and e.dst in s]

    def intervals(self, idmap: IDMap) -> np.ndarray:
        """[Q, 2] keyword id-intervals (lo inclusive, hi exclusive)."""
        return np.asarray([idmap.interval(k) for k in self.keywords],
                          dtype=np.int64)


# ---------------------------------------------------------------------- #
# Brute-force oracle (host, exponential) — ground truth for tests.
# ---------------------------------------------------------------------- #
def brute_force_match(graph: RDFGraph, query: QueryTemplate,
                      limit: int = 1_000_000) -> set[tuple[int, ...]]:
    """All homomorphisms query -> graph satisfying keyword, predicate-edge
    and connection-edge constraints.  Exponential; small inputs only."""
    idmap = IDMap(graph)
    iv = query.intervals(idmap)
    n_q = query.num_nodes

    # adjacency dicts for the small-graph oracle
    out_adj: dict[int, list[tuple[int, int]]] = {}
    for s, d, p in zip(graph.src, graph.dst, graph.pred):
        out_adj.setdefault(int(s), []).append((int(d), int(p)))

    def bfs_within(a: int, h: int) -> set[int]:
        seen = {a}
        frontier = {a}
        for _ in range(h):
            nxt = set()
            for u in frontier:
                for v, _ in out_adj.get(u, ()):
                    if v not in seen:
                        seen.add(v)
                        nxt.add(v)
            frontier = nxt
        return seen

    def conn_ok(a: int, b: int, c: ConnectionEdge) -> bool:
        if b in bfs_within(a, c.max_dist):
            return True
        if c.bidirectional and a in bfs_within(b, c.max_dist):
            return True
        return False

    # order query nodes: connected-first greedy for pruning
    order = list(range(n_q))
    results: set[tuple[int, ...]] = set()
    assign: list[int | None] = [None] * n_q

    edges_by_node: dict[int, list[QueryEdge]] = {}
    for e in query.edges:
        edges_by_node.setdefault(e.src, []).append(e)
        edges_by_node.setdefault(e.dst, []).append(e)

    def edge_ok(e: QueryEdge) -> bool:
        s, d = assign[e.src], assign[e.dst]
        if s is None or d is None:
            return True
        for v, p in out_adj.get(s, ()):
            if v == d and (e.pred is None or p == e.pred):
                return True
        return False

    def rec(i: int):
        if len(results) >= limit:
            return
        if i == n_q:
            for c in query.connections:
                if not conn_ok(assign[c.src], assign[c.dst], c):
                    return
            results.add(tuple(assign))  # type: ignore[arg-type]
            return
        q = order[i]
        lo, hi = iv[q]
        taken = {assign[order[k]] for k in range(i)}
        for cand in range(int(lo), int(hi)):
            if cand in taken:     # injectivity (subgraph isomorphism)
                continue
            assign[q] = cand
            if all(edge_ok(e) for e in edges_by_node.get(q, ())):
                rec(i + 1)
            assign[q] = None

    rec(0)
    return results
