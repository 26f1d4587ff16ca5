"""Random query template generation (paper §6).

Queries are sampled subgraphs of the data graph (guaranteeing >=1 match),
then labels are *generalized* into partial keywords:
  - resource URIs: drop the long id, keep the "Type/" prefix;
  - literals: strip trailing characters until the prefix matches 1..200
    labels in the graph (random choice among valid cut points).
Optionally, template edges are rewritten into connection edges with a
distance constraint, or an extra connection edge is added between two
random template nodes.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import RDFGraph, IDMap, LITERAL
from ..core.query import QueryTemplate, QueryEdge, ConnectionEdge


def generalize_literal(idmap: IDMap, label: str, rng,
                       lo_matches: int = 1, hi_matches: int = 200) -> str:
    """Strip last chars until the prefix matches [lo, hi] labels."""
    options = []
    for cut in range(len(label), 0, -1):
        p = label[:cut]
        c = idmap.cardinality(p)
        if lo_matches <= c <= hi_matches:
            options.append(p)
        if c > hi_matches:
            break
    if not options:
        return label
    return options[rng.integers(0, len(options))]


def keyword_for_node(graph: RDFGraph, idmap: IDMap, node: int, rng) -> str:
    label = str(graph.labels[node])
    if graph.node_kind[node] == LITERAL:
        return generalize_literal(idmap, label, rng)
    if "/" in label:                       # URI: strip the long id
        return label.split("/")[0] + "/"
    return generalize_literal(idmap, label, rng)


def random_query(graph: RDFGraph, size: int = 6, seed: int = 0,
                 n_connection: int = 0, d_c: int = 4,
                 exact_nodes: float = 0.0) -> QueryTemplate:
    """Sample a connected subgraph with `size` nodes; generalize labels.

    n_connection template edges are converted to connection edges (their
    endpoints stay in the template).  exact_nodes: probability a node keeps
    its full label (exact match) instead of a generalized keyword.
    """
    rng = np.random.default_rng(seed)
    idmap = IDMap(graph)
    out_indptr, out_nbr, out_pred = graph.out_csr
    in_indptr, in_nbr, in_pred = graph.in_csr

    # --- grow a random connected subgraph -----------------------------
    # templates whose keyword multiset has >= 3 copies of one keyword are
    # rejected (symmetric candidate explosion: k interchangeable query
    # nodes multiply the result set by ~|C|^k) and resampled.
    for _attempt in range(64):
        e0 = int(rng.integers(0, graph.num_edges))
        nodes = [int(graph.src[e0]), int(graph.dst[e0])]
        edges = [(int(graph.src[e0]), int(graph.dst[e0]), int(graph.pred[e0]))]
        seen_edges = {e0}
        stall = 0
        while len(nodes) < size and stall < 200:
            v = nodes[rng.integers(0, len(nodes))]
            # random incident edge (either direction)
            cands = []
            s, e = out_indptr[v], out_indptr[v + 1]
            cands += [(v, int(out_nbr[i]), int(out_pred[i]))
                      for i in range(s, e)]
            s, e = in_indptr[v], in_indptr[v + 1]
            cands += [(int(in_nbr[i]), v, int(in_pred[i]))
                      for i in range(s, e)]
            if not cands:
                stall += 1
                continue
            s2, d2, p2 = cands[rng.integers(0, len(cands))]
            key = (s2, d2, p2)
            if key in [(a, b, p) for a, b, p in edges]:
                stall += 1
                continue
            edges.append(key)
            for x in (s2, d2):
                if x not in nodes:
                    nodes.append(x)
            stall = 0
        if len(nodes) < min(size, 3):
            continue
        keywords = []
        for g in nodes:
            if rng.random() < exact_nodes:
                keywords.append(str(graph.labels[g]))
            else:
                keywords.append(keyword_for_node(graph, idmap, g, rng))
        from collections import Counter
        if max(Counter(keywords).values()) <= 2:
            break
    node_idx = {g: i for i, g in enumerate(nodes)}

    qedges = [QueryEdge(node_idx[s], node_idx[d], p) for s, d, p in edges]
    conns: list[ConnectionEdge] = []

    # --- convert some edges to connection edges ------------------------
    rng.shuffle(qedges)
    for _ in range(min(n_connection, max(len(qedges) - 1, 0))):
        e = qedges.pop()
        conns.append(ConnectionEdge(e.src, e.dst, d_c))
    return QueryTemplate(keywords=keywords, edges=qedges, connections=conns)
