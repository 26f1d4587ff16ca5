"""Random query templates (the paper's §6), drawn on the benchmark's own
index of the triples.

A copy of ``repro_torch.data.queries.random_query`` with one change: the random incident edge of the node a template
grows from is drawn by its index among the node's out-edges then in-edges,
instead of listing them all.  The draw is the same call with the same
bound on the same CSR order, so one seed gives the template the port's
function gives, at O(1) a step where the port's costs the node's degree
(thousands of edges at SP2Bench's hubs).
"""
from __future__ import annotations

import weakref
from collections import Counter
from itertools import permutations, product

import numpy as np

from ..reference.graph import Graph
from ..reference.match import Template

_OPTIONS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def generalize_literal(g: Graph, label: str, rng,
                       lo_matches: int = 1, hi_matches: int = 200) -> str:
    """Strip last chars until the prefix matches [lo, hi] labels; the
    prefixes that do are worked out once a label and graph."""
    cache = _OPTIONS.setdefault(g, {})
    options = cache.get(label)
    if options is None:
        options = []
        for cut in range(len(label), 0, -1):
            p = label[:cut]
            lo, hi = g.interval(p)
            c = hi - lo
            if lo_matches <= c <= hi_matches:
                options.append(p)
            if c > hi_matches:
                break
        cache[label] = options
    if not options:
        return label
    return options[rng.integers(0, len(options))]


def keyword_for_node(g: Graph, node: int, rng) -> str:
    label = str(g.labels[node])
    if g.literal[node]:
        return generalize_literal(g, label, rng)
    if "/" in label:                       # URI: strip the long id
        return label.split("/")[0] + "/"
    return generalize_literal(g, label, rng)


def random_template(g: Graph, size: int = 6, seed: int = 0) -> Template:
    """Sample a connected subgraph with ``size`` nodes; generalize labels.
    Templates with three or more copies of one keyword are resampled."""
    rng = np.random.default_rng(seed)
    out_indptr, out_nbr, out_pred = g.out_csr
    in_indptr, in_nbr, in_pred = g.in_csr
    for _attempt in range(64):
        e0 = int(rng.integers(0, g.num_edges))
        nodes = [int(g.src[e0]), int(g.dst[e0])]
        edges = [(int(g.src[e0]), int(g.dst[e0]), int(g.pred[e0]))]
        stall = 0
        while len(nodes) < size and stall < 200:
            v = nodes[rng.integers(0, len(nodes))]
            n_out = int(out_indptr[v + 1] - out_indptr[v])
            n_all = n_out + int(in_indptr[v + 1] - in_indptr[v])
            if not n_all:
                stall += 1
                continue
            k = int(rng.integers(0, n_all))
            if k < n_out:
                i = out_indptr[v] + k
                key = (v, int(out_nbr[i]), int(out_pred[i]))
            else:
                i = in_indptr[v] + k - n_out
                key = (int(in_nbr[i]), v, int(in_pred[i]))
            if key in edges:
                stall += 1
                continue
            edges.append(key)
            for x in key[:2]:
                if x not in nodes:
                    nodes.append(x)
            stall = 0
        if len(nodes) < min(size, 3):
            continue
        keywords = []
        for x in nodes:
            rng.random()        # the port's draw for exact labels (off)
            keywords.append(keyword_for_node(g, x, rng))
        if max(Counter(keywords).values()) <= 2:
            break
    idx = {x: i for i, x in enumerate(nodes)}
    qedges = [(idx[s], idx[d], str(g.predicates[p])) for s, d, p in edges]
    rng.shuffle(qedges)                 # the port shuffles its edge list
    return Template(tuple(keywords), tuple(qedges))


def canonical(t: Template) -> tuple:
    """A key equal for two templates iff they are equal as labelled
    graphs up to renaming their nodes: the smallest encoding over the
    orders that sort nodes by (keyword, out- and in-predicates)."""
    n = len(t.keywords)
    color = [(t.keywords[q],
              tuple(sorted(p for a, _, p in t.edges if a == q)),
              tuple(sorted(p for _, b, p in t.edges if b == q)))
             for q in range(n)]
    groups: dict = {}
    for q in range(n):
        groups.setdefault(color[q], []).append(q)
    cells = [groups[c] for c in sorted(groups)]
    best = None
    for choice in product(*(permutations(c) for c in cells)):
        order = [q for cell in choice for q in cell]
        pos = {q: i for i, q in enumerate(order)}
        enc = (tuple(t.keywords[q] for q in order),
               tuple(sorted((pos[a], pos[b], p) for a, b, p in t.edges)))
        if best is None or enc < best:
            best = enc
    return best
