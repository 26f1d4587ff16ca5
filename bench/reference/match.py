"""Plain template matcher: the reference that decides ``correct``.

Semantics (the paper's §1.1, subgraph isomorphism): a template is a small
directed graph whose nodes carry label prefixes ("" matches every label)
and whose edges carry a predicate name.  An answer assigns one graph node
to each template node such that every node's label starts with its
keyword, every template edge (a, b, p) is a triple (x_a, p, x_b) of the
data, and no two template nodes share a graph node.  The answer set is
the set of such assignments; a server may cut it at ``max_rows`` rows
when it says so.

NumPy only: candidate pairs per edge, then joins on the bound template
nodes with the injectivity filter after every step.  The joins run depth
first over blocks of rows, so an answer set of any size can be counted
in bounded memory, and enumerated up to a limit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .graph import Graph

BLOCK_ROWS = 1 << 16        # rows a step may make at once


class Template(NamedTuple):
    """keywords [n] label prefixes; edges ((a, b, predicate name), ...)."""
    keywords: tuple
    edges: tuple

    def renumbered(self, perm) -> "Template":
        """The same template with node q renamed perm[q]."""
        kw = [None] * len(self.keywords)
        for q, k in enumerate(self.keywords):
            kw[perm[q]] = k
        return Template(tuple(kw),
                        tuple((perm[a], perm[b], p) for a, b, p in self.edges))


class TooLarge(RuntimeError):
    """The answer set passed the reference's row limit."""


def _pairs(g: Graph, ivs, a: int, b: int, pred: str) -> np.ndarray:
    """Distinct (x_a, x_b) [m, 2] of the triples with predicate ``pred``
    whose ends lie in the intervals of a and b."""
    p = g.predicate_id(pred)
    if p < 0:
        return np.zeros((0, 2), np.int64)
    (la, ha), (lb, hb) = ivs[a], ivs[b]
    m = (g.pred == p) & (g.src >= la) & (g.src < ha) \
        & (g.dst >= lb) & (g.dst < hb)
    if a == b:
        m &= g.src == g.dst
    key = np.unique(g.src[m] * g.num_nodes + g.dst[m])
    return np.stack([key // g.num_nodes, key % g.num_nodes], axis=1)


def _injective(rows: np.ndarray, new: int) -> np.ndarray:
    """Rows whose column ``new`` differs from every other column."""
    if rows.shape[1] < 2 or not len(rows):
        return rows
    x = rows[:, new]
    ok = np.ones(len(rows), dtype=bool)
    for c in range(rows.shape[1]):
        if c != new:
            ok &= rows[:, c] != x
    return rows[ok]


def row_order(rows: np.ndarray, num_nodes: int) -> np.ndarray:
    """The permutation that sorts rows lexicographically: where every
    entry is a node id, columns packed into as few int64 keys as fit."""
    if len(rows) and (rows.min() < 0 or rows.max() >= num_nodes):
        return np.lexsort(rows.T[::-1])
    per = max(1, int(62 // max(1, int(num_nodes - 1).bit_length())))
    keys = []
    for c in range(0, rows.shape[1], per):
        k = np.zeros(len(rows), np.int64)
        for j in range(c, min(c + per, rows.shape[1])):
            k = k * num_nodes + rows[:, j]
        keys.append(k)
    return np.lexsort(keys[::-1])


def _fan_out(pairs: np.ndarray, col: int) -> float:
    """Pairs per distinct value of column ``col``."""
    return len(pairs) / max(1, len(np.unique(pairs[:, col])))


def _plan(t: Template, pairs) -> list:
    """The join steps, fixed by the template alone: ("filter", i) for an
    edge whose ends are bound, ("expand", i) for one with one end bound,
    ("start", i) for an edge whose ends are both new, ("node", q) for a
    node no edge binds.  Filters come first; then the step that makes the
    fewest rows by an estimate: a bound row's pairs on average for an
    expand, every pair for a start.  Columns come in the order the steps
    bind them."""
    steps, bound, todo, est = [], [], list(range(len(pairs))), 1.0
    while todo:
        both = [i for i in todo if {t.edges[i][0], t.edges[i][1]}
                <= set(bound)]
        if both:
            i, kind = both[0], "filter"
        else:
            grow = {}
            for i in todo:
                a, b, _ = t.edges[i]
                if (a in bound) != (b in bound):
                    grow[i] = (est * _fan_out(pairs[i], int(b in bound)),
                               0, "expand")
                elif a not in bound and b not in bound:
                    grow[i] = (est * len(pairs[i]), 1, "start")
            i = min(grow, key=lambda i: grow[i][:2])
            est, _, kind = grow[i]
            est = max(est, 1.0)
        todo.remove(i)
        steps.append((kind, i))
        a, b, _ = t.edges[i]
        bound += [q for q in dict.fromkeys((a, b)) if q not in bound]
    for q in range(len(t.keywords)):
        if q not in bound:
            steps.append(("node", q))
            bound.append(q)
    return steps, bound


def _step(g, t, ivs, pairs, step, rows, cols, keep, keyed):
    """Apply one step to ``rows`` (columns ``cols``); None where the
    result would pass BLOCK_ROWS and ``rows`` holds more than one row.
    ``keyed`` keeps each expand step's pairs sorted on its bound end."""
    kind, i = step
    if kind == "node":
        lo, hi = ivs[i]
        if len(rows) > 1 and len(rows) * (hi - lo) > BLOCK_ROWS:
            return None
        out = np.concatenate([np.repeat(rows, hi - lo, axis=0),
                              np.tile(np.arange(lo, hi), len(rows))[:, None]],
                             axis=1)
        return keep(out, out.shape[1] - 1)
    a, b, _ = t.edges[i]
    pr = pairs[i]
    if kind == "filter":
        key = rows[:, cols.index(a)] * g.num_nodes + rows[:, cols.index(b)]
        have = pr[:, 0] * g.num_nodes + pr[:, 1]
        return rows[np.isin(key, have)]
    if kind == "start":
        fresh = pr[:, :1] if a == b else pr
        if len(rows) > 1 and len(rows) * len(fresh) > BLOCK_ROWS:
            return None
        out = np.concatenate([np.repeat(rows, len(fresh), axis=0),
                              np.tile(fresh, (len(rows), 1))], axis=1)
        for k in range(fresh.shape[1]):
            out = keep(out, rows.shape[1] + k)
        return out
    # expand the unbound end from the pairs keyed on the bound one
    known = a if a in cols else b
    if i not in keyed:
        kcol = 0 if known == a else 1
        order = np.argsort(pr[:, kcol], kind="stable")
        keyed[i] = pr[order, kcol], pr[order, 1 - kcol]
    keys, vals = keyed[i]
    x = rows[:, cols.index(known)]
    lo = np.searchsorted(keys, x, side="left")
    cnt = np.searchsorted(keys, x, side="right") - lo
    total = int(cnt.sum())
    if len(rows) > 1 and total > BLOCK_ROWS:
        return None
    rep = np.repeat(np.arange(len(rows)), cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    out = np.concatenate([rows[rep], vals[np.repeat(lo, cnt) + offs][:, None]],
                         axis=1)
    return keep(out, out.shape[1] - 1)


def answer_blocks(g: Graph, t: Template, injective: bool = True):
    """Every answer of ``t`` on ``g``, as blocks of rows [R, n] in template
    node order.  No answer comes twice, within a block or across blocks:
    each descends from one row of each step.  ``injective=False`` drops
    the distinctness of the assigned nodes (homomorphisms): the control,
    never the reference."""
    keep = _injective if injective else (lambda rows, new: rows)
    ivs = [g.interval(k) for k in t.keywords]
    pairs = [_pairs(g, ivs, a, b, p) for a, b, p in t.edges]
    steps, cols = _plan(t, pairs)
    back = np.argsort(cols)
    keyed: dict = {}
    stack = [(0, np.zeros((1, 0), np.int64))]
    while stack:
        k, rows = stack.pop()
        if not len(rows):
            continue
        if k == len(steps):
            yield rows[:, back]
            continue
        out = _step(g, t, ivs, pairs, steps[k], rows, cols[:rows.shape[1]],
                    keep, keyed)
        if out is None:                 # halve the block, first half first
            h = len(rows) // 2
            stack += [(k, rows[h:]), (k, rows[:h])]
        else:
            stack.append((k + 1, out))


def match(g: Graph, t: Template, limit: int = 1 << 25,
          injective: bool = True) -> np.ndarray:
    """Every answer of ``t`` on ``g``: int64 [R, n] in lexicographic
    order, columns in template node order.  Raises TooLarge when there are
    more than ``limit``."""
    out, total = [], 0
    for rows in answer_blocks(g, t, injective):
        total += len(rows)
        if total > limit:
            raise TooLarge(f"more than {limit} answers")
        out.append(rows)
    if not out:
        return np.zeros((0, len(t.keywords)), np.int64)
    out = np.concatenate(out)
    return out[row_order(out, g.num_nodes)] if out.shape[1] else out[:1]


def more_than(g: Graph, t: Template, k: int, injective: bool = True) -> bool:
    """Whether ``t`` has more than ``k`` answers on ``g``, counted block
    by block until the count passes ``k``."""
    total = 0
    for rows in answer_blocks(g, t, injective):
        total += len(rows)
        if total > k:
            return True
    return False


def sub_templates(t: Template):
    """Every connected set of ``t``'s edges as a template of its own (the
    nodes it touches, with their keywords), fewest edges first."""
    m = len(t.edges)
    for size in range(1, m + 1):
        for mask in range(1, 1 << m):
            if bin(mask).count("1") != size:
                continue
            edges = [t.edges[i] for i in range(m) if mask >> i & 1]
            nodes = sorted({q for a, b, _ in edges for q in (a, b)})
            reach, todo = {nodes[0]}, [nodes[0]]
            while todo:
                x = todo.pop()
                for a, b, _ in edges:
                    for u, v in ((a, b), (b, a)):
                        if u == x and v not in reach:
                            reach.add(v)
                            todo.append(v)
            if len(reach) < len(nodes):
                continue
            at = {q: i for i, q in enumerate(nodes)}
            yield Template(tuple(t.keywords[q] for q in nodes),
                           tuple((at[a], at[b], p) for a, b, p in edges))


def valid_rows(g: Graph, t: Template, rows: np.ndarray) -> np.ndarray:
    """[R] bool: which rows are answers of ``t`` (keywords, edges,
    injectivity), judged row by row without enumerating the answer set."""
    rows = np.asarray(rows, np.int64)
    ok = np.ones(len(rows), dtype=bool)
    if not len(rows):
        return ok
    ok &= (rows >= 0).all(axis=1) & (rows < g.num_nodes).all(axis=1)
    r = np.where(ok[:, None], rows, 0)
    for q, k in enumerate(t.keywords):
        lo, hi = g.interval(k)
        ok &= (r[:, q] >= lo) & (r[:, q] < hi)
    keys = g.edge_keys()
    for a, b, p in t.edges:
        pid = g.predicate_id(p)
        if pid < 0:
            ok[:] = False
            continue
        x = g.pack(r[:, a], r[:, b], pid)
        at = np.minimum(np.searchsorted(keys, x), len(keys) - 1)
        ok &= keys[at] == x
    srt = np.sort(r, axis=1)
    ok &= (np.diff(srt, axis=1) != 0).all(axis=1)
    return ok
