"""D-tree decomposition of a query component (paper Algorithm 2, step 1).

A D-tree is a height-1 directed tree: a root query node plus the query
edges incident to it that are still uncovered.  The decomposition is the
CLRS 2-approximation vertex cover driven by the selectivity function
S(q) = deg(q) / |C_q| — prefer high degree (covers more edges) and small
candidate sets (fewer D-tree candidates).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .query import QueryTemplate, QueryEdge


@dataclass
class DTree:
    root: int
    # edges incident to root: (pred, child, outgoing?) — outgoing means
    # root -> child in the template.
    edges: list[tuple[int | None, int, bool]] = field(default_factory=list)

    @property
    def nodes(self) -> list[int]:
        return [self.root] + [c for _, c, _ in self.edges]


def decompose(query: QueryTemplate, comp: list[int],
              cand_sizes: dict[int, int]) -> list[DTree]:
    """Decompose one component into D-trees covering all its edges."""
    remaining = list(query.component_edges(comp))
    if not remaining:
        return [DTree(root=comp[0])] if len(comp) == 1 else \
               [DTree(root=v) for v in comp]

    def degree(v: int) -> int:
        return sum(1 for e in remaining if v in (e.src, e.dst))

    def S(v: int) -> float:
        return degree(v) / max(cand_sizes.get(v, 1), 1)

    trees: list[DTree] = []
    while remaining:
        # pick edge maximizing S(src) + S(dst)
        best = max(remaining, key=lambda e: S(e.src) + S(e.dst))
        for root in (best.src, best.dst):
            mine = [e for e in remaining if root in (e.src, e.dst)]
            if not mine:
                continue
            t = DTree(root=root)
            for e in mine:
                if e.src == root:
                    t.edges.append((e.pred, e.dst, True))
                else:
                    t.edges.append((e.pred, e.src, False))
            trees.append(t)
            remaining = [e for e in remaining if e not in mine]
    return trees


def join_order(trees: list[DTree], cand_counts: list[int]) -> list[int]:
    """Paper's join order: start from the smallest candidate set, repeatedly
    add the smallest-candidate tree that shares a query node with the
    already-joined set (fall back to global smallest if disconnected).

    This is the seed heuristic, kept as the `plan_mode="greedy"` baseline
    and as the comparison order the cost-based planner
    (`planner.plan_table_joins`) evaluates under its own cost model; the
    engine executes the planner's order by default."""
    n = len(trees)
    order = []
    used = [False] * n
    joined_nodes: set[int] = set()
    for _ in range(n):
        best, best_connected = None, False
        for i in range(n):
            if used[i]:
                continue
            connected = bool(joined_nodes.intersection(trees[i].nodes))
            key = (connected, -cand_counts[i])
            if best is None or key > ((best_connected, -cand_counts[best])):
                best, best_connected = i, connected
        order.append(best)
        used[best] = True
        joined_nodes.update(trees[best].nodes)
    return order
