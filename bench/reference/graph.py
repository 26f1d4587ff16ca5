"""The benchmark's own index of a triple set: numbering, labels, edges.

Every distinct subject or object string is one node, numbered by its rank
among the sorted labels, so a label prefix selects one contiguous range of
node ids.  Predicates are numbered by their sorted rank.  Built from the
benchmark's triples alone; nothing here comes from the program.
"""
from __future__ import annotations

import numpy as np

# the largest code point: prefix + TOP sorts after every label with the prefix
TOP = chr(0x10FFFF)


class Graph:
    """labels [N] sorted; src, dst, pred [E] int64 in triple order;
    literal [N] bool (never a subject, or forced); out/in CSR sorted by
    (node, neighbour), as ``(indptr, nbr, pred)``."""

    def __init__(self, subs, preds, objs, literals=()):
        subs, preds, objs = (np.asarray(a) for a in (subs, preds, objs))
        self.labels, inv = np.unique(np.concatenate([subs, objs]),
                                     return_inverse=True)
        e = len(subs)
        self.src = inv[:e].astype(np.int64)
        self.dst = inv[e:].astype(np.int64)
        self.predicates, pinv = np.unique(preds, return_inverse=True)
        self.pred = pinv.astype(np.int64)
        n = len(self.labels)
        self.literal = np.ones(n, dtype=bool)
        self.literal[self.src] = False
        if literals:
            self.literal[np.isin(self.labels,
                                 np.asarray(sorted(literals)))] = True
        self.out_csr = self._csr(self.src, self.dst)
        self.in_csr = self._csr(self.dst, self.src)
        self._edge_keys = None

    @property
    def num_nodes(self) -> int:
        return len(self.labels)

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def _csr(self, key, nbr):
        order = np.lexsort((nbr, key))
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, key + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, nbr[order], self.pred[order]

    def interval(self, prefix: str) -> tuple[int, int]:
        """[lo, hi): the node ids whose label starts with ``prefix``."""
        if prefix == "":
            return 0, self.num_nodes
        lo = int(np.searchsorted(self.labels, prefix, side="left"))
        hi = int(np.searchsorted(self.labels, prefix + TOP, side="right"))
        return lo, hi

    def predicate_id(self, name: str) -> int:
        """Rank of predicate ``name``, or -1 when no triple has it."""
        i = int(np.searchsorted(self.predicates, name))
        return i if i < len(self.predicates) and \
            self.predicates[i] == name else -1

    def edge_keys(self) -> np.ndarray:
        """Sorted distinct (src, dst, pred) packed into int64."""
        if self._edge_keys is None:
            self._edge_keys = np.unique(self.pack(self.src, self.dst,
                                                  self.pred))
        return self._edge_keys

    def pack(self, s, d, p):
        n, np_ = self.num_nodes, max(len(self.predicates), 1)
        return (np.asarray(s, np.int64) * n + d) * np_ + p
