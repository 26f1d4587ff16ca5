"""RDF graph representation in dense array form (device-native layout).

Design decision (see DESIGN.md §2): every distinct RDF label (URI or literal)
is exactly one node, and **node id == label id == lexicographic rank** of the
label.  This realizes the paper's IDMap invariant ("IDs of labels are assigned
in lexicographic order, forming an interval of consecutive integers") in its
strongest form: a prefix partial keyword resolves to a contiguous *node-id*
interval, so candidate sets, NI entries and connectivity ID-lists all live in
a single integer space.

Host-side construction uses numpy; the heavy query phases consume the arrays
directly (the engine uploads them to its device once).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

RESOURCE = 0
LITERAL = 1

REL = 0   # relationship predicate (resource -> resource)
ATTR = 1  # attribute predicate  (resource -> literal)

INVALID = np.int32(-1)


def _csr(num_nodes: int, key: np.ndarray, nbr: np.ndarray, pred: np.ndarray):
    """Build CSR adjacency sorted by (key, nbr)."""
    order = np.lexsort((nbr, key))
    key, nbr, pred = key[order], nbr[order], pred[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, key + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, nbr.astype(np.int32), pred.astype(np.int32)


def csr_patch(csr, num_nodes: int, num_preds: int,
              del_key: np.ndarray, del_nbr: np.ndarray, del_pred: np.ndarray,
              ins_key: np.ndarray, ins_nbr: np.ndarray, ins_pred: np.ndarray):
    """Patch a `_csr` result for an edge delta without re-sorting kept rows.

    Deletes remove EVERY row matching a (key, nbr, pred) triple; inserts are
    merge-placed after any equal-(key, nbr) kept rows.  The output is
    byte-identical to `_csr` over the post-delta edge arrays laid out as
    old-kept-order followed by appended inserts (lexsort is stable, so kept
    rows keep their relative order and appended inserts land after their
    equals).  Returns None when the int64 packing used for matching could
    overflow — callers then rebuild via `_csr`.
    """
    n1 = np.int64(num_nodes + 1)
    p1 = np.int64(num_preds + 1)
    if (np.log2(float(n1)) * 2 + np.log2(float(p1))) >= 62:
        return None
    indptr, nbr, pred = csr
    key = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    if len(del_key):
        pack = (key * n1 + nbr.astype(np.int64)) * p1 + pred.astype(np.int64)
        dpack = (del_key.astype(np.int64) * n1 + del_nbr.astype(np.int64)) \
            * p1 + del_pred.astype(np.int64)
        keep = ~np.isin(pack, dpack)
        key, nbr, pred = key[keep], nbr[keep], pred[keep]
    if len(ins_key):
        order = np.lexsort((ins_nbr, ins_key))   # stable, matches _csr
        ik = ins_key[order].astype(np.int64)
        inb = ins_nbr[order]
        ip = ins_pred[order]
        kept_sortkey = key * n1 + nbr.astype(np.int64)
        pos = np.searchsorted(kept_sortkey, ik * n1 + inb.astype(np.int64),
                              side="right")
        nbr = np.insert(nbr, pos, inb)
        pred = np.insert(pred, pos, ip)
        key = np.insert(key, pos, ik)
    indptr2 = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr2, key + 1, 1)
    np.cumsum(indptr2, out=indptr2)
    return indptr2, nbr.astype(np.int32), pred.astype(np.int32)


@dataclass
class RDFGraph:
    """Immutable array-form RDF graph.

    labels:     [N] unicode, lexicographically sorted; node id == index.
    node_kind:  [N] int8, RESOURCE | LITERAL.
    src/dst/pred: [E] int32 edge arrays (subject -> object).
    predicates: [P] unicode predicate names.
    pred_kind:  [P] int8, REL | ATTR (majority vote over edge targets).
    """

    labels: np.ndarray
    node_kind: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    pred: np.ndarray
    predicates: np.ndarray
    pred_kind: np.ndarray

    # ------------------------------------------------------------------ #
    @property
    def num_nodes(self) -> int:
        return int(self.labels.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_predicates(self) -> int:
        return int(self.predicates.shape[0])

    @cached_property
    def out_csr(self):
        return _csr(self.num_nodes, self.src, self.dst, self.pred)

    @cached_property
    def in_csr(self):
        return _csr(self.num_nodes, self.dst, self.src, self.pred)

    @cached_property
    def avg_degree(self) -> float:
        return self.num_edges / max(self.num_nodes, 1)

    # ------------------------------------------------------------------ #
    def out_neighbors(self, n: int):
        indptr, nbr, pred = self.out_csr
        return nbr[indptr[n]:indptr[n + 1]], pred[indptr[n]:indptr[n + 1]]

    def in_neighbors(self, n: int):
        indptr, nbr, pred = self.in_csr
        return nbr[indptr[n]:indptr[n + 1]], pred[indptr[n]:indptr[n + 1]]

    def predicate_id(self, name: str) -> int:
        hits = np.nonzero(self.predicates == name)[0]
        if len(hits) == 0:
            raise KeyError(f"unknown predicate {name!r}")
        return int(hits[0])

    # ------------------------------------------------------------------ #
    @staticmethod
    def from_triples(triples, literal_objects=None) -> "RDFGraph":
        """Build from an iterable of (subject, predicate, object) strings.

        literal_objects: optional set of object strings to force-treat as
        literals.  Otherwise an object is a literal iff it never appears as a
        subject.
        """
        triples = list(triples)
        subs = np.asarray([t[0] for t in triples])
        preds = np.asarray([t[1] for t in triples])
        objs = np.asarray([t[2] for t in triples])

        labels, inv = np.unique(np.concatenate([subs, objs]), return_inverse=True)
        src = inv[: len(triples)].astype(np.int32)
        dst = inv[len(triples):].astype(np.int32)

        predicates, pinv = np.unique(preds, return_inverse=True)
        pred = pinv.astype(np.int32)

        node_kind = np.full(len(labels), LITERAL, dtype=np.int8)
        node_kind[src] = RESOURCE  # anything that is ever a subject is a resource
        if literal_objects is not None:
            forced = np.isin(labels, np.asarray(sorted(literal_objects)))
            node_kind[forced] = LITERAL

        # predicate kind: majority of edge targets literal -> ATTR
        pred_kind = np.zeros(len(predicates), dtype=np.int8)
        lit_edge = (node_kind[dst] == LITERAL).astype(np.int64)
        tot = np.bincount(pred, minlength=len(predicates))
        lit = np.bincount(pred, weights=lit_edge, minlength=len(predicates))
        pred_kind[(lit * 2) > tot] = ATTR

        return RDFGraph(
            labels=labels,
            node_kind=node_kind,
            src=src,
            dst=dst,
            pred=pred,
            predicates=predicates,
            pred_kind=pred_kind,
        )

    # ------------------------------------------------------------------ #
    def triples(self) -> list:
        """(subject, predicate, object) string triples in edge order — the
        exact list `from_triples` would round-trip back to this graph."""
        return list(zip(self.labels[self.src], self.predicates[self.pred],
                        self.labels[self.dst]))

    # ------------------------------------------------------------------ #
    def size_bytes(self) -> int:
        """Footprint of the raw dataset (for Fig. 3-style comparisons)."""
        lab = sum(len(s) for s in self.labels)
        return int(lab + self.node_kind.nbytes + self.src.nbytes
                   + self.dst.nbytes + self.pred.nbytes)


# ---------------------------------------------------------------------- #
# IDMap: prefix partial keyword -> contiguous id interval.
# ---------------------------------------------------------------------- #
class IDMap:
    """The paper's IDMap index.

    With node id == lexicographic label rank, the map itself is the sorted
    label array; a prefix keyword resolves via two binary searches to the
    half-open interval [lo, hi) of matching ids (O(log N)).
    """

    def __init__(self, graph: RDFGraph):
        self.labels = graph.labels

    def interval(self, prefix: str) -> tuple[int, int]:
        if prefix == "":  # wildcard: matches every label
            return 0, len(self.labels)
        lo = int(np.searchsorted(self.labels, prefix, side="left"))
        # smallest string that is > every string with this prefix
        hi = int(np.searchsorted(self.labels, prefix + "￿", side="right"))
        return lo, hi

    def cardinality(self, prefix: str) -> int:
        lo, hi = self.interval(prefix)
        return hi - lo

    def size_bytes(self) -> int:
        return int(sum(len(s) for s in self.labels) + 8 * len(self.labels))
