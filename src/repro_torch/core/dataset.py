"""Versioned ``Dataset`` facade: construction + incremental delta ingest.

Everything the engine consults — edge arrays/CSR, IDMap intervals, the NI
index, and ``DatasetStats`` — is derived from one frozen ``RDFGraph``.  The
``Dataset`` owns all of it under a single identity: a content ``digest``
(sha1 over the edge arrays) plus a monotone ``version`` counter, which the
serving tier uses to scope its caches (PlanCache / ReachCache / ResultCache).

``apply_delta(inserts, deletes)`` returns a NEW ``Dataset`` (never mutates —
the old one keeps answering queries with pre-delta results, i.e. snapshot
isolation) and maintains the derived structures *incrementally*:

  * edge arrays:   old-kept-order + inserts appended — exactly the order
                   ``RDFGraph.from_triples`` would produce on the post-delta
                   triple list, so digests, CSR bytes and sampled stats all
                   match a full rebuild bit-for-bit;
  * CSR:           ``csr_patch`` splices deleted rows out / inserted rows in
                   without re-sorting untouched rows;
  * NI index:      only nodes within ``d_max - 1`` reverse hops of a changed
                   edge endpoint (in the old OR new graph) get their k-hop
                   rows recomputed; untouched ``NIEntry`` tensors are shared
                   by reference, which is what lets the engine keep its
                   device-resident copies across a delta;
  * stats:         O(E) features recomputed, the expensive ones (coherence,
                   specialty, literal selectivity, diversity) patched via
                   per-type / per-predicate term caches with the summation
                   replayed in the same order as a from-scratch build.

A delta that can't be maintained incrementally — new/dropped labels, new
predicates, node-kind changes, the vertex-cover NI variant, or churn above
``churn_threshold`` — falls back to a full rebuild (``delta_info["mode"] ==
"rebuild"`` with the reason).  Incremental results are always byte-identical
to the rebuild; the fallback only changes *cost*, never answers.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Iterable, Sequence

import numpy as np

from .graph import RDFGraph, IDMap, _csr, csr_patch, ATTR, REL, LITERAL, RESOURCE
from .ni_index import (NIEntry, NIIndex, _pack, build_ni_index, khop_rows,
                       patch_entry)
from .stats import (DatasetStats, _find_type_predicate, coherence_from_terms,
                    coherence_terms, compute_stats, literal_diversity,
                    literal_selectivity, node_degrees, predicate_fanout,
                    predicate_selectivity, specialty_from_terms,
                    specialty_terms)

# Engine variant table (paper §5/§6 configurations).  Lives here — not in
# engine.py — so Dataset.build can size the NI index for a variant without
# importing the engine (dataset is a lower layer).
ENGINE_VARIANTS: dict[str, dict] = {
    # d: NI depth to build; policy: §4.3 check policy; var: NI variant;
    # d_check: depth the check consults.
    "stwig+":    dict(d=1, policy="never", var="full", d_check=1),
    "spath_ni2": dict(d=2, policy="always", var="full", d_check=2),
    "h2":        dict(d=2, policy="selective", var="full", d_check=2),
    "h3":        dict(d=3, policy="selective", var="full", d_check=3),
    "hvc":       dict(d=2, policy="selective", var="vc", d_check=2),
    "rdf_h":     dict(d=2, policy="selective", var="full", d_check=2),
}


def content_digest(graph: RDFGraph) -> str:
    """Content digest of the edge structure (16 hex chars).

    Identical bytes to the historical ``plan_cache.dataset_key`` so learned
    state snapshotted before this API existed still matches.
    """
    h = hashlib.sha1()
    h.update(f"{graph.num_nodes}n-{graph.num_edges}e".encode())
    for arr in (graph.src, graph.dst, graph.pred):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def interval_footprint_hit(iv, touched: np.ndarray | None) -> bool:
    """True if any candidate interval [lo, hi) contains a touched node.

    ``touched`` is the sorted array of node ids whose NI rows a delta
    recomputed (None = full rebuild = everything touched); an unknown
    footprint (``iv`` None) also counts as hit.  A prepared query's
    candidate masks, a reach entry, or a cached result can only change
    if its footprint intersects the touched set — so this is the single
    soundness predicate behind every revalidate-vs-drop decision.
    """
    if iv is None or touched is None:
        return True
    if len(touched) == 0:
        return False
    for lo, hi in iv:
        if lo >= hi:
            continue
        i = int(np.searchsorted(touched, lo, side="left"))
        if i < len(touched) and int(touched[i]) < hi:
            return True
    return False


def _reach_within(csr, seeds: np.ndarray, depth: int) -> np.ndarray:
    """Multi-source BFS: all nodes within ``depth`` hops of ``seeds``
    (inclusive) following the given CSR adjacency.  Sorted int64."""
    indptr, nbr, _ = csr
    seen = np.unique(np.asarray(seeds, dtype=np.int64))
    frontier = seen
    for _ in range(max(depth, 0)):
        if frontier.size == 0:
            break
        sizes = indptr[frontier + 1] - indptr[frontier]
        if sizes.sum() == 0:
            break
        idx = np.concatenate([np.arange(indptr[f], indptr[f + 1])
                              for f in frontier])
        nxt = np.setdiff1d(np.unique(nbr[idx]).astype(np.int64), seen,
                           assume_unique=True)
        seen = np.union1d(seen, nxt)
        frontier = nxt
    return seen


# ---------------------------------------------------------------------- #
@dataclass
class Dataset:
    """Owns ``{graph, IDMap, NI index, stats, version, digest}``.

    Construct with :meth:`build` / :meth:`from_triples`; evolve with
    :meth:`apply_delta`.  Instances are immutable in use: ``apply_delta``
    returns a fresh ``Dataset`` and never touches the receiver.
    """

    graph: RDFGraph
    idmap: IDMap
    ni: NIIndex
    stats: DatasetStats
    digest: str
    version: int = 0
    # --- delta bookkeeping (for version-scoped cache revalidation) ------ #
    # Sorted node ids whose NI rows the producing delta recomputed; None
    # for a base build or a full rebuild (= treat everything as touched).
    touched: np.ndarray | None = None
    # Sorted endpoints of the delta's changed edges (incremental only).
    delta_endpoints: np.ndarray | None = None
    delta_info: dict = field(default_factory=lambda: {"mode": "base"})
    # --- rebuild parity knobs ------------------------------------------- #
    literal_forced: frozenset | None = None
    cap_quantile: float = 1.0
    max_cap: int = 4096
    # Lazy per-type / per-predicate stat term caches ({"coh":…, "spec":…}).
    _stat_terms: dict | None = field(default=None, repr=False)

    # ------------------------------------------------------------------ #
    @property
    def cache_key(self) -> str:
        """The (digest, version)-scoped identity every cache keys on."""
        return f"{self.digest}:v{self.version}"

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, graph: RDFGraph, variant: str = "rdf_h", *,
              d_max: int | None = None, ni_variant: str | None = None,
              m: int = 5, ni: NIIndex | None = None,
              stats: DatasetStats | None = None,
              cap_quantile: float = 1.0, max_cap: int = 4096,
              literal_forced: Iterable[str] | None = None) -> "Dataset":
        """Version-0 Dataset for ``graph``.

        ``variant`` picks NI depth/shape from ``ENGINE_VARIANTS``;
        ``d_max``/``ni_variant`` override it.  A pre-built ``ni``/``stats``
        is adopted as-is (its own depth/variant win).
        """
        spec = ENGINE_VARIANTS.get(variant, ENGINE_VARIANTS["rdf_h"])
        if ni is None:
            ni = build_ni_index(graph,
                                d_max=d_max if d_max is not None else spec["d"],
                                m=m,
                                variant=ni_variant or spec["var"],
                                cap_quantile=cap_quantile, max_cap=max_cap)
        if stats is None:
            stats = compute_stats(graph)
        if literal_forced is None:
            # Best-effort recovery of from_triples(literal_objects=...):
            # a LITERAL node that appears as a subject can only exist by
            # forcing, and re-forcing default literals is idempotent.
            ever_subj = np.zeros(graph.num_nodes, dtype=bool)
            ever_subj[graph.src] = True
            forced = graph.labels[(graph.node_kind == LITERAL) & ever_subj]
            literal_forced = frozenset(str(s) for s in forced) or None
        else:
            literal_forced = frozenset(literal_forced)
        return cls(graph=graph, idmap=IDMap(graph), ni=ni, stats=stats,
                   digest=content_digest(graph), version=0,
                   literal_forced=literal_forced,
                   cap_quantile=cap_quantile, max_cap=max_cap)

    @classmethod
    def from_triples(cls, triples, literal_objects=None, variant: str = "rdf_h",
                     **kw) -> "Dataset":
        graph = RDFGraph.from_triples(triples, literal_objects=literal_objects)
        forced = frozenset(literal_objects) if literal_objects else None
        return cls.build(graph, variant=variant, literal_forced=forced, **kw)

    @classmethod
    def from_arrays(cls, arrays: dict, variant: str = "rdf_h",
                    m: int = 5) -> "Dataset":
        """Dataset from plain numpy arrays, adopting the NI index as given.

        ``arrays`` holds the graph's ``labels``, ``node_kind``, ``src``,
        ``dst``, ``pred``, ``predicates`` and ``pred_kind``, and for every
        signed distance ``k`` of the NI index ``ni.{k}.ids`` and
        ``ni.{k}.overflow`` (``ni.{k}.count`` optionally).  The NI index is
        not recomputed: its per-bin summaries are derived from the ids the
        way ``build_ni_index`` derives them, and a missing ``count`` is
        taken as the stored row length (cap + 1 where the row overflowed).
        Stats are recomputed from the graph."""
        graph = RDFGraph(**{k: np.asarray(arrays[k]) for k in (
            "labels", "node_kind", "src", "dst", "pred", "predicates",
            "pred_kind")})
        entries = {}
        for key in arrays:
            if key.startswith("ni.") and key.endswith(".ids"):
                k = int(key.split(".")[1])
                ids = np.ascontiguousarray(arrays[key], dtype=np.int32)
                overflow = np.asarray(arrays[f"ni.{k}.overflow"], dtype=bool)
                count = arrays.get(f"ni.{k}.count")
                if count is None:
                    count = (ids >= 0).sum(axis=1).astype(np.int32)
                    count[overflow] = ids.shape[1] + 1
                packed = _pack([row[row >= 0] for row in ids], ids.shape[1], m)
                entries[k] = NIEntry(ids=ids,
                                     count=np.asarray(count, np.int32),
                                     overflow=overflow,
                                     bin_lo=packed.bin_lo,
                                     bin_hi=packed.bin_hi)
        if not entries:
            raise ValueError("from_arrays needs the NI entries (ni.{k}.ids)")
        ni = NIIndex(d_max=max(abs(k) for k in entries), m=m,
                     entries=entries, variant="full")
        return cls.build(graph, variant=variant, ni=ni)

    def engine(self, variant: str = "rdf_h", *, device: str = "cuda", **kw):
        """Convenience: build an Engine over this Dataset on ``device``
        (local import — the engine layer sits above this one)."""
        from .engine import make_engine
        return make_engine(self, variant=variant, device=device, **kw)

    # ------------------------------------------------------------------ #
    # Delta ingest
    # ------------------------------------------------------------------ #
    def apply_delta(self, inserts: Sequence = (), deletes: Sequence = (),
                    churn_threshold: float = 0.05) -> "Dataset":
        """New Dataset with ``inserts`` added and ``deletes`` removed.

        Deletes use RDF set semantics: every copy of a matching triple goes;
        a delete naming an unknown label/predicate is a no-op.  Incremental
        maintenance runs when the delta keeps the label set, node kinds and
        NI variant stable and churn stays under ``churn_threshold``;
        otherwise a full rebuild on the post-delta triples (same answers,
        higher cost — see ``delta_info``).
        """
        inserts = [tuple(str(x) for x in t) for t in inserts]
        deletes = [tuple(str(x) for x in t) for t in deletes]
        g = self.graph

        if self.ni.variant != "full":
            return self._rebuild(inserts, deletes, "ni-variant")

        ins_ids = self._resolve(inserts)
        if ins_ids is None:
            return self._rebuild(inserts, deletes, "new-label")
        ins_src, ins_pred, ins_dst = ins_ids
        if ins_src.size and (g.node_kind[ins_src] != RESOURCE).any():
            return self._rebuild(inserts, deletes, "node-kind")

        # Deletes that don't resolve can't exist -> silently no-ops.
        del_ids = self._resolve(deletes, partial=True)
        del_src, del_pred, del_dst = del_ids
        del_mask = self._edge_match(del_src, del_pred, del_dst)
        n_del = int(del_mask.sum())

        churn = (len(inserts) + n_del) / max(g.num_edges, 1)
        if churn > churn_threshold:
            return self._rebuild(inserts, deletes, "churn")

        keep = ~del_mask
        new_src = np.concatenate([g.src[keep], ins_src]).astype(np.int32)
        new_dst = np.concatenate([g.dst[keep], ins_dst]).astype(np.int32)
        new_pred = np.concatenate([g.pred[keep], ins_pred]).astype(np.int32)

        if n_del:
            # A label vanishing from the edge set, or a still-deleted
            # subject losing its last subject slot, would renumber ids /
            # flip node kinds on a rebuild — incremental can't keep parity.
            ds_ = g.src[del_mask]
            dd_ = g.dst[del_mask]
            mentioned = np.zeros(g.num_nodes, dtype=bool)
            mentioned[new_src] = True
            mentioned[new_dst] = True
            if not mentioned[ds_].all() or not mentioned[dd_].all():
                return self._rebuild(inserts, deletes, "label-dropped")
            still_subj = np.zeros(g.num_nodes, dtype=bool)
            still_subj[new_src] = True
            if not still_subj[ds_].all():
                return self._rebuild(inserts, deletes, "node-kind")

        return self._incremental(new_src, new_dst, new_pred,
                                 g.src[del_mask], g.dst[del_mask],
                                 g.pred[del_mask],
                                 ins_src, ins_dst, ins_pred,
                                 n_ins=len(inserts), n_del=n_del)

    # ------------------------------------------------------------------ #
    def _resolve(self, triples, partial: bool = False):
        """(src, pred, dst) id arrays for string triples.  Exact label /
        predicate lookups only; with partial=True unresolvable triples are
        dropped, otherwise returns None."""
        g = self.graph
        if not triples:
            z = np.empty(0, dtype=np.int32)
            return z, z.copy(), z.copy()
        subs = np.asarray([t[0] for t in triples])
        prds = np.asarray([t[1] for t in triples])
        objs = np.asarray([t[2] for t in triples])

        def lookup(vals, table):
            i = np.searchsorted(table, vals)
            i = np.minimum(i, len(table) - 1) if len(table) else i
            ok = (len(table) > 0) & (table[i] == vals) if len(table) \
                else np.zeros(len(vals), dtype=bool)
            return i.astype(np.int32), ok

        si, s_ok = lookup(subs, g.labels)
        oi, o_ok = lookup(objs, g.labels)
        # predicates array is sorted (np.unique) — same trick applies
        pi, p_ok = lookup(prds, g.predicates)
        ok = s_ok & o_ok & p_ok
        if not ok.all():
            if not partial:
                return None
            si, pi, oi = si[ok], pi[ok], oi[ok]
        return si, pi, oi

    def _edge_match(self, d_src, d_pred, d_dst) -> np.ndarray:
        """Bool [E] mask of edges matching any delete triple (all copies)."""
        g = self.graph
        if d_src.size == 0:
            return np.zeros(g.num_edges, dtype=bool)
        n1 = np.int64(g.num_nodes + 1)
        p1 = np.int64(g.num_predicates + 1)
        pack = (g.src.astype(np.int64) * n1 + g.dst.astype(np.int64)) * p1 \
            + g.pred.astype(np.int64)
        dpack = (d_src.astype(np.int64) * n1 + d_dst.astype(np.int64)) * p1 \
            + d_pred.astype(np.int64)
        return np.isin(pack, dpack)

    # ------------------------------------------------------------------ #
    def _post_triples(self, inserts, deletes):
        """Post-delta triple list in rebuild-parity order: old triples in
        edge order minus deletes (set semantics), inserts appended."""
        g = self.graph
        drop = {tuple(t) for t in deletes}
        out = [t for t in zip(g.labels[g.src], g.predicates[g.pred],
                              g.labels[g.dst])
               if (str(t[0]), str(t[1]), str(t[2])) not in drop]
        out.extend(inserts)
        return out

    def _rebuild(self, inserts, deletes, reason: str) -> "Dataset":
        g2 = RDFGraph.from_triples(self._post_triples(inserts, deletes),
                                   literal_objects=self.literal_forced)
        ds = Dataset.build(g2, d_max=self.ni.d_max,
                           ni_variant=self.ni.variant, m=self.ni.m,
                           cap_quantile=self.cap_quantile,
                           max_cap=self.max_cap,
                           literal_forced=self.literal_forced)
        ds.version = self.version + 1
        ds.touched = None
        ds.delta_endpoints = None
        ds.delta_info = {"mode": "rebuild", "reason": reason,
                         "inserts": len(inserts), "deletes": len(deletes)}
        return ds

    # ------------------------------------------------------------------ #
    def _terms(self) -> dict:
        """Per-type coherence and per-predicate specialty terms for THIS
        dataset's graph (lazy; patched forward by _incremental so repeated
        deltas never pay a full recompute)."""
        if self._stat_terms is None:
            tp = self.stats.type_pred
            self._stat_terms = {
                "coh": coherence_terms(self.graph, tp) if tp is not None else {},
                "spec": specialty_terms(self.graph),
            }
        return self._stat_terms

    def _incremental(self, new_src, new_dst, new_pred,
                     del_src, del_dst, del_pred,
                     ins_src, ins_dst, ins_pred,
                     n_ins: int, n_del: int) -> "Dataset":
        g = self.graph
        n, p = g.num_nodes, g.num_predicates

        # --- graph: patched CSR, recomputed pred_kind ------------------- #
        out_csr = csr_patch(g.out_csr, n, p,
                            del_src, del_dst, del_pred,
                            ins_src, ins_dst, ins_pred)
        in_csr = csr_patch(g.in_csr, n, p,
                           del_dst, del_src, del_pred,
                           ins_dst, ins_src, ins_pred)
        new_pred_kind = np.zeros(p, dtype=np.int8)
        lit_edge = (g.node_kind[new_dst] == LITERAL).astype(np.int64)
        tot = np.bincount(new_pred, minlength=p)
        lit = np.bincount(new_pred, weights=lit_edge, minlength=p)
        new_pred_kind[(lit * 2) > tot] = ATTR
        g2 = replace(g, src=new_src, dst=new_dst, pred=new_pred,
                     pred_kind=new_pred_kind)
        if out_csr is None or in_csr is None:       # pack overflow guard
            out_csr = _csr(n, new_src, new_dst, new_pred)
            in_csr = _csr(n, new_dst, new_src, new_pred)
        g2.__dict__["out_csr"] = out_csr
        g2.__dict__["in_csr"] = in_csr
        g2.__dict__["avg_degree"] = g2.num_edges / max(n, 1)

        # --- NI: recompute k-hop rows of nodes near a changed edge ------ #
        d_max, m = self.ni.d_max, self.ni.m
        eps_u = np.unique(np.concatenate([del_src, ins_src]).astype(np.int64))
        eps_v = np.unique(np.concatenate([del_dst, ins_dst]).astype(np.int64))
        # A node's out-entry sees a changed edge u->v iff u is within
        # d_max-1 reverse (in-edge) hops — in the old or new graph.
        aff_out = np.union1d(_reach_within(g.in_csr, eps_u, d_max - 1),
                             _reach_within(in_csr, eps_u, d_max - 1)) \
            if eps_u.size else eps_u
        aff_in = np.union1d(_reach_within(g.out_csr, eps_v, d_max - 1),
                            _reach_within(out_csr, eps_v, d_max - 1)) \
            if eps_v.size else eps_v
        entries = dict(self.ni.entries)
        for sign, csr, aff in ((+1, out_csr, aff_out), (-1, in_csr, aff_in)):
            if aff.size == 0:
                continue                      # share the old tensors
            rows = khop_rows(csr, d_max, aff)
            for d in range(1, d_max + 1):
                entries[sign * d] = patch_entry(entries[sign * d], aff,
                                                rows[d - 1], m)
        ni2 = NIIndex(d_max=d_max, m=m, entries=entries,
                      vc_mask=None, variant="full")
        touched = np.union1d(aff_out, aff_in)
        endpoints = np.union1d(eps_u, eps_v)

        # --- stats ------------------------------------------------------ #
        stats2, terms2 = self._patch_stats(g2, del_pred, ins_pred,
                                           new_pred_kind, n_del, eps_u)
        ds = Dataset(graph=g2, idmap=self.idmap, ni=ni2, stats=stats2,
                     digest=content_digest(g2), version=self.version + 1,
                     touched=touched, delta_endpoints=endpoints,
                     delta_info={"mode": "incremental", "inserts": n_ins,
                                 "deletes": n_del,
                                 "touched": int(touched.size)},
                     literal_forced=self.literal_forced,
                     cap_quantile=self.cap_quantile, max_cap=self.max_cap)
        ds._stat_terms = terms2
        return ds

    # ------------------------------------------------------------------ #
    def _patch_stats(self, g2: RDFGraph, del_pred, ins_pred,
                     new_pred_kind, n_del: int, delta_subjects):
        """DatasetStats for g2, patching only delta-affected terms.  The
        sums replay in the same (sorted) order as a from-scratch
        compute_stats, so the floats come out bit-identical."""
        old = self.stats
        g = self.graph
        tp = _find_type_predicate(g2)           # predicates unchanged
        src_fan, dst_fan, avg_fan = predicate_fanout(g2)
        out_deg, in_deg = node_degrees(g2)

        flips = np.nonzero(g.pred_kind != new_pred_kind)[0]
        delta_preds = np.unique(np.concatenate(
            [del_pred.astype(np.int64), ins_pred.astype(np.int64),
             flips.astype(np.int64)]))

        # literal selectivity: per-predicate tables, per-predicate rng —
        # only delta/flipped ATTR predicates re-derive.
        lit_tab = dict(old.literal_selectivity)
        attr_aff = [int(pa) for pa in delta_preds if new_pred_kind[pa] == ATTR]
        if attr_aff:
            fresh = literal_selectivity(g2, preds=attr_aff)
            for pa in attr_aff:
                if pa in fresh:
                    lit_tab[pa] = fresh[pa]
                else:
                    lit_tab.pop(pa, None)
        for pa in delta_preds:
            if new_pred_kind[pa] != ATTR:
                lit_tab.pop(int(pa), None)

        terms = self._terms()
        # coherence: types whose member set or members' edges changed.
        coh_terms = dict(terms["coh"])
        if tp is not None:
            aff_types = [np.empty(0, dtype=np.int64)]
            for gg in (g, g2):
                tm = gg.pred == tp
                inst, typ = gg.src[tm], gg.dst[tm]
                aff_types.append(np.unique(
                    typ[np.isin(inst, delta_subjects)]).astype(np.int64))
            if int(tp) in delta_preds:
                for gg in (g, g2):
                    tm = gg.pred == tp
                    aff_types.append(np.unique(gg.dst[tm]).astype(np.int64))
            aff_types = np.unique(np.concatenate(aff_types))
            if aff_types.size:
                for t in aff_types:
                    coh_terms.pop(int(t), None)
                coh_terms.update(coherence_terms(g2, tp,
                                                 types=aff_types.tolist()))
            coh = coherence_from_terms(coh_terms)
        else:
            coh_terms = {}
            coh = 0.0

        # specialty: per-REL-predicate terms, only delta/flipped preds.
        spec_terms = dict(terms["spec"])
        if delta_preds.size:
            for pr in delta_preds:
                spec_terms.pop(int(pr), None)
            spec_terms.update(specialty_terms(
                g2, preds=[int(pr) for pr in delta_preds]))
        spec = specialty_from_terms(spec_terms)

        # diversity: attribute-edge word sample.  Kept when the attribute
        # edge multiset AND (if sampling) the edge indices are unchanged.
        attr_changed = (flips.size > 0
                        or (g.pred_kind[del_pred] == ATTR).any()
                        or (new_pred_kind[ins_pred] == ATTR).any())
        attr_count = int((new_pred_kind[g2.pred] == ATTR).sum())
        if not attr_changed and (n_del == 0 or attr_count <= 100_000):
            div = old.diversity
        else:
            div = literal_diversity(g2)

        stats2 = DatasetStats(
            pred_selectivity=predicate_selectivity(g2),
            literal_selectivity=lit_tab,
            coherence=coh,
            specialty=spec,
            diversity=div,
            type_pred=tp,
            src_fanout=src_fan,
            dst_fanout=dst_fan,
            avg_fanout=avg_fan,
            out_degree=out_deg,
            in_degree=in_deg,
        )
        return stats2, {"coh": coh_terms, "spec": spec_terms}
