"""Neighborhood containment check (paper Algorithm 1) — vectorized.

Host side derives, for one query node q, the *requirements*: for each
direction (forward/backward) and each distance d <= d_check, the set of
keyword id-intervals that must appear among a candidate's <=d-hop neighbors,
each with a minimum count.  Counts aggregate nested intervals (the paper's
"uniquely contains" rule): if interval I' is contained in I, matches of I'
also satisfy I, so required counts accumulate over contained intervals.

Device side counts, per exact distance, the candidates' NI ids in each
interval with the interval_count kernel (which gathers the candidates' rows
itself), cumulative-sums over distance on the host, and compares against
the requirements.  Overflowed NI entries auto-pass (prune only on certain
information).  The bloom prefilter of the reference is not ported yet
(ROADMAP Queue 2).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .graph import RDFGraph
from .ni_index import NIIndex
from .query import QueryTemplate
from ..kernels import ops


@dataclass
class DirectionReqs:
    """Requirements in one direction for one query node."""
    # union of intervals referenced at any distance
    lo: np.ndarray          # [J] int64
    hi: np.ndarray          # [J] int64
    # per distance d (1-indexed -> row d-1): required count per interval
    # (0 = no requirement at that distance)
    need: np.ndarray        # [d_check, J] int32


@dataclass
class NodeReqs:
    fwd: DirectionReqs | None
    bwd: DirectionReqs | None

    @property
    def empty(self) -> bool:
        def e(r):
            return r is None or r.need.sum() == 0
        return e(self.fwd) and e(self.bwd)


def _query_distances(query: QueryTemplate, comp: set[int], q: int,
                     forward: bool) -> dict[int, int]:
    """Directed BFS distances from q inside one component."""
    adj: dict[int, list[int]] = {}
    for e in query.edges:
        if e.src in comp and e.dst in comp:
            if forward:
                adj.setdefault(e.src, []).append(e.dst)
            else:
                adj.setdefault(e.dst, []).append(e.src)
    dist = {q: 0}
    frontier = [q]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in adj.get(u, ()):
                if v not in dist:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    dist.pop(q)
    return dist


def build_requirements(query: QueryTemplate, comp: list[int], q: int,
                       d_check: int, intervals: np.ndarray) -> NodeReqs:
    """intervals: [Q, 2] keyword intervals from IDMap."""
    comp_set = set(comp)

    def one_direction(forward: bool) -> DirectionReqs | None:
        dist = _query_distances(query, comp_set, q, forward)
        within = [(u, d) for u, d in dist.items() if d <= d_check]
        if not within:
            return None
        ivs = sorted({(int(intervals[u][0]), int(intervals[u][1]))
                      for u, _ in within})
        lo = np.asarray([i[0] for i in ivs], dtype=np.int64)
        hi = np.asarray([i[1] for i in ivs], dtype=np.int64)
        need = np.zeros((d_check, len(ivs)), dtype=np.int32)
        # appearance count per (interval, distance)
        appear = np.zeros((d_check, len(ivs)), dtype=np.int32)
        idx = {iv: j for j, iv in enumerate(ivs)}
        for u, d in within:
            appear[d - 1, idx[(int(intervals[u][0]), int(intervals[u][1]))]] += 1
        cum = np.cumsum(appear, axis=0)          # within distance <= d
        # nested aggregation: need(I, d) = sum over I' contained in I
        for j, (l, h) in enumerate(ivs):
            contained = [j2 for j2, (l2, h2) in enumerate(ivs)
                         if l <= l2 and h2 <= h]
            need[:, j] = cum[:, contained].sum(axis=1)
        return DirectionReqs(lo=lo, hi=hi, need=need)

    return NodeReqs(fwd=one_direction(True), bwd=one_direction(False))


def _pow2(x, lo=256):
    return max(lo, 1 << (max(int(x), 1) - 1).bit_length())


def check_interval_candidates(ni: NIIndex, reqs: NodeReqs,
                              lo: int, hi: int, d_check: int,
                              *, impl: str = "auto",
                              chunk: int = 8192,
                              device_cache: dict | None = None,
                              device) -> np.ndarray:
    """Pass mask (bool [hi-lo]) for candidates lo..hi-1 of one query node.

    device: where the NI tensors live and the count runs; required, so a
    caller never lands on the CPU by leaving it out.
    device_cache: persistent {(sign, d): (ids, lens) tensors on `device`}
    so the NI tensors, and each row's stored length min(count, cap), are
    uploaded once per engine, not per query.  The count step
    (``repro.core.signature._gather_count``) is ``ops.interval_count``
    with the candidate ids: the CUDA kernel gathers the rows itself and
    searches only each row's stored prefix."""
    n_cand = hi - lo
    out = np.ones(n_cand, dtype=bool)
    if reqs.empty or n_cand == 0:
        return out
    d_check = min(d_check, ni.d_max)
    cache = device_cache if device_cache is not None else {}

    def dev_ids(sign, d):
        key = (sign, d)
        if key not in cache:
            e = ni.entries[sign * d]
            lens = np.minimum(e.count, e.cap).astype(np.int32)
            cache[key] = (torch.as_tensor(e.ids, device=device),
                          torch.as_tensor(lens, device=device))
        return cache[key]

    # pad candidate ids to a pow2 bucket, as the reference does
    c_pad = min(_pow2(n_cand), max(chunk, 256))
    for start in range(0, n_cand, c_pad):
        stop = min(start + c_pad, n_cand)
        cands = np.full(c_pad, lo, dtype=np.int32)
        cands[: stop - start] = np.arange(lo + start, lo + stop)
        cands_dev = torch.as_tensor(cands, device=device)
        ok = np.ones(stop - start, dtype=bool)
        for sign, dreq in ((+1, reqs.fwd), (-1, reqs.bwd)):
            if dreq is None or not dreq.need.any():
                continue
            j = dreq.lo.shape[0]
            j_pad = max(4, 1 << (j - 1).bit_length())
            lo_b = np.zeros(j_pad, np.int32)
            hi_b = np.zeros(j_pad, np.int32)
            lo_b[:j] = dreq.lo
            hi_b[:j] = dreq.hi
            lo_dev = torch.as_tensor(lo_b, device=device)
            hi_dev = torch.as_tensor(hi_b, device=device)
            cum = np.zeros((stop - start, j), dtype=np.int64)
            over = np.zeros(stop - start, dtype=bool)
            max_d = int(np.max(np.nonzero(dreq.need.any(axis=1))[0]) + 1)
            for d in range(1, min(d_check, max_d) + 1):
                entry = ni.entries[sign * d]
                ids_dev, lens_dev = dev_ids(sign, d)
                cnt = ops.interval_count(ids_dev, lo_dev, hi_dev,
                                         cands=cands_dev, lens=lens_dev,
                                         impl=impl)
                cum += cnt[: stop - start, :j].cpu().numpy()
                over |= entry.overflow[cands[: stop - start]]
                if dreq.need[d - 1].sum() > 0:
                    sat = (cum >= dreq.need[d - 1][None, :]).all(axis=1)
                    ok &= sat | over
        out[start:stop] = ok
    return out
