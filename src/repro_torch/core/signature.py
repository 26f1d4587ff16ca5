"""Neighborhood containment check (paper Algorithm 1) — vectorized.

Host side derives, for one query node q, the *requirements*: for each
direction (forward/backward) and each distance d <= d_check, the set of
keyword id-intervals that must appear among a candidate's <=d-hop neighbors,
each with a minimum count.  Counts aggregate nested intervals (the paper's
"uniquely contains" rule): if interval I' is contained in I, matches of I'
also satisfy I, so required counts accumulate over contained intervals.

Device side counts, per exact distance, the candidates' NI ids in each
interval, cumulative-sums over distance and compares against the
requirements: on CUDA all of it in one launch of the interval_count
kernel's node check per query node.  Overflowed NI entries auto-pass
(prune only on certain information).  The verdict stays on the device
(``check_template``): each launch writes its node's pass mask row in place
and counts its passes there, and the host reads the counts once a
template.

The gStore-style bloom prefilter (``bloom_prefilter``, with
``EngineConfig.use_bloom``) tests 1-hop bit signatures of exact keywords
with the bitmask_contains kernel before the check.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .graph import RDFGraph
from .ni_index import NIIndex
from .query import QueryTemplate
from ..kernels import ops
from ..obs.trace import to_host


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


@dataclass
class CheckCounts:
    """What the check did, summed over the query nodes it ran for: the
    nodes, the candidates that entered, those that passed, those that
    passed with an overflowed NI row in a checked segment (passed
    untested there), the stored ids of the checked segments' rows, and
    the times the check made the host wait on the device (``syncs``: a
    read, or an upload that blocks).  nodes, candidates and ids_read come
    from the NI index's host arrays; passed and overflow_passed from the
    launches' counters, in the check's one read."""
    nodes: int = 0
    candidates: int = 0
    passed: int = 0
    overflow_passed: int = 0
    ids_read: int = 0
    syncs: int = 0

    def add(self, other: "CheckCounts") -> None:
        for k, v in vars(other).items():
            setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        return dict(vars(self))


def upload_entry(ni: NIIndex, sign: int, d: int, device) -> tuple:
    """(ids, lens, overflow) of NI entry sign*d on ``device``: the ids,
    each row's stored length min(count, cap) and the overflow bits — the
    tensors the check keeps per (sign, d)."""
    e = ni.entries[sign * d]
    lens = np.minimum(e.count, e.cap).astype(np.int32)
    return (torch.as_tensor(e.ids, device=device),
            torch.as_tensor(lens, device=device),
            torch.as_tensor(e.overflow, device=device))


def _segments(reqs: NodeReqs, d_check: int, dev_entry) -> tuple:
    """(segments, keys) of one node's check: per direction with a
    requirement, its distances 1 up to the last that requires, each an
    ``ops.CheckSegment`` on the entry ``dev_entry(sign, d)`` gives, keyed
    (sign, d)."""
    segments, keys = [], []
    for sign, dreq in ((+1, reqs.fwd), (-1, reqs.bwd)):
        if dreq is None or not dreq.need.any():
            continue
        max_d = int(np.max(np.nonzero(dreq.need.any(axis=1))[0]) + 1)
        for d in range(1, min(d_check, max_d) + 1):
            need = dreq.need[d - 1]
            segments.append(ops.CheckSegment(
                *dev_entry(sign, d), lo=dreq.lo, hi=dreq.hi,
                need=need if need.sum() > 0 else None, first=d == 1))
            keys.append((sign, d))
    return segments, keys


def _buffers(q: int, n: int, device) -> tuple:
    """Pass mask rows [q, n] bool and counters [q, 3] int32 in one buffer,
    zeroed by one memset."""
    off = -(-q * n // 4) * 4
    buf = torch.zeros(off + 12 * q, dtype=torch.uint8, device=device)
    return (buf[:q * n].view(torch.bool).view(q, n),
            buf[off:].view(torch.int32).view(q, 3))


def check_template(ni: NIIndex, nodes: list, d_check: int, *, n: int,
                   impl: str = "auto", chunk: int = 8192,
                   device_cache: dict | None = None,
                   counts: CheckCounts, device, bloom=None) -> tuple:
    """The check of one template's query nodes, its verdict kept on
    ``device``.  nodes: a (NodeReqs, lo, hi) a node, its candidates
    lo..hi-1 of the n graph nodes.  Returns (specs, after): a pass spec a
    node, and the candidates that pass, summed over the nodes.

    A node whose check runs gets row q of one [Q, n] bool buffer, zeroed
    by one memset; its one ``ops.interval_check`` writes the verdict into
    the row in place and adds its passes (and passes with an overflowed
    row) to the row's counters on the device.  A node whose check does not
    run (no requirement, or no candidate) passes its interval: the spec
    (lo, hi).  The nodes' bounds and needs (``ops.check_words``) go up in
    one upload that does not wait, every launch is queued, and the host
    reads the [Q, 3] counters once: the one time it waits
    (``CheckCounts.syncs``).

    device: where the NI tensors live and the check runs; required, so a
    caller never lands on the CPU by leaving it out.  device_cache:
    persistent {(sign, d): (ids, lens, overflow) tensors on `device`}, so
    the NI tensors are uploaded once per engine, not per query (that one
    upload is the engine's set-up, not counted in ``syncs``).  bloom: None,
    or bloom(reqs, lo, hi) -> the prefilter's [hi - lo] bool verdict on the
    device (``bloom_prefilter``).  The host reads whether it passes any
    candidate (a sync); where it passes none the node is not checked and
    its row stays false, else its verdict is ANDed into the row after the
    check, and the row's count read.  counts: gets what the check did:
    nodes, candidates and ids_read from the entries' host summaries
    (``NIEntry.stored_prefix``), passed and overflow_passed, of the
    check's own verdict, from the counters."""
    d_check = min(d_check, ni.d_max)
    cache = device_cache if device_cache is not None else {}

    def dev_entry(sign, d):
        key = (sign, d)
        if key not in cache:
            cache[key] = upload_entry(ni, sign, d, device)
        return cache[key]

    specs = [(lo, hi) for _, lo, hi in nodes]
    runs = []                       # (node, segments, keys, words)
    for i, (reqs, lo, hi) in enumerate(nodes):
        if not reqs.empty and hi > lo:
            segments, keys = _segments(reqs, d_check, dev_entry)
            if segments:
                runs.append((i, segments, keys, ops.check_words(segments)))
    if not runs:
        return specs, sum(hi - lo for _, lo, hi in nodes)
    data = ops.upload(np.concatenate([w for *_, w in runs]), device)
    rows, tally = _buffers(len(runs), n, device)
    checked, syncs, at = [], 0, 0
    for r, (i, segments, keys, words) in enumerate(runs):
        _, lo, hi = nodes[i]
        specs[i] = row = rows[r]
        data_at, at = at, at + len(words)
        keep = None
        if bloom is not None:
            keep = bloom(nodes[i][0], lo, hi)
            syncs += 1
            if not bool(to_host(keep.any())):
                continue            # no candidate left: no check
        ops.interval_check(segments, lo, hi, impl=impl, chunk=chunk,
                           out=row, tally=tally[r, :2], data=data,
                           data_at=data_at)
        if keep is not None:
            row[lo:hi] &= keep
            tally[r, 2].copy_(row.sum())
        checked.append((r, keys, lo, hi))
    got = to_host(tally)
    syncs += 1
    counts.add(_count(ni, checked, got, syncs))
    kept = got[:, 2] if bloom is not None else got[:, 0]
    ran = {i for i, *_ in runs}
    return specs, int(kept.sum()) + sum(
        hi - lo for i, (_, lo, hi) in enumerate(nodes) if i not in ran)


def _count(ni: NIIndex, checked: list, tally: np.ndarray,
           syncs: int) -> CheckCounts:
    """The counts of one template's check: the nodes ``checked`` (counter
    row, segment keys, lo, hi), whose counters read ``tally``, and the
    host's waits."""
    out = CheckCounts(syncs=syncs)
    for r, keys, lo, hi in checked:
        ids_read = 0
        for sign, d in keys:
            e = ni.entries[sign * d]
            ids_read += int(e.stored_prefix[hi] - e.stored_prefix[lo])
        out.add(CheckCounts(nodes=1, candidates=hi - lo,
                            passed=int(tally[r, 0]),
                            overflow_passed=int(tally[r, 1]),
                            ids_read=ids_read))
    return out


# ---------------------------------------------------------------------- #
# Bloom/bitstring signature prefilter (gStore-style; uses the
# bitmask_contains kernel).  Sound one-sided filter for EXACT-keyword
# neighborhoods: if a required neighbor id's bits are not contained in a
# candidate's signature, the candidate cannot have that neighbor.
# ---------------------------------------------------------------------- #
BLOOM_WORDS = 8      # 256-bit signatures
_BLOOM_K = 2


def _bloom_bits(ids: np.ndarray, words: int = BLOOM_WORDS):
    """Bit positions (k hashes) for each id; ids int64 array."""
    n_bits = 32 * words
    h1 = (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) \
        >> np.uint64(40)
    h2 = (ids.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)) \
        >> np.uint64(40)
    return (h1 % n_bits).astype(np.int64), (h2 % n_bits).astype(np.int64)


def build_bloom(entry, words: int = BLOOM_WORDS) -> np.ndarray:
    """[N, words] uint32 signatures of each node's neighbor-id set."""
    n, cap = entry.ids.shape
    sig = np.zeros((n, words), np.uint32)
    ids = entry.ids
    valid = ids >= 0
    rows = np.repeat(np.arange(n), cap).reshape(n, cap)[valid]
    flat = ids[valid].astype(np.int64)
    for bits in _bloom_bits(flat, words):
        word, bit = bits // 32, bits % 32
        np.bitwise_or.at(sig, (rows, word.astype(np.int64)),
                         (np.uint32(1) << bit.astype(np.uint32)))
    return sig


def bloom_query_sig(required_ids: np.ndarray,
                    words: int = BLOOM_WORDS) -> np.ndarray:
    sig = np.zeros(words, np.uint32)
    for bits in _bloom_bits(required_ids.astype(np.int64), words):
        word, bit = bits // 32, bits % 32
        np.bitwise_or.at(sig, word.astype(np.int64),
                         np.uint32(1) << bit.astype(np.uint32))
    return sig


def bloom_prefilter(sigs: torch.Tensor, entry, reqs: NodeReqs,
                    lo: int, hi: int, *, impl: str = "auto", device,
                    overflow: torch.Tensor | None = None) -> torch.Tensor:
    """Pass mask (bool [hi - lo] on `device`) over candidates lo..hi using
    1-hop bloom signatures.

    sigs: ``build_bloom(entry)`` as int32 bit patterns on `device` (the
    engine uploads it once); the kernel reads the row slice sigs[lo:hi]
    in place.  device: where the query signature goes and the test runs;
    required, like check_template's.  overflow: the entry's overflow bits
    on `device`, where the caller keeps them; else the slice is uploaded.
    Only exact keywords (interval width 1) participate; wider intervals
    cannot be expressed as bits (the reason the paper's NI generalizes
    gStore-style signatures).  Overflowed entries auto-pass."""
    n_cand = hi - lo
    dreq = reqs.fwd
    if dreq is None or not dreq.need.any():
        return torch.ones(n_cand, dtype=torch.bool, device=device)
    exact = [(int(l),) for l, h, need in
             zip(dreq.lo, dreq.hi, dreq.need[0])
             if h - l == 1 and need > 0] if dreq.need.shape[0] else []
    if not exact:
        return torch.ones(n_cand, dtype=torch.bool, device=device)
    required = np.asarray([e[0] for e in exact], np.int64)
    qsig = ops.upload(bloom_query_sig(required).view(np.int32), device)
    ok = ops.bitmask_contains(sigs[lo:hi], qsig, impl=impl)
    over = (torch.as_tensor(entry.overflow[lo:hi], device=device)
            if overflow is None else overflow[lo:hi])
    return ok.bool() | over
