"""NI (Neighborhood Interval) index — dense device-native form.

Paper form: a 5-column table (node, signed distance, label-ID interval,
count, neighbor ids) binned by factor ``m``.  Dense form here: for each
signed distance ``k`` (negative = backward) a padded [N, cap_k] int32 tensor
of the ids of all nodes at shortest-path distance exactly |k|, sorted
ascending, padded with -1.  Because node id == label id (see graph.py), one
tensor serves both roles the paper splits across columns:

  * label-interval containment checks (Algorithm 1) — compare ids against a
    query keyword interval;
  * connectivity ID-list intersection (Algorithm 3) — intersect id lists.

Per-entry [min, max] summaries (the paper's "Label ID interval" column) are
kept per bin of ``m`` ids so the check can skip non-intersecting bins; the
check uses binary search over the sorted rows and ignores them.

Soundness under truncation: if a node has more than cap_k neighbors at
distance k the entry is truncated and its ``overflow`` bit set; every check
treats overflow as an automatic pass (prune only on certain information).

The vertex-cover variant (h-VC) indexes distance-2 entries only for nodes in
a 2-approximation vertex cover; other nodes carry overflow=True at |k|=2 so
checks degrade gracefully to 1-hop information.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from .graph import RDFGraph, INVALID


@dataclass
class NIEntry:
    """Index tensor for one signed distance."""
    ids: np.ndarray        # [N, cap] int32, sorted, -1 padded
    count: np.ndarray      # [N] int32 true count (may exceed cap)
    overflow: np.ndarray   # [N] bool
    bin_lo: np.ndarray     # [N, nbins] int32 per-bin min id (bin size = m)
    bin_hi: np.ndarray     # [N, nbins] int32 per-bin max id

    @property
    def cap(self) -> int:
        return int(self.ids.shape[1])

    @cached_property
    def stored_prefix(self) -> np.ndarray:
        """[N + 1] int64 prefix sums of each row's stored length
        min(count, cap): rows lo..hi-1 hold ``stored_prefix[hi] -
        stored_prefix[lo]`` ids.  Built on first use."""
        out = np.zeros(self.count.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.minimum(self.count, self.cap), out=out[1:])
        return out


@dataclass
class NIIndex:
    d_max: int
    m: int                              # binning factor (paper: 5)
    entries: dict[int, NIEntry]         # signed distance -> entry
    vc_mask: np.ndarray | None = None   # set for the vertex-cover variant
    variant: str = "full"               # "full" | "vc"

    def entry(self, k: int) -> NIEntry:
        return self.entries[k]

    def size_bytes(self) -> int:
        """Space actually used (paper Fig. 3): only real ids + summaries."""
        total = 0
        for k, e in self.entries.items():
            stored = np.minimum(e.count, e.cap).sum()
            nbins = np.ceil(np.minimum(e.count, e.cap) / self.m).sum()
            total += int(stored) * 4 + int(nbins) * 8 + e.count.nbytes // 4
        return total

    def dense_bytes(self) -> int:
        """Padded device footprint."""
        return sum(e.ids.nbytes + e.bin_lo.nbytes + e.bin_hi.nbytes
                   for e in self.entries.values())


# ---------------------------------------------------------------------- #
def _khop_sets(indptr: np.ndarray, nbr: np.ndarray, d_max: int,
               restrict: np.ndarray | None = None):
    """Exact k-hop neighbor id lists per node, per exact distance 1..d_max.

    restrict: optional bool [N]; nodes outside it only get distance-1 lists
    (vertex-cover variant).
    Returns list of lists-of-arrays: hops[d-1][n] = ids at distance exactly d.
    """
    n_nodes = indptr.shape[0] - 1
    hops = [[None] * n_nodes for _ in range(d_max)]
    for n in range(n_nodes):
        d1 = np.unique(nbr[indptr[n]:indptr[n + 1]])
        hops[0][n] = d1
    if d_max == 1:
        return hops
    for n in range(n_nodes):
        if restrict is not None and not restrict[n]:
            for d in range(1, d_max):
                hops[d][n] = np.empty(0, dtype=nbr.dtype)
            continue
        seen = {n}
        seen_arr = np.asarray([n], dtype=nbr.dtype)
        frontier = hops[0][n]
        seen_arr = np.union1d(seen_arr, frontier)
        for d in range(1, d_max):
            if frontier.size == 0:
                hops[d][n] = np.empty(0, dtype=nbr.dtype)
                frontier = hops[d][n]
                continue
            # expand frontier through CSR
            starts, ends = indptr[frontier], indptr[frontier + 1]
            sizes = ends - starts
            if sizes.sum() == 0:
                nxt = np.empty(0, dtype=nbr.dtype)
            else:
                idx = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
                nxt = np.unique(nbr[idx])
                nxt = np.setdiff1d(nxt, seen_arr, assume_unique=True)
            hops[d][n] = nxt
            seen_arr = np.union1d(seen_arr, nxt)
            frontier = nxt
    return hops


def khop_rows(csr, d_max: int, nodes: np.ndarray):
    """Exact k-hop lists for just ``nodes`` — row-for-row what `_khop_sets`
    would compute for them over the same CSR (same unique/union1d/setdiff1d
    pipeline, so a patched entry equals a rebuilt one).

    Returns ``rows[d-1][i]`` = ids at distance exactly d from ``nodes[i]``.
    """
    indptr, nbr, _ = csr
    out = [[None] * len(nodes) for _ in range(d_max)]
    for i, node in enumerate(nodes):
        n = int(node)
        d1 = np.unique(nbr[indptr[n]:indptr[n + 1]])
        out[0][i] = d1
        if d_max == 1:
            continue
        seen_arr = np.union1d(np.asarray([n], dtype=nbr.dtype), d1)
        frontier = d1
        for d in range(1, d_max):
            if frontier.size == 0:
                out[d][i] = np.empty(0, dtype=nbr.dtype)
                frontier = out[d][i]
                continue
            starts, ends = indptr[frontier], indptr[frontier + 1]
            sizes = ends - starts
            if sizes.sum() == 0:
                nxt = np.empty(0, dtype=nbr.dtype)
            else:
                idx = np.concatenate([np.arange(s, e)
                                      for s, e in zip(starts, ends)])
                nxt = np.unique(nbr[idx])
                nxt = np.setdiff1d(nxt, seen_arr, assume_unique=True)
            out[d][i] = nxt
            seen_arr = np.union1d(seen_arr, nxt)
            frontier = nxt
    return out


def patch_entry(entry: "NIEntry", rows: np.ndarray, lists, m: int) -> "NIEntry":
    """Copy-on-write row update: a new NIEntry whose arrays are copies of
    ``entry``'s with row ``rows[i]`` rewritten from ``lists[i]``.

    Capacity is kept fixed — a list longer than the entry's cap truncates
    with overflow=True, which every check treats as an automatic pass
    (sound: prune only on certain information).  Per-row bin summaries are
    recomputed exactly as `_pack` does, for blocks of rewritten rows at a
    time (the reference loops over every bin of every row).
    """
    ids = entry.ids.copy()
    count = entry.count.copy()
    overflow = entry.overflow.copy()
    bl = entry.bin_lo.copy()
    bh = entry.bin_hi.copy()
    cap = entry.cap
    written = []
    for r, arr in zip(rows, lists):
        r = int(r)
        c = int(arr.shape[0])
        count[r] = c
        overflow[r] = c > cap
        k = min(c, cap)
        ids[r, :k] = arr[:k]
        ids[r, k:] = INVALID
        written.append(r)
    _bin_summaries(ids, np.unique(np.asarray(written, np.int64)), m, bl, bh)
    return NIEntry(ids=ids, count=count, overflow=overflow,
                   bin_lo=bl, bin_hi=bh)


def _bin_summaries(ids: np.ndarray, rows: np.ndarray, m: int,
                   bl: np.ndarray, bh: np.ndarray) -> None:
    """bl/bh[rows] = min/max of the valid ids in each bin of m columns of
    ids[rows] (int32 max / INVALID for a bin with none), in place, 1,024
    rows at a time."""
    block = 1024
    nbins = bl.shape[1]
    pad = nbins * m - ids.shape[1]
    i32max = np.iinfo(np.int32).max
    for s in range(0, rows.size, block):
        rs = rows[s:s + block]
        blk = ids[rs]
        if pad:
            blk = np.concatenate(
                [blk, np.full((rs.size, pad), INVALID, blk.dtype)], 1)
        blk = blk.reshape(rs.size, nbins, m)
        valid = blk >= 0
        bl[rs] = np.where(valid, blk, i32max).min(axis=2)
        bh[rs] = np.where(valid, blk, INVALID).max(axis=2)


def _pack(lists, cap: int, m: int) -> NIEntry:
    n = len(lists)
    ids = np.full((n, cap), INVALID, dtype=np.int32)
    count = np.zeros(n, dtype=np.int32)
    overflow = np.zeros(n, dtype=bool)
    for i, arr in enumerate(lists):
        c = arr.shape[0]
        count[i] = c
        if c > cap:
            overflow[i] = True
            c = cap
        ids[i, :c] = arr[:c]
    nbins = max(1, -(-cap // m))
    bl = np.full((n, nbins), np.iinfo(np.int32).max, dtype=np.int32)
    bh = np.full((n, nbins), INVALID, dtype=np.int32)
    for b in range(nbins):
        blk = ids[:, b * m:(b + 1) * m]
        valid = blk >= 0
        any_v = valid.any(axis=1)
        bl[any_v, b] = np.where(valid, blk, np.iinfo(np.int32).max).min(axis=1)[any_v]
        bh[any_v, b] = np.where(valid, blk, -1).max(axis=1)[any_v]
    return NIEntry(ids=ids, count=count, overflow=overflow, bin_lo=bl, bin_hi=bh)


def vertex_cover_2approx(graph: RDFGraph) -> np.ndarray:
    """CLRS 2-approximation: repeatedly take both endpoints of an uncovered
    edge.  Deterministic (edge order)."""
    covered = np.zeros(graph.num_nodes, dtype=bool)
    in_cover = np.zeros(graph.num_nodes, dtype=bool)
    for s, d in zip(graph.src, graph.dst):
        if not (in_cover[s] or in_cover[d]):
            in_cover[s] = True
            in_cover[d] = True
    del covered
    return in_cover


def round_cap(x: int, minimum: int = 8) -> int:
    c = max(int(x), minimum)
    return 1 << (c - 1).bit_length()


def build_ni_index(graph: RDFGraph, d_max: int = 2, m: int = 5,
                   variant: str = "full",
                   cap_quantile: float = 1.0,
                   max_cap: int = 4096) -> NIIndex:
    """Build the NI index.

    cap_quantile < 1.0 trades space for overflow (sound; overflowing nodes
    simply cannot be pruned at that distance).
    """
    assert variant in ("full", "vc")
    vc = vertex_cover_2approx(graph) if variant == "vc" else None
    entries: dict[int, NIEntry] = {}
    for direction, csr in ((+1, graph.out_csr), (-1, graph.in_csr)):
        indptr, nbr, _ = csr
        restrict = vc if variant == "vc" else None
        hops = _khop_sets(indptr, nbr, d_max, restrict=restrict)
        for d in range(1, d_max + 1):
            sizes = np.asarray([a.shape[0] for a in hops[d - 1]])
            if sizes.size == 0:
                cap = 8
            elif cap_quantile >= 1.0:
                cap = round_cap(sizes.max() if sizes.size else 1)
            else:
                cap = round_cap(int(np.quantile(sizes, cap_quantile)))
            cap = min(cap, max_cap)
            entry = _pack(hops[d - 1], cap, m)
            if variant == "vc" and d > 1:
                # non-cover nodes have no stored info at this distance:
                # mark overflow so checks auto-pass (cannot prune).
                entry.overflow = entry.overflow | ~vc
            entries[direction * d] = entry
    return NIIndex(d_max=d_max, m=m, entries=entries,
                   vc_mask=vc, variant=variant)
