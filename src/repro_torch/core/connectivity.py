"""Connection-edge evaluation (paper Algorithm 3).

For a pair (n_i, n_j) with distance constraint d_c: n_i's forward reach set
within ceil(d_c/2) hops must intersect n_j's backward reach set within
d_c - ceil(d_c/2) hops (both include the node itself at distance 0, which
the paper leaves implicit but is required for odd splits and direct edges).

Reach sets come from the NI index.  When the required hop count exceeds the
index's d_max, reach sets are expanded one hop at a time through distance-1
entries — this is exactly the expensive path the paper measures in §6.3
(1-hop index: 92% of query time; 3-hop: 3.6%).

Exactness: unlike the neighborhood *check*, connectivity decides final
results, so truncation cannot be tolerated — any overflowed row falls back
to an exact host-side BFS.

Two evaluation forms for a connection edge over candidate tables A, B:

  * cross+filter (the seed path): materialize A x B, then decide each pair
    with per-pair reach-set intersections (`connectivity_mask`) —
    O(|A|*|B|) in both work and peak memory.
  * reach-join (`reach_join` / `reach_filter`): extract the *distinct*
    endpoint nodes of each side (typically << row count), gather their
    exact reach sets once into flat (node, reach_id) pair tables, compute
    connected (a, b) endpoint pairs with ONE sort-merge join on reach_id
    (reusing the merge-probe machinery of matching.py), and equi-join the
    deduplicated pair table back against A and B — output work O(matches),
    no intermediate proportional to |A|*|B|.

Both are exact: reach gathering falls back to per-node BFS for NI-overflow
nodes and for hops beyond the index's d_max.  A `ReachCache` (engine-owned,
per query) memoizes reach sets across connection edges sharing endpoints.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from .graph import RDFGraph
from .ni_index import NIIndex
from .matching import (Table, DEFAULT_NESTED_MAX, join_tables, planned_join,
                       dedup_project, empty_table, filter_rows, _pow2)
from ..obs.trace import NULL_TRACER


# Synthetic column id for the reach-id column of (node, reach_id) pair
# tables — must never collide with a query-node id (those are >= 0).
REACH_ID_COL = -2


def hop_split(d_c: int) -> tuple[int, int]:
    """Algorithm 3's split of a distance constraint: forward reach within
    ceil(d_c/2) hops must intersect backward reach within the remainder.
    The single source of the split — execution (mask + reach-join), the
    cost model, and the selectivity estimate must all agree on it."""
    h_fwd = -(-d_c // 2)
    return h_fwd, d_c - h_fwd


def _gather_reach(ni: NIIndex, nodes: np.ndarray, hops: int, sign: int):
    """Reach ids within <= min(hops, d_max) via direct NI gathers.

    Returns (ids [P, R], overflow [P], frontier_ids [P, F] at exactly d_max
    or None if hops <= d_max)."""
    parts = [nodes[:, None].astype(np.int32)]          # distance 0: self
    overflow = np.zeros(len(nodes), dtype=bool)
    d_use = min(hops, ni.d_max)
    for d in range(1, d_use + 1):
        e = ni.entries[sign * d]
        parts.append(e.ids[nodes])
        overflow |= e.overflow[nodes]
    ids = np.concatenate(parts, axis=1)
    frontier = None
    if hops > ni.d_max:
        frontier = ni.entries[sign * ni.d_max].ids[nodes]
    return ids, overflow, frontier


def _dedup_rows(ids: np.ndarray, cap: int):
    """Sort rows descending, null out duplicates, truncate to cap.

    Returns (ids [P, <=cap], overflow [P]) — overflow true when valid
    uniques exceeded cap (row then unusable for exact decisions)."""
    s = np.sort(ids, axis=1)[:, ::-1]                  # desc: valid first
    dup = np.zeros_like(s, dtype=bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = np.where(dup, -1, s)
    s = np.sort(s, axis=1)[:, ::-1]
    counts = (s >= 0).sum(axis=1)
    overflow = counts > cap
    return s[:, :cap], overflow


def reach_sets(ni: NIIndex, nodes: np.ndarray, hops: int, sign: int,
               cap: int = 4096):
    """All node ids within <= hops (sign=+1 forward, -1 backward), deduped.

    Returns (ids [P, <=cap] int32 -1-padded, overflow [P] bool)."""
    ids, overflow, frontier = _gather_reach(ni, nodes, hops, sign)
    ids, of2 = _dedup_rows(ids, cap)
    overflow |= of2
    rem = hops - ni.d_max
    e1 = ni.entries[sign * 1]
    # bound the [p, slice, c1] expansion buffer to ~64M int32 (256MB)
    while rem > 0 and frontier is not None:
        p, f = frontier.shape
        slice_w = max(1, (1 << 26) // max(e1.cap * p, 1))
        new_frontier = np.full((p, 1), -1, np.int32)
        for fs in range(0, f, slice_w):
            blk = frontier[:, fs:fs + slice_w]                 # [p, w]
            safe = np.maximum(blk, 0)
            nxt = e1.ids[safe]                                 # [p, w, c1]
            nxt = np.where(blk[:, :, None] >= 0, nxt, -1).reshape(p, -1)
            overflow |= (e1.overflow[safe] & (blk >= 0)).any(axis=1)
            new_frontier, off = _dedup_rows(
                np.concatenate([new_frontier, nxt], axis=1), cap)
            overflow |= off
        frontier = new_frontier
        ids, of3 = _dedup_rows(np.concatenate([ids, frontier], axis=1), cap)
        overflow |= of3
        rem -= 1
    return ids, overflow


def _bfs_within(graph: RDFGraph, start: int, hops: int, forward: bool) -> set:
    indptr, nbr, _ = graph.out_csr if forward else graph.in_csr
    seen = {int(start)}
    frontier = [int(start)]
    for _ in range(hops):
        nxt = []
        for u in frontier:
            for v in nbr[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return seen


@dataclass
class ReachCache:
    """Memo of exact reach sets, keyed (node, hops, sign).

    Engine-owned per query by default (shared across every connection edge
    of one query, so edges with common endpoints never recompute a reach
    set — the caches `connectivity_mask` used to rebuild per call,
    hoisted).  The serving layer instead installs one server-owned cache
    with `max_entries` and/or `max_bytes` set, extending the reuse across
    queries (the dataset is immutable, so entries never go stale) with
    LRU eviction bounding the footprint.  `max_entries` bounds the key
    count; `max_bytes` bounds the accounted payload bytes — entry-count
    bounds alone break on hub-heavy graphs, where one entry holds a reach
    set of up to |N| ids.  Accounting: `arr.nbytes` for the array mirror,
    8 bytes/element for the set mirror (the int32 payload a set entry
    would occupy as an array plus equal slack for set overhead — an
    estimate, not a measurement, but monotone in set size which is what
    eviction needs).  Two mirrored stores (python sets for per-pair
    intersections, np arrays for the reach-join pair tables) convert
    lazily between each other; both stores of an evicted key go together,
    and a key's charge covers whichever mirrors currently exist."""
    sets: dict = field(default_factory=dict)
    arrays: dict = field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    max_entries: int | None = None      # LRU bound on distinct keys
    max_bytes: int | None = None        # LRU bound on accounted bytes
    total_bytes: int = 0
    _lru: OrderedDict = field(default_factory=OrderedDict, repr=False)
    _nbytes: dict = field(default_factory=dict, repr=False)

    def __len__(self) -> int:
        return len(self._lru)

    def _account(self, key) -> None:
        """Re-derive `key`'s byte charge from its live mirrors."""
        b = 0
        a = self.arrays.get(key)
        if a is not None:
            b += int(a.nbytes)
        s = self.sets.get(key)
        if s is not None:
            b += 8 * len(s)
        self.total_bytes += b - self._nbytes.get(key, 0)
        self._nbytes[key] = b

    def _evict(self, key) -> None:
        self.sets.pop(key, None)
        self.arrays.pop(key, None)
        self.total_bytes -= self._nbytes.pop(key, 0)
        self.evictions += 1

    def _touch(self, key) -> None:
        self._lru[key] = None
        self._lru.move_to_end(key)
        if self.max_entries is not None:
            while len(self._lru) > self.max_entries:
                self._evict(self._lru.popitem(last=False)[0])
        if self.max_bytes is not None:
            # never evict the just-touched key: a single entry larger
            # than the whole budget stays as a cache-of-one (evicting it
            # would thrash the entry currently in use)
            while self.total_bytes > self.max_bytes and len(self._lru) > 1:
                self._evict(self._lru.popitem(last=False)[0])

    def get_set(self, node: int, hops: int, sign: int) -> set | None:
        key = (node, hops, sign)
        s = self.sets.get(key)
        if s is None and key in self.arrays:
            s = self.sets[key] = set(int(x) for x in self.arrays[key])
            self._account(key)
        self.hits += s is not None
        self.misses += s is None
        if s is not None:
            self._touch(key)
        return s

    def put_set(self, node: int, hops: int, sign: int, s: set) -> None:
        key = (node, hops, sign)
        self.sets[key] = s
        self._account(key)
        self._touch(key)

    def get_array(self, node: int, hops: int, sign: int) -> np.ndarray | None:
        key = (node, hops, sign)
        a = self.arrays.get(key)
        if a is None and key in self.sets:
            s = self.sets[key]
            a = self.arrays[key] = np.fromiter(s, np.int32, len(s))
            self._account(key)
        self.hits += a is not None
        self.misses += a is None
        if a is not None:
            self._touch(key)
        return a

    def put_array(self, node: int, hops: int, sign: int,
                  arr: np.ndarray) -> None:
        key = (node, hops, sign)
        self.arrays[key] = arr
        self._account(key)
        self._touch(key)

    # ------------------------------------------------------------------ #
    def clear(self) -> int:
        """Drop every entry (full-rebuild delta: all ids may have moved).
        Returns the number of entries dropped."""
        n = len(self._lru)
        self.sets.clear()
        self.arrays.clear()
        self._lru.clear()
        self._nbytes.clear()
        self.total_bytes = 0
        self.evictions += n
        return n

    def invalidate_delta(self, endpoints: np.ndarray) -> int:
        """Drop entries an incremental Dataset delta may have changed.

        A changed edge u→v can only alter reach(n, h, sign) if the edge's
        near endpoint was already within h-1 hops of n — and anything
        within h-1 hops is in the stored reach set (or is n itself).  So
        an entry is stale only if {n} ∪ stored set intersects the delta's
        edge endpoints; everything else is provably unchanged and stays.
        Returns the number of entries dropped."""
        eps = set(int(x) for x in np.asarray(endpoints).ravel())
        if not eps:
            return 0
        stale = []
        for key in self._lru:
            node = int(key[0])
            if node in eps:
                stale.append(key)
                continue
            s = self.sets.get(key)
            if s is not None:
                if not eps.isdisjoint(s):
                    stale.append(key)
                continue
            a = self.arrays.get(key)
            if a is not None and len(a) and np.isin(a, list(eps)).any():
                stale.append(key)
        for key in stale:
            self._evict(key)
            del self._lru[key]
        return len(stale)


def _exact_reach(graph: RDFGraph, ni: NIIndex, node: int, hops: int,
                 sign: int, cache: ReachCache | None = None) -> set:
    """Exact reach set of one node: pure index reads when the NI index
    covers `hops` and the node's entries did not overflow (the paper's
    fast case), else exact BFS (the expensive case §6.3 measures)."""
    if cache is not None:
        s = cache.get_set(node, hops, sign)
        if s is not None:
            return s
    s = None
    if hops <= ni.d_max:
        s = {node}
        for d in range(1, hops + 1):
            e = ni.entries[sign * d]
            if e.overflow[node]:
                s = None
                break
            row = e.ids[node]
            s.update(int(x) for x in row[row >= 0])
    if s is None:
        s = _bfs_within(graph, node, hops, sign > 0)
    if cache is not None:
        cache.put_set(node, hops, sign, s)
    return s


def connectivity_mask(graph: RDFGraph, ni: NIIndex,
                      a_nodes: np.ndarray, b_nodes: np.ndarray,
                      d_c: int, bidirectional: bool = False,
                      *, impl: str = "auto", chunk: int = 1024,
                      cache: ReachCache | None = None) -> np.ndarray:
    """Exact mask[i] = exists directed path a->b (or b->a if bidirectional)
    of length <= d_c.

    Per-pair decision over memoized exact reach sets (`cache`; a local one
    is created when the caller does not pass an engine-owned cache).  Index
    reads where the NI index covers the hop split, per-node BFS beyond."""
    p = len(a_nodes)
    out = np.zeros(p, dtype=bool)
    h_fwd, h_bwd = hop_split(d_c)
    if cache is None:
        cache = ReachCache()
    for i in range(p):
        fs = _exact_reach(graph, ni, int(a_nodes[i]), h_fwd, +1, cache)
        bs = _exact_reach(graph, ni, int(b_nodes[i]), h_bwd, -1, cache)
        out[i] = not fs.isdisjoint(bs)
    if bidirectional:
        out |= connectivity_mask(graph, ni, b_nodes, a_nodes, d_c,
                                 False, impl=impl, chunk=chunk, cache=cache)
    return out


# ---------------------------------------------------------------------- #
# Reach-join: connection edges as set-at-a-time joins (no cross product).
# ---------------------------------------------------------------------- #
@dataclass
class ReachJoinInfo:
    """Execution telemetry of one reach-join / reach-filter (feeds
    QueryStats.conn_* via the engine)."""
    rows_a: int = 0                 # input table rows (side holding src)
    rows_b: int = 0
    distinct_a: int = 0             # distinct endpoint nodes per side
    distinct_b: int = 0
    reach_pairs: int = 0            # flat (node, reach_id) pairs gathered
    connected_pairs: int = 0        # deduped connected endpoint pairs
    peak_cap: int = 0               # largest intermediate table capacity


def reach_pairs(graph: RDFGraph, ni: NIIndex, nodes: np.ndarray, hops: int,
                sign: int, cap: int = 4096,
                cache: ReachCache | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Exact flat (node, reach_id) pairs for the given distinct nodes.

    Set-at-a-time NI gathers (`reach_sets`) where the index covers `hops`;
    per-node exact BFS for overflow rows and for hops > d_max.  Returns
    (pair_nodes [M], pair_reach [M]) int32 — every node contributes its
    full reach set including itself (distance 0)."""
    nodes = np.asarray(nodes)
    if nodes.size == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    per_node: dict[int, np.ndarray] = {}
    misses: list[int] = []
    for v in nodes:
        v = int(v)
        arr = None if cache is None else cache.get_array(v, hops, sign)
        if arr is not None:
            per_node[v] = arr
        else:
            misses.append(v)
    if misses:
        ids = overflow = None
        if hops <= ni.d_max:
            ids, overflow = reach_sets(ni, np.asarray(misses), hops, sign,
                                       cap=cap)
        for i, v in enumerate(misses):
            if ids is not None and not overflow[i]:
                row = ids[i]
                arr = row[row >= 0].astype(np.int32)
            else:                       # NI overflow or hops > d_max
                s = _bfs_within(graph, v, hops, sign > 0)
                arr = np.fromiter(s, np.int32, len(s))
            per_node[v] = arr
            if cache is not None:
                cache.put_array(v, hops, sign, arr)
    arrs = [per_node[int(v)] for v in nodes]
    counts = [a.shape[0] for a in arrs]
    pair_nodes = np.repeat(nodes.astype(np.int32), counts)
    pair_reach = (np.concatenate(arrs) if pair_nodes.size
                  else np.empty(0, np.int32))
    return pair_nodes, pair_reach


def _pair_table(pair_reach: np.ndarray, pair_nodes: np.ndarray,
                node_col: int, device) -> Table:
    """(node, reach_id) pairs as a 2-column device table keyed by the
    reach id.  Pre-sorted on host by reach id and tagged, so the
    sort-merge join on REACH_ID_COL skips both device sorts."""
    m = int(pair_reach.shape[0])
    order = np.argsort(pair_reach, kind="stable")
    rows = np.full((_pow2(m), 2), -1, np.int32)
    rows[:m, 0] = pair_reach[order]
    rows[:m, 1] = pair_nodes[order]
    return Table(cols=(REACH_ID_COL, node_col),
                 rows=torch.as_tensor(rows, device=device),
                 count=m, sort_order=(REACH_ID_COL,))


def distinct_column_values(table: Table, col: int) -> np.ndarray:
    """Sorted distinct valid values of one table column (host array —
    these drive the host-side NI gathers)."""
    if table.count == 0:
        return np.empty(0, np.int32)
    vals = table.rows[: table.count, table.cols.index(col)].cpu().numpy()
    u = np.unique(vals)
    return u[u >= 0].astype(np.int32)


def _directed_pairs(graph: RDFGraph, ni: NIIndex, a_vals, b_vals,
                    h_fwd: int, h_bwd: int, src_col: int, dst_col: int,
                    cap: int, impl: str, probe_impl: str, nested_max: int,
                    cache, telemetry, info: ReachJoinInfo,
                    fuse: bool, device) -> Table:
    """Connected (a, b) pairs for one direction: fwd(a) x bwd(b) joined on
    the shared reach id, deduplicated to distinct endpoint pairs."""
    fn, fr = reach_pairs(graph, ni, a_vals, h_fwd, +1, cap=cap, cache=cache)
    bn, br = reach_pairs(graph, ni, b_vals, h_bwd, -1, cap=cap, cache=cache)
    info.reach_pairs += int(fn.shape[0] + bn.shape[0])
    ta = _pair_table(fr, fn, src_col, device)
    tb = _pair_table(br, bn, dst_col, device)
    j = join_tables(ta, tb, impl=impl, nested_max=nested_max,
                    probe_impl=probe_impl, telemetry=telemetry, fuse=fuse)
    out = dedup_project(j, (src_col, dst_col))
    info.peak_cap = max(info.peak_cap, ta.cap, tb.cap, j.cap, out.cap)
    return out


def connected_pair_table(graph: RDFGraph, ni: NIIndex,
                         a_vals: np.ndarray, b_vals: np.ndarray,
                         d_c: int, bidirectional: bool,
                         cols: tuple[int, int], *, cap: int = 4096,
                         impl: str = "auto", probe_impl: str = "auto",
                         nested_max: int = DEFAULT_NESTED_MAX,
                         cache: ReachCache | None = None,
                         telemetry=None,
                         info: ReachJoinInfo | None = None,
                         fuse: bool = True, tracer=None,
                         device) -> Table:
    """Distinct (a, b) node pairs with a directed path a->b of length
    <= d_c (plus b->a when bidirectional), as a 2-column table over
    `cols` = (src_col, dst_col), sorted by it, on `device` (required:
    the joined tables' device).

    This is Alg. 3 evaluated set-at-a-time: one sort-merge join on the
    shared reach id replaces the per-pair set intersections."""
    info = info if info is not None else ReachJoinInfo()
    if tracer is None:
        tracer = NULL_TRACER
    with tracer.span("reach_pairs") as sp:
        src_col, dst_col = cols
        h_fwd, h_bwd = hop_split(d_c)
        cp = _directed_pairs(graph, ni, a_vals, b_vals, h_fwd, h_bwd,
                             src_col, dst_col, cap, impl, probe_impl,
                             nested_max, cache, telemetry, info, fuse,
                             device)
        if bidirectional:
            rev = _directed_pairs(graph, ni, b_vals, a_vals, h_fwd, h_bwd,
                                  dst_col, src_col, cap, impl, probe_impl,
                                  nested_max, cache, telemetry, info, fuse,
                                  device)
            # union: concat the padded buffers (valid rows need not form a
            # prefix — dedup_project tolerates that) and re-dedup
            perm = [rev.cols.index(c) for c in cp.cols]
            both = Table(cols=cp.cols,
                         rows=torch.cat([cp.rows, rev.rows[:, perm]]),
                         count=cp.count + rev.count)
            cp = dedup_project(both, cp.cols)
            info.peak_cap = max(info.peak_cap, cp.cap)
        info.connected_pairs = cp.count
        if sp.live:
            sp.set(reach_pairs=info.reach_pairs,
                   connected_pairs=info.connected_pairs,
                   distinct_a=len(a_vals), distinct_b=len(b_vals))
    return cp


def reach_join(graph: RDFGraph, ni: NIIndex, ta: Table, tb: Table,
               src_col: int, dst_col: int, d_c: int,
               bidirectional: bool = False, *,
               a_vals: np.ndarray | None = None,
               b_vals: np.ndarray | None = None,
               row_limit: int | None = None, cap: int = 4096,
               impl: str = "auto", nested_max: int = DEFAULT_NESTED_MAX,
               probe_impl: str = "auto", cache: ReachCache | None = None,
               telemetry=None, record=None,
               info: ReachJoinInfo | None = None,
               fuse: bool = True, tracer=None) -> Table:
    """Join tables `ta` and `tb` on the connection constraint
    dist(ta.src_col -> tb.dst_col) <= d_c, WITHOUT materializing the
    cross product: equivalent to
    filter(cross_join(ta, tb), connectivity_mask) but with output work
    O(matches) and peak intermediate capacity bounded by the match count
    (plus the pair tables), never by |A|*|B|."""
    info = info if info is not None else ReachJoinInfo()
    info.rows_a, info.rows_b = ta.count, tb.count
    if ta.count == 0 or tb.count == 0:
        return empty_table(ta.cols + tb.cols, device=ta.device)
    if a_vals is None:
        a_vals = distinct_column_values(ta, src_col)
    if b_vals is None:
        b_vals = distinct_column_values(tb, dst_col)
    info.distinct_a, info.distinct_b = len(a_vals), len(b_vals)
    cp = connected_pair_table(graph, ni, a_vals, b_vals, d_c, bidirectional,
                              (src_col, dst_col), cap=cap, impl=impl,
                              probe_impl=probe_impl, nested_max=nested_max,
                              cache=cache, telemetry=telemetry, info=info,
                              fuse=fuse, tracer=tracer, device=ta.device)
    # A |x| pairs on src_col, then |x| B on dst_col: both sized exactly
    # (no estimate: counts are known after each probe, so planned_join
    # allocates the exact pow2 capacity).
    t1 = planned_join(ta, cp, None, row_limit=row_limit, impl=impl,
                      nested_max=nested_max, probe_impl=probe_impl,
                      record=record, telemetry=telemetry, fuse=fuse,
                      tracer=tracer)
    out = planned_join(t1, tb, None, row_limit=row_limit, impl=impl,
                       nested_max=nested_max, probe_impl=probe_impl,
                       record=record, telemetry=telemetry, fuse=fuse,
                       tracer=tracer)
    out.truncated |= t1.truncated
    info.peak_cap = max(info.peak_cap, t1.cap, out.cap)
    return out


def reach_filter(graph: RDFGraph, ni: NIIndex, table: Table,
                 src_col: int, dst_col: int, d_c: int,
                 bidirectional: bool = False, *,
                 a_vals: np.ndarray | None = None,
                 b_vals: np.ndarray | None = None, cap: int = 4096,
                 impl: str = "auto", nested_max: int = DEFAULT_NESTED_MAX,
                 probe_impl: str = "auto", cache: ReachCache | None = None,
                 telemetry=None, record=None,
                 info: ReachJoinInfo | None = None,
                 fuse: bool = True, tracer=None) -> Table:
    """Intra-table connection filter as a reach-SEMI-join: keep rows whose
    (src_col, dst_col) values appear in the connected-pair table.
    Equivalent to filter_rows(table, connectivity_mask(...)) without the
    per-row host loop."""
    info = info if info is not None else ReachJoinInfo()
    info.rows_a = info.rows_b = table.count
    if table.count == 0:
        return table
    if a_vals is None:
        a_vals = distinct_column_values(table, src_col)
    if b_vals is None:
        b_vals = distinct_column_values(table, dst_col)
    info.distinct_a, info.distinct_b = len(a_vals), len(b_vals)
    cp = connected_pair_table(graph, ni, a_vals, b_vals, d_c, bidirectional,
                              (src_col, dst_col), cap=cap, impl=impl,
                              probe_impl=probe_impl, nested_max=nested_max,
                              cache=cache, telemetry=telemetry, info=info,
                              fuse=fuse, tracer=tracer, device=table.device)
    if cp.count == 0:
        return filter_rows(table, np.zeros(table.count, bool), kept=0)
    # shared cols = both endpoint cols, no new cols: the equi-join IS the
    # semi-join (cp rows are distinct, so each table row matches at most
    # one pair).
    out = planned_join(table, cp, None, impl=impl, nested_max=nested_max,
                       probe_impl=probe_impl, record=record,
                       telemetry=telemetry, fuse=fuse, tracer=tracer)
    info.peak_cap = max(info.peak_cap, out.cap)
    return out


def enumerate_shortest_paths(graph: RDFGraph, a: int, b: int, d_c: int,
                             max_paths: int = 1000) -> list[list[int]]:
    """Instantiate a connection edge: all SHORTEST directed paths a -> b of
    length <= d_c (paper Fig. 2, final stage: "connection edges are
    instantiated by enumerating all shortest paths").

    BFS layers record every shortest-predecessor, then paths are rebuilt
    by backtracking.  Returns [] if b is unreachable within d_c.
    """
    if a == b:
        return [[a]]
    indptr, nbr, _ = graph.out_csr
    parents: dict[int, list[int]] = {}
    dist = {a: 0}
    frontier = [a]
    found_at = None
    for d in range(1, d_c + 1):
        nxt = []
        for u in frontier:
            for v in nbr[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if v not in dist:
                    dist[v] = d
                    parents[v] = [u]
                    nxt.append(v)
                elif dist[v] == d:
                    parents[v].append(u)
        if b in dist:
            found_at = d
            break
        frontier = nxt
    if found_at is None:
        return []

    paths: list[list[int]] = []

    def back(node, suffix):
        if len(paths) >= max_paths:
            return
        if node == a:
            paths.append([a] + suffix)
            return
        for p in parents.get(node, ()):
            back(p, [node] + suffix)

    back(b, [])
    return paths


def instantiate_connections(graph: RDFGraph, result, query,
                            max_paths: int = 16) -> list[dict]:
    """For each match row, enumerate the shortest paths realizing every
    connection edge.  Returns one dict per row:
    {(src_q, dst_q): [path, ...], ...}."""
    out = []
    col_of = {c: i for i, c in enumerate(result.cols)}
    for row in result.rows:
        inst = {}
        for c in query.connections:
            pa = enumerate_shortest_paths(
                graph, int(row[col_of[c.src]]), int(row[col_of[c.dst]]),
                c.max_dist, max_paths)
            if not pa and c.bidirectional:
                pa = enumerate_shortest_paths(
                    graph, int(row[col_of[c.dst]]),
                    int(row[col_of[c.src]]), c.max_dist, max_paths)
            inst[(c.src, c.dst)] = pa
        out.append(inst)
    return out
