"""D-tree candidate generation and joins (paper Algorithm 2, steps 2-3).

Twin of ``repro.core.matching`` in PyTorch: the same tables, strategies,
order tags, telemetry and overflow/resume contract, on tensors that live
on the engine's device.

Candidate generation is *edge-parallel*: one pass over the full edge
array produces all (root, child) pairs matching a query edge.

Joins are planned per pair between three strategies:

  * ``sorted`` — sort-merge equi-join: shared join columns are packed into
    one int32 key, both sides are sorted once, per-row match ranges come
    from the merge-probe kernel and matches are expanded with a
    segment-offset gather (``kernels.ops.expand_gather``, the expand of
    all three join paths: one CUDA launch on the card).  When neither
    side has a cached sorted run, the whole pack→sort→probe→expand chain
    runs fused (``kernels.fused_join``) with a single scalar host sync.
  * ``radix`` — radix-partitioned hash join (``kernels.radix_join``):
    only the build side is partitioned; probe rows are compared against
    their bucket's span.  A's row order is preserved.
  * ``nested`` — the vectorized nested-loop join over |A|×|B| chunks.

Tables are capacity-padded to powers of 2 and carry their true counts;
capacity overflow raises CapacityOverflow with the exact size needed —
plus the completed sort+probe (or partition+probe) state — so the retry
re-runs only the expand.  `sort_order` tags and cached sorted runs let a
chain of joins on one key sort each side at most once; JoinTelemetry
counts sorts performed vs. avoided.

``jnp.nonzero(size=, fill_value=)`` becomes ``compact_indices`` (an int32
cumsum and a scatter, no host sync).  The host syncs are the reference's:
the mask sums, one total per fused join, the window size and total of the
radix join, the count vector of the staged join.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .graph import RDFGraph
from .decompose import DTree
from ..obs.trace import NULL_TRACER
from ..kernels import ops as kops
from ..kernels import fused_join as kfused
from ..kernels import radix_join as krad
from ..kernels.fused_join import compact_indices


DEFAULT_NESTED_MAX = 256      # planner: nested-loop below this table size

class CapacityOverflow(Exception):
    def __init__(self, needed: int):
        self.needed = int(needed)
        super().__init__(f"capacity overflow, need {needed}")


@dataclass
class SortedRun:
    """One cached sorted materialization of a table.

    rows: the table's rows permuted to be lexicographically nondecreasing
    by `key_cols` (valid rows first, padding last).  keys: the packed
    int32 join keys in that same order, cached only for single-column
    runs tagged with the side role they were built for (the invalid-row
    sentinel is per side).  Multi-column rank-packed keys depend on the
    partner table and are never cached (keys is None)."""
    rows: torch.Tensor
    keys: torch.Tensor | None = None
    key_side: str | None = None     # 'a' | 'b' (role keys were built for)


@dataclass
class CandidateTable:
    """First-class device-resident match table.

    rows[i] maps cols[j] -> graph node id; rows is capacity-padded (pow2)
    and `count` tracks the valid prefix.  `sort_order` names the column
    tuple the valid rows are lexicographically ordered by (None =
    unknown), and `_runs` caches sorted materializations keyed by column
    tuple."""
    cols: tuple[int, ...]
    rows: torch.Tensor         # [cap, len(cols)] int32, invalid rows = -1
    count: int                 # true number of valid rows
    truncated: bool = False    # row_limit hit (LIMIT semantics)
    sort_order: tuple[int, ...] | None = None   # current row order (or None)
    _runs: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def cap(self) -> int:
        return int(self.rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def numpy(self) -> np.ndarray:
        return self.rows[: self.count].cpu().numpy()

    def result_set(self) -> set[tuple[int, ...]]:
        """Deduplicated rows in *canonical* column order (columns sorted
        by query-node id).  Matches MatchResult.result_set."""
        order = np.argsort(self.cols, kind="stable")
        return {tuple(int(r[i]) for i in order) for r in self.numpy()}

    # ---------------- sort-run bookkeeping ------------------------- #
    def is_sorted_by(self, key_cols: tuple[int, ...]) -> bool:
        """True iff rows are already ordered by key_cols (a lexicographic
        sort by a longer tuple is also sorted by any prefix)."""
        return (self.sort_order is not None
                and len(self.sort_order) >= len(key_cols)
                and self.sort_order[: len(key_cols)] == tuple(key_cols))

    def sorted_run(self, key_cols: tuple[int, ...]) -> SortedRun | None:
        """A cached/implicit sorted materialization for key_cols, if any."""
        key_cols = tuple(key_cols)
        if self.is_sorted_by(key_cols):
            run = self._runs.get(key_cols)
            return run if run is not None else SortedRun(rows=self.rows)
        return self._runs.get(key_cols)

    # Each cached run holds a full sorted copy of the rows; cap how many a
    # table retains (FIFO) so a table joined on many distinct keys can't
    # pin unbounded device memory.
    MAX_CACHED_RUNS = 4

    def cache_run(self, key_cols: tuple[int, ...], rows_sorted: torch.Tensor,
                  keys_sorted: torch.Tensor | None = None,
                  key_side: str | None = None) -> None:
        if len(key_cols) != 1:
            keys_sorted = key_side = None   # partner-dependent, not reusable
        key_cols = tuple(key_cols)
        while key_cols not in self._runs \
                and len(self._runs) >= self.MAX_CACHED_RUNS:
            self._runs.pop(next(iter(self._runs)))
        self._runs[key_cols] = SortedRun(
            rows=rows_sorted, keys=keys_sorted, key_side=key_side)


# Historical name: the thin rows+count dataclass this grew out of.
Table = CandidateTable


@dataclass
class JoinTelemetry:
    """Per-query sort-reuse counters (threaded from the engine down into
    the sort-merge join path)."""
    sorts_performed: int = 0
    sorts_avoided: int = 0


def _pow2(x: int, lo: int = 64) -> int:
    return max(lo, 1 << (max(int(x), 1) - 1).bit_length())


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


# ---------------------------------------------------------------------- #
def graph_edges(graph: RDFGraph, device) -> tuple:
    """(src, dst, pred) int32 edge tensors of `graph` on `device` (the
    engine uploads them once and caches the tuple)."""
    return tuple(_i32(a, device) for a in (graph.src, graph.dst, graph.pred))


def _spec_device(*specs):
    for s in specs:
        if isinstance(s, torch.Tensor):
            return s.device
    return torch.device("cpu")


def _pass(spec, ids: torch.Tensor) -> torch.Tensor:
    """Endpoint pass test: a full-[N] bool mask, or a (lo, hi) interval
    pair — wildcard candidate sets stay intervals so no [N] mask is ever
    materialized for them."""
    if isinstance(spec, tuple):
        return (ids >= spec[0]) & (ids < spec[1])
    return spec[ids]


def _edge_pairs_mask(src, dst, pred, pred_id: int, pass_src, pass_dst):
    m = _pass(pass_src, src) & _pass(pass_dst, dst)
    return m & (pred == pred_id) if pred_id >= 0 else m


def _edge_pairs_gather(mask, src, dst, cap):
    e = src.shape[0]
    idx = compact_indices(mask, cap, e)
    safe = torch.clamp(idx, max=e - 1)
    pad = (idx >= e)[:, None]
    return torch.stack([src[safe], dst[safe]], dim=1).masked_fill(pad, -1)


def _join_gather(eq, a_rows, b_rows, new_sel, size, has_new):
    nb = eq.shape[1]
    idx = compact_indices(eq.reshape(-1), size, -1)
    pad = (idx < 0)[:, None]
    ii = torch.clamp(idx, min=0) // nb
    jj = torch.clamp(idx, min=0) - ii * nb
    left = a_rows[ii].masked_fill(pad, -1)
    if has_new:
        right = b_rows[jj][:, new_sel].masked_fill(pad, -1)
        return torch.cat([left, right], dim=1)
    return left


def edge_pairs(graph: RDFGraph, pred_id: int | None,
               pass_src, pass_dst,
               cols: tuple[int, int], cap: int | None = None,
               *, edges: tuple | None = None) -> Table:
    """All edges (s, d) with pred==pred_id (None = any) and both endpoint
    specs satisfied.  A spec is a full-[N] bool mask or a (lo, hi)
    interval pair (wildcard candidates).  `edges` are the graph's device
    edge tensors (``graph_edges``); without them the edges are uploaded to
    the device of a mask spec.  Returns a 2-column table."""
    if edges is None:
        edges = graph_edges(graph, _spec_device(pass_src, pass_dst))
    src, dst, pred = edges
    p = -1 if pred_id is None else int(pred_id)
    mask = _edge_pairs_mask(src, dst, pred, p, pass_src, pass_dst)
    if cols[0] == cols[1]:      # query self-loop: s == d, single column
        mask = mask & (src == dst)
        count = int(mask.sum())
        cap2 = cap or _pow2(count)
        if count > cap2:
            raise CapacityOverflow(count)
        e = graph.num_edges
        idx = compact_indices(mask, cap2, e)
        s = src[torch.clamp(idx, max=e - 1)].masked_fill(idx >= e, -1)
        return Table(cols=(cols[0],), rows=s[:, None], count=count)
    count = int(mask.sum())
    if cap is None:
        cap = _pow2(count)
    if count > cap:
        raise CapacityOverflow(count)
    rows = _edge_pairs_gather(mask, src, dst, cap)
    return Table(cols=cols, rows=rows, count=count)


# ---------------------------------------------------------------------- #
def _shared_and_new(a_cols, b_cols):
    shared = [(a_cols.index(c), b_cols.index(c)) for c in a_cols if c in b_cols]
    new = [j for j, c in enumerate(b_cols) if c not in a_cols]
    return shared, new


# --------------------- strategy choice / pricing ---------------------- #
# Work-proxy cost constants, the reference's (1 unit ~ one element op):
# a sort touches each element O(log n) times, so it is weighted far above
# the streaming compares of a hash-bucket window probe.
SORT_WEIGHT = 8.0         # per-element-per-log2 cost of a sort
RADIX_WINDOW = 4.0        # expected bucket-window width (hash + dup slack)
RADIX_MIN_PROBE = 8192    # radix eligible only at probe sides this large
RADIX_WORK_MAX = 1 << 25  # probe_cap * window elements before skew fallback


def strategy_costs(a_count: int, b_count: int, *, a_sorted: bool = False,
                   b_sorted: bool = False, n_shared: int = 1) -> dict:
    """Work-proxy cost of each join strategy at the given table sizes.

    a_sorted/b_sorted: a sorted run (or matching sort-order tag) already
    exists for the join key, so sort-merge skips that side's sort.  radix
    is only defined for single-column keys."""
    a, b = max(int(a_count), 1), max(int(b_count), 1)
    costs = {"nested": float(a) * float(b)}
    sort_a = 0.0 if a_sorted else SORT_WEIGHT * a * math.log2(a + 1)
    sort_b = 0.0 if b_sorted else SORT_WEIGHT * b * math.log2(b + 1)
    costs["sorted"] = sort_a + sort_b + float(a + b)
    if n_shared == 1:
        costs["radix"] = (SORT_WEIGHT * b * math.log2(b + 1)
                          + RADIX_WINDOW * a + float(b))
    return costs


def choose_join_strategy(a_count: int, b_count: int,
                         nested_max: int = DEFAULT_NESTED_MAX, *,
                         a_sorted: bool = False, b_sorted: bool = False,
                         n_shared: int = 1) -> str:
    """Cheapest strategy under `strategy_costs`, with two hard gates:
    tiny tables always take nested and radix needs a probe side of at
    least RADIX_MIN_PROBE rows."""
    if max(a_count, b_count) <= nested_max:
        return "nested"
    c = strategy_costs(a_count, b_count, a_sorted=a_sorted,
                       b_sorted=b_sorted, n_shared=n_shared)
    if "radix" in c and a_count >= RADIX_MIN_PROBE \
            and c["radix"] < c["sorted"]:
        return "radix"
    return "sorted"


def resolve_join_impl(a_count: int, b_count: int, impl: str = "auto",
                      nested_max: int = DEFAULT_NESTED_MAX, *,
                      a_sorted: bool = False, b_sorted: bool = False,
                      n_shared: int = 1) -> str:
    """Per-join strategy choice (`impl` other than 'auto' is forced)."""
    if impl != "auto":
        return impl
    return choose_join_strategy(a_count, b_count, nested_max,
                                a_sorted=a_sorted, b_sorted=b_sorted,
                                n_shared=n_shared)


def _resolve_for(a: "Table", b: "Table", impl: str, nested_max: int) -> str:
    """Resolve the strategy for a concrete table pair — shared by
    join_tables and planned_join so recording and execution agree."""
    shared, _ = _shared_and_new(a.cols, b.cols)
    if not shared:
        return "cross"
    kc = tuple(a.cols[i] for i, _ in shared)
    return resolve_join_impl(
        a.count, b.count, impl, nested_max,
        a_sorted=a.sorted_run(kc) is not None,
        b_sorted=b.sorted_run(kc) is not None,
        n_shared=len(shared))


# ------------------------- sort-merge path ---------------------------- #
_pack_keys = kfused.pack_keys


def _sort_rows_by_key(keys, rows):
    order = torch.argsort(keys, stable=True)
    return keys[order], rows[order]


@dataclass
class _ProbeResume:
    """Sort+probe results carried on CapacityOverflow so the exact-size
    retry re-runs only the expand — no second sort, probe, or host sync."""
    a_rows_s: torch.Tensor
    b_rows_s: torch.Tensor
    start: torch.Tensor
    cnt: torch.Tensor
    cnt_np: np.ndarray
    key_cols: tuple[int, ...]


def _reuse_key_order(a: Table, b: Table, shared):
    """Permute the shared-column order so that an existing sort order or
    cached run on either side becomes usable.  Prefers reusing the larger
    side (bigger sort skipped)."""
    if len(shared) < 2:
        return shared
    col_set = {a.cols[i] for i, _ in shared}
    best = None
    for t, weight in ((a, a.count), (b, b.count)):
        orders = []
        if t.sort_order is not None and len(t.sort_order) >= len(shared):
            orders.append(tuple(t.sort_order[: len(shared)]))
        orders.extend(k for k in t._runs if len(k) == len(shared))
        for o in orders:
            if set(o) == col_set and len(set(o)) == len(shared):
                if best is None or weight > best[0]:
                    best = (weight, o)
    if best is None:
        return shared
    by_col = {a.cols[i]: (i, j) for i, j in shared}
    return [by_col[c] for c in best[1]]


def _join_sorted(a: Table, b: Table, shared, new, cap, row_limit,
                 probe_impl: str, telemetry: JoinTelemetry | None = None,
                 resume: _ProbeResume | None = None,
                 fuse: bool = True) -> Table:
    out_cols = a.cols + tuple(b.cols[j] for j in new)
    if resume is None:
        shared = _reuse_key_order(a, b, shared)
        a_sel = tuple(s[0] for s in shared)
        b_sel = tuple(s[1] for s in shared)
        key_cols = tuple(a.cols[i] for i in a_sel)

        a_run = a.sorted_run(key_cols)
        b_run = b.sorted_run(key_cols)
        if fuse and a_run is None and b_run is None \
                and a.count * b.count < 1 << 31:
            # No sorted run to reuse on either side: the whole chain runs
            # fused with a single scalar host sync (the match total).
            return _join_sorted_fused(
                a, b, a_sel, b_sel, key_cols, out_cols, new, cap,
                row_limit, probe_impl, telemetry)
        a_rows_in = a_run.rows if a_run is not None else a.rows
        b_rows_in = b_run.rows if b_run is not None else b.rows
        # A cached single-column key run is reused only in the side role
        # it was built for; otherwise keys are rebuilt from the (possibly
        # pre-sorted) rows — order-preserving, so still sorted.
        a_keys = a_run.keys if (a_run is not None and a_run.keys is not None
                                and a_run.key_side == "a") else None
        b_keys = b_run.keys if (b_run is not None and b_run.keys is not None
                                and b_run.key_side == "b") else None
        if a_keys is None or b_keys is None:
            ak, bk = _pack_keys(a_rows_in, b_rows_in, a_sel, b_sel)
            a_keys = ak if a_keys is None else a_keys
            b_keys = bk if b_keys is None else b_keys
        if a_run is not None:
            a_keys_s, a_rows_s = a_keys, a_rows_in
            if telemetry is not None:
                telemetry.sorts_avoided += 1
        else:
            a_keys_s, a_rows_s = _sort_rows_by_key(a_keys, a.rows)
            a.cache_run(key_cols, a_rows_s, a_keys_s, "a")
            if telemetry is not None:
                telemetry.sorts_performed += 1
        if b_run is not None:
            b_keys_s, b_rows_s = b_keys, b_rows_in
            if telemetry is not None:
                telemetry.sorts_avoided += 1
        else:
            b_keys_s, b_rows_s = _sort_rows_by_key(b_keys, b.rows)
            b.cache_run(key_cols, b_rows_s, b_keys_s, "b")
            if telemetry is not None:
                telemetry.sorts_performed += 1
        start, cnt = kops.merge_probe(a_keys_s, b_keys_s, impl=probe_impl)

        # The per-row count vector syncs to host ONCE per join: summing in
        # int64 avoids the int32 wrap of a skewed >2^31-match join, and the
        # same array serves the capacity check, the overflow clip and the
        # exact-size retry.
        cnt_np = cnt.cpu().numpy()
    else:
        a_rows_s, b_rows_s = resume.a_rows_s, resume.b_rows_s
        start, cnt, cnt_np = resume.start, resume.cnt, resume.cnt_np
        key_cols = resume.key_cols
    total = int(cnt_np.sum(dtype=np.int64))
    out_count = total if row_limit is None else min(total, row_limit)
    truncated = row_limit is not None and total > row_limit
    if out_count >= 1 << 31:
        raise RuntimeError(
            f"join result ({total} rows) too large to materialize; "
            "set a row_limit")
    if cap is None:
        cap = _pow2(out_count)
    if out_count > cap:
        err = CapacityOverflow(out_count)
        err.resume = _ProbeResume(a_rows_s, b_rows_s, start, cnt, cnt_np,
                                  key_cols)
        raise err
    if total >= 1 << 31:
        # device cumsum would wrap: clip per-row counts on host so the
        # running total saturates at the row limit, then expand normally
        csum = cnt_np.astype(np.int64).cumsum()
        clipped = np.clip(out_count - (csum - cnt_np.astype(np.int64)),
                          0, cnt_np.astype(np.int64))
        cnt = _i32(clipped, cnt.device)
    rows = _merge_expand(a_rows_s, b_rows_s, start, cnt, out_count, cap,
                         tuple(new))
    # The expand emits output slots in sorted-a order: the result is
    # lexicographically ordered by the join key and inherits it.
    return Table(cols=out_cols, rows=rows, count=out_count,
                 truncated=truncated, sort_order=key_cols)


def _merge_expand(a_rows_s, b_rows_s, start, cnt, out_count: int, cap: int,
                  new_sel) -> torch.Tensor:
    """The expand of the staged and the uncapped fused sort-merge joins
    (``kops.expand_gather``), a seam of its own as in the reference: the
    fault point ``join_expand`` patches it, and the capped fused chain and
    the radix join expand without it."""
    return kops.expand_gather(a_rows_s, b_rows_s, start, cnt, out_count, cap,
                              new_sel)


def _join_sorted_fused(a: Table, b: Table, a_sel, b_sel, key_cols,
                       out_cols, new, cap, row_limit, probe_impl: str,
                       telemetry: JoinTelemetry | None) -> Table:
    """Fused sort-merge join (kernels.fused_join): one scalar sync.  Same
    output, telemetry, run caching and CapacityOverflow contract as the
    staged path."""
    limit = (min(row_limit, (1 << 31) - 1) if row_limit is not None
             else (1 << 31) - 1)
    if cap is not None:
        (rows, total_dev, a_keys_s, a_rows_s, b_keys_s, b_rows_s, start,
         cnt) = kfused.sort_probe_expand(
            a.rows, b.rows, limit, a_sel=a_sel, b_sel=b_sel, cap=cap,
            new_sel=tuple(new), has_new=bool(new), probe=probe_impl)
    else:
        a_keys_s, a_rows_s, b_keys_s, b_rows_s, start, cnt, total_dev = \
            kfused.sort_probe(a.rows, b.rows, a_sel=a_sel, b_sel=b_sel,
                              probe=probe_impl)
    if telemetry is not None:
        telemetry.sorts_performed += 2
    a.cache_run(key_cols, a_rows_s, a_keys_s, "a")
    b.cache_run(key_cols, b_rows_s, b_keys_s, "b")
    total = int(total_dev)          # the ONE host sync of this join
    out_count = total if row_limit is None else min(total, row_limit)
    truncated = row_limit is not None and total > row_limit
    if cap is None:
        cap = _pow2(out_count)
        rows = _merge_expand(a_rows_s, b_rows_s, start, cnt, out_count,
                             cap, tuple(new))
    elif out_count > cap:
        err = CapacityOverflow(out_count)
        err.resume = _ProbeResume(a_rows_s, b_rows_s, start, cnt,
                                  cnt.cpu().numpy(), key_cols)
        raise err
    return Table(cols=out_cols, rows=rows, count=out_count,
                 truncated=truncated, sort_order=key_cols)


# ------------------------- radix-hash path ---------------------------- #
@dataclass
class _RadixResume:
    """Partition+window+probe results carried on CapacityOverflow so the
    exact-size retry re-runs only the output assembly."""
    b_rows_p: torch.Tensor
    lt: torch.Tensor
    cnt: torch.Tensor
    win_start: torch.Tensor
    total: int
    key_cols: tuple[int, ...]


def _radix_bits(b_count: int) -> int:
    """Bucket count ~ 2x the build side (load factor ~0.5), clamped so
    the edge table stays trivial."""
    return max(4, min(16, max(b_count, 1).bit_length()))


def _join_radix(a: Table, b: Table, shared, new, cap, row_limit,
                probe_impl: str, telemetry: JoinTelemetry | None = None,
                resume: _RadixResume | None = None,
                fuse: bool = True) -> Table:
    """Radix-partitioned hash join: partition B by hashed key, probe each
    A row against its bucket span (a window of lmax keys, which the CUDA
    kernel reads in place).  A is never sorted and the output preserves
    A's row order.  A hot key that would make the window matrix quadratic
    falls back to sort-merge deterministically, as in the reference."""
    out_cols = a.cols + tuple(b.cols[j] for j in new)
    if resume is None:
        a_sel = tuple(s[0] for s in shared)
        b_sel = tuple(s[1] for s in shared)
        key_cols = tuple(a.cols[i] for i in a_sel)
        a_keys, b_keys = _pack_keys(a.rows, b.rows, a_sel, b_sel)
        bits = _radix_bits(b.count)
        b_keys_p, b_rows_p, edges, maxlen = krad.radix_partition(
            b_keys, b.rows, bits)
        lmax = _pow2(int(maxlen), lo=8)     # one scalar sync (window size)
        if a.cap * lmax > RADIX_WORK_MAX:
            return _join_sorted(a, b, shared, new, cap, row_limit,
                                probe_impl, telemetry=telemetry, fuse=fuse)
        lt, cnt, win_start = kops.radix_probe(a_keys, b_keys_p, edges,
                                              bits=bits, lmax=lmax,
                                              impl=probe_impl)
        total = int(cnt.sum())              # second scalar sync (total)
    else:
        b_rows_p, lt, cnt = resume.b_rows_p, resume.lt, resume.cnt
        win_start = resume.win_start
        total, key_cols = resume.total, resume.key_cols
    out_count = total if row_limit is None else min(total, row_limit)
    truncated = row_limit is not None and total > row_limit
    if cap is None:
        cap = _pow2(out_count)
    if out_count > cap:
        err = CapacityOverflow(out_count)
        err.resume = _RadixResume(b_rows_p, lt, cnt, win_start,
                                  total, key_cols)
        raise err
    rows = krad.radix_scatter(a.rows, b_rows_p, lt, cnt, win_start,
                              out_count, cap=cap, new_sel=tuple(new),
                              has_new=bool(new))
    # scatter slots are ordered by probe row: A's order is preserved
    return Table(cols=out_cols, rows=rows, count=out_count,
                 truncated=truncated, sort_order=a.sort_order)


# ------------------------- nested-loop path --------------------------- #
def _join_chunk_mask(a_rows, b_rows, a_sel, b_sel):
    """eq[i, j] = rows valid & all shared cols equal."""
    a_k = a_rows[:, a_sel]                          # [A, S]
    b_k = b_rows[:, b_sel]                          # [B, S]
    eq = (a_k[:, None, :] == b_k[None, :, :]).all(-1)
    valid = (a_rows[:, :1] >= 0) & (b_rows[None, :, 0] >= 0)
    return eq & valid


def _assemble(pieces: list, cap: int, ncols: int, device) -> torch.Tensor:
    """Stack device-resident row chunks into one padded device buffer."""
    out = torch.full((cap, ncols), -1, dtype=torch.int32, device=device)
    off = 0
    for p in pieces:
        out[off: off + p.shape[0]] = p
        off += int(p.shape[0])
    return out


def _join_nested(a: Table, b: Table, shared, new, cap, chunk, b_chunk,
                 row_limit) -> Table:
    a_sel = [s[0] for s in shared]
    b_sel = [s[1] for s in shared]
    out_cols = a.cols + tuple(b.cols[j] for j in new)

    pieces, total = [], 0
    truncated = False
    for bs in range(0, max(b.count, 1), b_chunk):
        b_rows_t = b.rows[bs: min(bs + b_chunk,
                                  min(b.cap, _pow2(b.count)))]
        if b_rows_t.shape[0] == 0:
            break
        for start in range(0, max(a.count, 1), chunk):
            a_rows = a.rows[start:start + chunk]
            eq = _join_chunk_mask(a_rows, b_rows_t, a_sel, b_sel)
            cnt = int(eq.sum())
            if cnt == 0:
                continue
            if row_limit is not None:
                remaining = row_limit - total
                if remaining <= 0:
                    truncated = True
                    break
                take = min(cnt, remaining)
                truncated |= take < cnt
            else:
                take = cnt
            rows = _join_gather(eq, a_rows, b_rows_t, list(new),
                                _pow2(cnt), bool(new))
            pieces.append(rows[:take])
            total += take
        if truncated:
            break
    if cap is None:
        cap = _pow2(total)
    if total > cap:
        raise CapacityOverflow(total)
    t = Table(cols=out_cols,
              rows=_assemble(pieces, cap, len(out_cols), a.device),
              count=total)
    t.truncated = truncated
    return t


# ---------------------------------------------------------------------- #
def join_tables(a: Table, b: Table, cap: int | None = None,
                chunk: int = 4096, b_chunk: int = 1 << 16,
                row_limit: int | None = None, impl: str = "auto",
                nested_max: int = DEFAULT_NESTED_MAX,
                probe_impl: str = "auto",
                telemetry: JoinTelemetry | None = None,
                fuse: bool = True,
                _resume=None) -> Table:
    """Equi-join on shared query-node columns.

    impl: 'auto' (planner picks per table sizes and sort state),
    'sorted', 'radix' or 'nested'.  With row_limit the join stops once
    the limit is reached (.truncated is set iff matches were dropped).
    telemetry counts sorts performed vs. avoided; fuse=False takes the
    staged sort-merge path; _resume (from a CapacityOverflow's .resume)
    replays a completed sort+probe or partition+probe at a larger
    capacity."""
    shared, new = _shared_and_new(a.cols, b.cols)
    if not shared:
        return cross_join(a, b, cap=cap, row_limit=row_limit)
    # A resume object encodes which pipeline produced it: a radix join
    # that fell back to sort-merge retries on the sort-merge path.
    if isinstance(_resume, _ProbeResume):
        return _join_sorted(a, b, shared, new, cap, row_limit, probe_impl,
                            telemetry=telemetry, resume=_resume, fuse=fuse)
    if isinstance(_resume, _RadixResume):
        return _join_radix(a, b, shared, new, cap, row_limit, probe_impl,
                           telemetry=telemetry, resume=_resume, fuse=fuse)
    impl = _resolve_for(a, b, impl, nested_max)
    if impl == "nested":
        return _join_nested(a, b, shared, new, cap, chunk, b_chunk,
                            row_limit)
    if impl == "radix":
        return _join_radix(a, b, shared, new, cap, row_limit, probe_impl,
                           telemetry=telemetry, fuse=fuse)
    return _join_sorted(a, b, shared, new, cap, row_limit, probe_impl,
                        telemetry=telemetry, fuse=fuse)


MAX_PRESIZE_CAP = 1 << 22     # estimate-driven preallocation ceiling (rows)


def planned_join(a: Table, b: Table, est: int | None,
                 row_limit: int | None = None, impl: str = "auto",
                 nested_max: int = DEFAULT_NESTED_MAX,
                 probe_impl: str = "auto", record=None,
                 chunk: int = 4096, b_chunk: int = 1 << 16,
                 telemetry: JoinTelemetry | None = None,
                 fuse: bool = True, tracer=None) -> Table:
    """Estimate-pre-sized join with a single exact-size overflow retry.

    The capacity hint from `est` is clamped by the worst-case output
    (|A|*|B|), the row limit and MAX_PRESIZE_CAP; an under-estimate costs
    one retry at the exact pow2 size, replaying the first attempt's
    sort+probe.  record(impl, est, actual, retried, cap) feeds QueryStats
    and the PreparedQuery recording.  An `est` with a `.cap` attribute
    (planner.CapEstimate, from the warm-run ReplayEstimator) pins the
    output capacity verbatim — and its `.impl`, when set, the strategy."""
    forced = getattr(est, "impl", None) if est is not None else None
    impl = _resolve_for(a, b, forced or impl, nested_max)
    cap_hint = None
    if est is not None:
        replay_cap = getattr(est, "cap", None)
        if row_limit is not None:
            est = min(est, row_limit)
        if replay_cap is not None:
            cap_hint = int(replay_cap)
        else:
            cap_hint = min(_pow2(int(est * 1.25) + 16),
                           _pow2(max(a.count, 1) * max(b.count, 1)),
                           MAX_PRESIZE_CAP)
            if row_limit is not None:
                cap_hint = min(cap_hint, _pow2(row_limit))
    kw = dict(row_limit=row_limit, impl=impl, probe_impl=probe_impl,
              chunk=chunk, b_chunk=b_chunk, telemetry=telemetry, fuse=fuse)
    if tracer is None:
        tracer = NULL_TRACER
    with tracer.span("join") as sp:
        sp0 = sa0 = 0
        if sp.live and telemetry is not None:
            sp0, sa0 = telemetry.sorts_performed, telemetry.sorts_avoided
        retried = False
        try:
            out = join_tables(a, b, cap=cap_hint, **kw)
        except CapacityOverflow as e:
            retried = True
            out = join_tables(a, b, cap=_pow2(e.needed),
                              _resume=getattr(e, "resume", None), **kw)
        if sp.live:
            sp.set(impl=impl, rows=out.count, cap=out.cap,
                   retried=retried, a_rows=a.count, b_rows=b.count,
                   est=None if est is None else int(est))
            if telemetry is not None:
                sp.set(sorts_performed=telemetry.sorts_performed - sp0,
                       sorts_avoided=telemetry.sorts_avoided - sa0)
    if record is not None:
        record(impl, est, out.count, retried, out.cap)
    return out


def _cross_expand(a_rows, b_rows, a_count: int, b_count: int, cap: int):
    t = torch.arange(cap, dtype=torch.int32, device=a_rows.device)
    bc = max(b_count, 1)
    # t < a*b  <=>  t // b < a: avoids the int32 product
    i0 = t // bc
    valid = (i0 < a_count) & (a_count > 0) & (b_count > 0)
    i = torch.clamp(i0, max=max(a_count - 1, 0))
    # j as t - i0*bc (subtraction form), as the reference writes it
    j = torch.clamp(t - i0 * bc, max=max(b_count - 1, 0))
    invalid = ~valid[:, None]
    return torch.cat([a_rows[i].masked_fill(invalid, -1),
                      b_rows[j].masked_fill(invalid, -1)], dim=1)


def cross_join(a: Table, b: Table, cap: int | None = None,
               row_limit: int | None = None) -> Table:
    """Cartesian product (used before connectivity-check joins), expanded
    on device with an index-arithmetic gather."""
    out_cols = a.cols + b.cols
    total = a.count * b.count
    truncated = False
    a_count, b_count = a.count, b.count
    if row_limit is not None and total > row_limit:
        truncated = True
        a_count = max(1, min(a_count, row_limit))
        b_count = max(1, row_limit // a_count)
        total = a_count * b_count
    if cap is None:
        cap = _pow2(total)
    if total > cap:
        raise CapacityOverflow(total)
    rows = _cross_expand(a.rows, b.rows, a_count, b_count, cap)
    # a-major expansion: the product stays ordered by whatever a was
    t = Table(cols=out_cols, rows=rows, count=total,
              sort_order=a.sort_order)
    t.truncated = truncated
    return t


# ---------------------------------------------------------------------- #
def single_node_table(node: int, lo: int, hi: int,
                      passed: np.ndarray | None, *, device) -> Table:
    """Candidates of an isolated query node as a 1-column table on
    `device`.

    passed: full-[N] bool mask (or None)."""
    ids = np.arange(lo, hi, dtype=np.int32)
    if passed is not None:
        ids = ids[np.asarray(passed, dtype=bool)[lo:hi]]
    cap = _pow2(len(ids))
    rows = np.full((cap, 1), -1, np.int32)
    rows[: len(ids), 0] = ids
    # ids come from an arange (optionally mask-filtered): already sorted
    return Table(cols=(node,), rows=_i32(rows, device), count=len(ids),
                 sort_order=(node,))


def dtree_candidates(graph: RDFGraph, tree: DTree,
                     pass_masks: dict,   # node -> [N] bool mask | (lo, hi)
                     row_limit: int | None = None,
                     join_impl: str = "auto",
                     nested_max: int = DEFAULT_NESTED_MAX,
                     probe_impl: str = "auto",
                     estimator=None, record=None,
                     telemetry: JoinTelemetry | None = None,
                     fuse: bool = True, tracer=None,
                     edges: tuple | None = None) -> Table:
    """Generate all candidate matches of one D-tree by sequential
    edge-parallel pair generation + joins on the root column.

    estimator(left_count, pred, outgoing, pair_count) -> estimated join
    rows (or None) pre-sizes each join's capacity; record(...) feeds
    QueryStats.  `edges`: the graph's device edge tensors."""
    if tracer is None:
        tracer = NULL_TRACER
    with tracer.span("dtree", root=tree.root) as sp:
        table: Table | None = None
        truncated = False
        for pred, child, outgoing in tree.edges:
            if outgoing:
                pairs = edge_pairs(graph, pred, pass_masks[tree.root],
                                   pass_masks[child],
                                   cols=(tree.root, child), edges=edges)
            else:
                pairs = edge_pairs(graph, pred, pass_masks[child],
                                   pass_masks[tree.root],
                                   cols=(child, tree.root), edges=edges)
            if table is None:
                table = pairs
            else:
                est = None if estimator is None else estimator(
                    table.count, pred, outgoing, pairs.count)
                table = planned_join(table, pairs, est,
                                     row_limit=row_limit,
                                     impl=join_impl, nested_max=nested_max,
                                     probe_impl=probe_impl, record=record,
                                     telemetry=telemetry, fuse=fuse,
                                     tracer=tracer)
            truncated |= table.truncated
            if table.count == 0:
                break
        if table is None:
            raise ValueError("a D-tree has at least one edge")
        table.truncated = truncated
        if sp.live:
            sp.set(rows=table.count, edges=len(tree.edges),
                   truncated=truncated)
    return table


def _injective_keep(rows, pairs):
    keep = rows[:, 0] >= 0                  # padding rows never survive
    for i, j in pairs:
        keep &= rows[:, i] != rows[:, j]
    return keep


def injective_filter(table: Table) -> Table:
    """Keep rows whose values are pairwise distinct across distinct query
    nodes (subgraph-isomorphism semantics)."""
    k = len(table.cols)
    if k < 2 or table.count == 0:
        return table
    pairs = tuple((i, j) for i in range(k) for j in range(i + 1, k)
                  if table.cols[i] != table.cols[j])
    if not pairs:
        return table
    keep = _injective_keep(table.rows, pairs)
    kept = int(keep.sum())
    if kept == table.count:
        return table
    return filter_rows(table, keep, kept=kept)


def _filter_gather(rows, keep, cap_out):
    cap_in = rows.shape[0]
    idx = compact_indices(keep, cap_out, cap_in)
    safe = torch.clamp(idx, max=cap_in - 1)
    return rows[safe].masked_fill((idx >= cap_in)[:, None], -1)


def empty_table(cols: tuple[int, ...], cap: int = 64, *,
                device) -> Table:
    """An empty capacity-padded table over `cols`, on `device`."""
    return Table(cols=tuple(cols),
                 rows=torch.full((cap, len(cols)), -1, dtype=torch.int32,
                                 device=device), count=0)


def dedup_project(table: Table, cols: tuple[int, ...],
                  impl: str = "auto") -> Table:
    """Distinct rows of `table` over the column subset `cols`, sorted by
    (and tagged with) `cols`.  Projection, lexsort, first-of-group mask
    and kept count run fused (kernels.fused_join.lexsort_distinct), then
    one host sync for the count and the compaction gather.  Valid rows
    may sit anywhere in the capacity, not just in a prefix."""
    if impl not in kops.IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    cols = tuple(cols)
    sel = tuple(table.cols.index(c) for c in cols)
    proj, keep, kept_dev = kfused.lexsort_distinct(table.rows, sel)
    kept = int(kept_dev)
    rows = _filter_gather(proj, keep, _pow2(kept))
    return Table(cols=cols, rows=rows, count=kept, truncated=table.truncated,
                 sort_order=cols)


def filter_rows(table: Table, keep, kept: int | None = None) -> Table:
    """Keep rows where keep[i] — a bool mask over either the first `count`
    rows (host callers) or the full capacity (device producers; padding
    rows must be False there).  Pass `kept` (the known number of True
    entries) to skip the host sync of the mask sum."""
    n = keep.shape[0]
    if n not in (table.count, table.cap):
        raise ValueError(f"keep mask length {n} matches neither "
                         f"count={table.count} nor cap={table.cap}")
    if isinstance(keep, torch.Tensor):
        keep = keep.to(device=table.device, dtype=torch.bool)
        if n != table.cap:
            keep = torch.cat([keep, torch.zeros(table.cap - n,
                                                dtype=torch.bool,
                                                device=table.device)])
    else:
        k = np.zeros(table.cap, bool)
        k[:n] = np.asarray(keep, bool)
        keep = torch.as_tensor(k, device=table.device)
    if kept is None:
        kept = int(keep.sum())
    cap = _pow2(kept)
    rows = _filter_gather(table.rows, keep, cap)
    # compaction is order-preserving: the sort-order tag carries across
    return Table(cols=table.cols, rows=rows, count=kept,
                 truncated=table.truncated, sort_order=table.sort_order)
