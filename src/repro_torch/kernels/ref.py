"""Plain PyTorch versions of every kernel in this package.

They define the semantics, run on the CPU (the wrappers in ``ops`` and the
kernel modules take them for CPU tensors), and are what ``chip_smoke.py``
holds each CUDA kernel against on the card.  All of them are integer
functions, so agreement is exact.  Twins of ``repro.kernels.ref`` and of
the window-probe oracle in ``repro.kernels.radix_join``.  Bit signatures
(the reference's uint32) are int32 tensors holding the same bits:
``torch.uint32`` supports few operators, and ``&`` and ``~`` on int32
give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

I32_MAX = (1 << 31) - 1


def interval_count_ref(ids: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor) -> torch.Tensor:
    """counts[c, j] = #{b : lo[j] <= ids[c, b] < hi[j]}.

    ids: [C, B] int32, padded with -1 (all real ids >= 0, all lo >= 0 so
    padding never counts).  lo, hi: [J] int32.  Returns [C, J] int32.
    Sequential over J, which keeps peak memory at C*B instead of C*B*J."""
    cols = [((ids >= lo[j]) & (ids < hi[j])).sum(dim=1, dtype=torch.int32)
            for j in range(lo.shape[0])]
    if not cols:
        return torch.zeros((ids.shape[0], 0), dtype=torch.int32,
                           device=ids.device)
    return torch.stack(cols, dim=1)


def interval_count_sorted(ids: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor) -> torch.Tensor:
    """Binary-search form of interval_count_ref: -1 pads map to INT32_MAX
    so each row sorts ascending, then two searchsorted per interval.
    Equal to interval_count_ref wherever hi >= lo."""
    c = ids.shape[0]
    j = lo.shape[0]
    rows = torch.where(ids < 0, torch.full_like(ids, I32_MAX), ids)
    rows = torch.sort(rows, dim=1).values
    bounds = torch.cat([lo, hi]).to(torch.int32)
    idx = torch.searchsorted(rows, bounds.expand(c, 2 * j).contiguous(),
                             out_int32=True)
    return idx[:, j:] - idx[:, :j]


def gather_rows(ids: torch.Tensor, cands: torch.Tensor,
                lens: torch.Tensor | None = None) -> torch.Tensor:
    """ids[cands]; with ``lens`` [N], the entries of row n past its first
    lens[n] read as -1 padding."""
    rows = ids[cands.long()]
    if lens is not None:
        n = lens[cands.long()].clamp(0, ids.shape[1])
        pos = torch.arange(ids.shape[1], device=ids.device)
        rows = rows.masked_fill(pos[None, :] >= n[:, None], -1)
    return rows


def interval_count_gather_ref(ids: torch.Tensor, cands: torch.Tensor,
                              lo: torch.Tensor, hi: torch.Tensor,
                              lens: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """interval_count_sorted over the gathered rows ids[cands] — the
    neighborhood check's gather + count step (``repro.core.signature.
    _gather_count``), which the interval_count kernel fuses.  With
    ``lens``, only the first lens[n] entries of row n count."""
    return interval_count_sorted(gather_rows(ids, cands, lens), lo, hi)


class CheckSegment(NamedTuple):
    """One (direction, distance) step of the neighborhood check of one
    query node: the NI entry at that signed distance and the direction's
    intervals.  Segments of one direction follow each other by distance,
    the first with ``first`` set."""
    ids: torch.Tensor               # [N, cap] int32 NI ids, -1 padded
    lens: torch.Tensor | None       # [N] int32 stored lengths, or None
    overflow: torch.Tensor          # [N] bool overflow bits
    lo: Sequence[int]               # [J] the direction's intervals
    hi: Sequence[int]               # [J]
    need: Sequence[int] | None      # [J] counts needed within this
                                    # distance; None: no check here
    first: bool                     # the direction's first distance


def interval_check_ref(segments: Sequence[CheckSegment], lo: int, hi: int,
                       chunk: int = 8192, *, out: torch.Tensor | None = None,
                       tally: torch.Tensor | None = None) -> torch.Tensor:
    """ok [hi - lo] bool: the neighborhood check's verdict for candidate
    nodes lo..hi-1 (``repro.core.signature.check_interval_candidates``).
    Per direction, the counts of each candidate's NI row in each interval
    (interval_count_gather_ref) sum over distance into cum, the overflow
    bits into over; a segment with need sets
    ``ok &= all_j(cum >= need) | over``.  Candidates go in chunks of
    ``chunk``, which bound the gathered [chunk, cap] block.

    out: a [N] bool pass mask row; the verdict goes to out[lo:hi], which
    is returned, and the rest of the row is not touched.  tally: two
    counters, to which the candidates that passed and those that passed
    with an overflowed row in any segment are added."""
    dev = segments[0].ids.device
    n = hi - lo
    ok = torch.ones(n, dtype=torch.bool, device=dev) if out is None \
        else out[lo:hi]
    ok.fill_(True)
    bounds = [(torch.as_tensor(s.lo, dtype=torch.int32, device=dev),
               torch.as_tensor(s.hi, dtype=torch.int32, device=dev),
               None if s.need is None
               else torch.as_tensor(s.need, dtype=torch.int64, device=dev))
              for s in segments]
    for start in range(0, n, chunk):
        cands = torch.arange(lo + start, lo + min(start + chunk, n),
                             dtype=torch.int32, device=dev)
        ok_c = ok[start: start + cands.shape[0]]
        for seg, (l, h, need) in zip(segments, bounds):
            if seg.first:
                cum = torch.zeros((cands.shape[0], l.shape[0]),
                                  dtype=torch.int64, device=dev)
                over = torch.zeros(cands.shape[0], dtype=torch.bool,
                                   device=dev)
            cum += interval_count_gather_ref(seg.ids, cands, l, h, seg.lens)
            over |= seg.overflow[cands.long()]
            if need is not None:
                ok_c &= (cum >= need).all(dim=1) | over
    if tally is not None:
        any_over = torch.zeros(n, dtype=torch.bool, device=dev)
        for s in segments:
            any_over |= s.overflow[lo:hi].bool()
        tally[0] += ok.sum().to(tally.dtype)
        tally[1] += (ok & any_over).sum().to(tally.dtype)
    return ok


def merge_probe_ref(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """Per a-key match range in sorted b: start[i] = #{j: b[j] < a[i]},
    cnt[i] = #{j: b[j] == a[i]}.  O(A*B) compare oracle."""
    lt = b_keys[None, :] < a_keys[:, None]
    eq = b_keys[None, :] == a_keys[:, None]
    return (lt.sum(dim=1, dtype=torch.int32),
            eq.sum(dim=1, dtype=torch.int32))


def merge_probe_sorted(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """Binary-search form of merge_probe_ref — O((A+B) log B)."""
    start = torch.searchsorted(b_keys, a_keys, out_int32=True)
    end = torch.searchsorted(b_keys, a_keys, right=True, out_int32=True)
    return start, end - start


def expand_segments_ref(csum: torch.Tensor, cap: int) -> torch.Tensor:
    """seg[t] = #{i : csum[i] <= t} for t in [0, cap) — the sorted a-row
    that owns output slot t of the join expand."""
    t = torch.arange(cap, dtype=torch.int32, device=csum.device)
    return torch.searchsorted(csum, t, right=True, out_int32=True)


def expand_gather_ref(a_rows: torch.Tensor, b_rows: torch.Tensor,
                      start: torch.Tensor, cnt: torch.Tensor, limit: int,
                      cap: int, new_sel=(), csum: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The join expand: [cap, ka + len(new_sel)] output rows.

    Output slot t belongs to a-row i = expand_segments_ref(csum)[t] and
    pairs it with b-row start[i] + (t - (csum[i] - cnt[i])), the b-row
    keeping the columns new_sel; slots at or past min(csum[-1], limit) are
    -1-filled.  csum = cumsum(cnt) unless given."""
    a_cap = a_rows.shape[0]
    if csum is None:
        csum = torch.cumsum(cnt, 0, dtype=torch.int32)
    t = torch.arange(cap, dtype=torch.int32, device=csum.device)
    seg = torch.searchsorted(csum, t, right=True, out_int32=True)
    invalid = ~((t < csum[-1]) & (t < limit))[:, None]
    i = torch.clamp(seg, max=a_cap - 1)
    base = csum[i] - cnt[i]
    # offset as t - base (subtraction form), as the reference writes it
    j = torch.clamp(start[i] + (t - base), 0, b_rows.shape[0] - 1)
    left = a_rows[i].masked_fill(invalid, -1)
    if new_sel:
        right = b_rows[j][:, list(new_sel)].masked_fill(invalid, -1)
        return torch.cat([left, right], dim=1)
    return left


def window_probe_ref(a_keys: torch.Tensor, win_keys: torch.Tensor):
    """(lt, cnt): per-row count of window keys below the probe key and of
    keys equal to it."""
    a = a_keys[:, None]
    return ((win_keys < a).sum(dim=1, dtype=torch.int32),
            (win_keys == a).sum(dim=1, dtype=torch.int32))


def bitmask_contains_ref(cand: torch.Tensor,
                         query: torch.Tensor) -> torch.Tensor:
    """ok[c] = 1 iff every bit set in query is set in cand[c].

    cand: [C, W] int32 bit patterns, query: [W].  Returns [C] int32."""
    miss = query[None, :] & ~cand
    return (~(miss != 0).any(dim=1)).to(torch.int32)


def intersect_any_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """hit[p] = 1 iff the valid (>= 0) entries of a[p] and b[p] intersect.

    a: [P, A], b: [P, B] int32, -1 padded, rows in any order.  Returns [P]
    int32.  O(P*A*B) compare oracle."""
    eq = a[:, :, None] == b[:, None, :]
    valid = (a[:, :, None] >= 0) & (b[:, None, :] >= 0)
    return (eq & valid).any(dim=2).any(dim=1).to(torch.int32)


def intersect_any_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Membership form of intersect_any_ref: sort each a-row with -1
    mapped to INT32_MAX, then binary-search every b entry in its row —
    O(P*B log A) time and O(P*B) memory."""
    p, w = a.shape
    if w == 0 or b.shape[1] == 0:
        return torch.zeros(p, dtype=torch.int32, device=a.device)
    a_s = torch.sort(torch.where(a < 0, torch.full_like(a, I32_MAX), a),
                     dim=1).values
    idx = torch.searchsorted(a_s, b.contiguous()).clamp_(max=w - 1)
    hit = (a_s.gather(1, idx) == b) & (b >= 0)
    return hit.any(dim=1).to(torch.int32)


def intersect_any_ragged_ref(a_ids: torch.Tensor, a_off: torch.Tensor,
                             b_ids: torch.Tensor,
                             b_off: torch.Tensor) -> torch.Tensor:
    """hit[p] = 1 iff a_ids[a_off[p]:a_off[p+1]] and
    b_ids[b_off[p]:b_off[p+1]] share an id.

    Ragged rows: ids [N] int32 (no padding, any order, duplicates
    allowed), offsets [P + 1], ascending from 0 to N.  Returns [P] int32.
    Exact, with no [P, A, B] compare cube: each id becomes the int64 key
    pair << 32 | id on its side, the b-keys found among the a-keys
    (``torch.isin``) mark their pairs."""
    p = a_off.shape[0] - 1
    keys = []
    for ids, off in ((a_ids, a_off), (b_ids, b_off)):
        off = off.long()
        lens = off[1:] - off[:-1]
        if p < 0 or off.shape != (p + 1,) or int(off[0]) != 0 \
                or int(off[-1]) != ids.shape[0] or bool((lens < 0).any()):
            raise ValueError("expected offsets [P + 1] ascending from 0 to "
                             "the number of ids")
        pair = torch.repeat_interleave(
            torch.arange(p, device=ids.device), lens)
        keys.append((pair << 32) | (ids.long() & 0xFFFFFFFF))
    found = torch.isin(keys[1], keys[0])
    hit = torch.zeros(p, dtype=torch.int32, device=a_ids.device)
    hit[keys[1][found] >> 32] = 1
    return hit


def distinct_mask_sorted(rows: torch.Tensor) -> torch.Tensor:
    """mask[i] = True iff rows[i] differs from rows[i-1] (row 0 always).

    rows: [N, K] int32, lexicographically sorted: marks the first row of
    every duplicate group."""
    neq = (rows[1:] != rows[:-1]).any(dim=1)
    head = torch.ones(min(rows.shape[0], 1), dtype=torch.bool,
                      device=rows.device)
    return torch.cat([head, neq])
