"""Plain PyTorch versions of every kernel in this package.

They define the semantics, run on the CPU (the wrappers in ``ops`` and the
kernel modules take them for CPU tensors), and are what ``chip_smoke.py``
holds each CUDA kernel against on the card.  All of them are integer
functions, so agreement is exact.  Twins of ``repro.kernels.ref`` and of
the window-probe oracle in ``repro.kernels.radix_join``.
"""
from __future__ import annotations

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


def window_probe_ref(a_keys: torch.Tensor, win_keys: torch.Tensor):
    """(lt, cnt): per-row count of window keys below the probe key and of
    keys equal to it."""
    a = a_keys[:, None]
    return ((win_keys < a).sum(dim=1, dtype=torch.int32),
            (win_keys == a).sum(dim=1, dtype=torch.int32))


def distinct_mask_sorted(rows: torch.Tensor) -> torch.Tensor:
    """mask[i] = True iff rows[i] differs from rows[i-1] (row 0 always).

    rows: [N, K] int32, lexicographically sorted: marks the first row of
    every duplicate group."""
    neq = (rows[1:] != rows[:-1]).any(dim=1)
    head = torch.ones(min(rows.shape[0], 1), dtype=torch.bool,
                      device=rows.device)
    return torch.cat([head, neq])
