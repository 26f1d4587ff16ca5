"""Radix-partitioned hash join — the priced alternative to sort-merge.

Twin of ``repro.kernels.radix_join``.  Only the build (B) side is
partitioned into pow2 buckets by a multiplicative hash of the key; every
probe (A) row is then compared against its bucket's window, so A is never
sorted and the output keeps A's row order.

  radix_partition   stable-sort B by key, then by bucket id, so every
                    bucket span is key-sorted; bucket edges and the
                    widest real bucket
  radix_window      gather each A row's bucket window into [A, Lmax]
                    (B_INVALID past the bucket end)
  window_probe      per row, the count of window keys below the probe key
                    (the match run's offset) and equal to it (its length)
                    — the CUDA kernel ``csrc/window_probe.cu``, which
                    replaces ``repro.kernels.radix_join.window_probe_pallas``
  radix_scatter     gather of the matches into output slots ordered by A
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr
from .fused_join import B_INVALID

# Knuth multiplicative hash: the bucket id is the top `bits` of the low
# 32 bits of key * KNUTH (a uint32 product in the reference).
_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF

WINDOW_KERNEL = CudaKernel("window_probe", "window_probe",
                           [PTR, PTR, INT, INT, INT, PTR, PTR])


def _bucket_of(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """uint32 (key * KNUTH) >> (32 - bits), computed in int64 in two
    16-bit halves of the constant so no product leaves int64; keys
    >= B_INVALID (the sentinels) go to the reserved overflow bucket nb."""
    k = keys.long() & _MASK32
    lo = k * (_KNUTH & 0xFFFF)
    hi = (k * (_KNUTH >> 16)) & 0xFFFF
    h = ((lo + (hi << 16)) & _MASK32) >> (32 - bits)
    return torch.where(keys >= B_INVALID, 1 << bits, h).to(torch.int32)


def radix_partition(b_keys, b_rows, bits: int):
    """Partition the build side: (keys_p, rows_p, edges [nb+1], maxlen).
    edges[k]:edges[k+1] is bucket k's span; maxlen (a device scalar)
    counts real buckets only."""
    nb = 1 << bits
    ord1 = torch.argsort(b_keys, stable=True)
    k1 = b_keys[ord1]
    bk1 = _bucket_of(k1, bits)
    ord2 = torch.argsort(bk1, stable=True)
    keys_p = k1[ord2]
    rows_p = b_rows[ord1[ord2]]
    bk_p = bk1[ord2]
    edges = torch.searchsorted(
        bk_p, torch.arange(nb + 1, dtype=torch.int32, device=bk_p.device),
        out_int32=True)
    maxlen = (edges[1:] - edges[:-1]).max()
    return keys_p, rows_p, edges, maxlen


def radix_window(a_keys, edges, keys_p, bits: int, lmax: int):
    """Per-probe-row bucket windows: (win_keys [A, lmax], win_start [A])."""
    nb = 1 << bits
    abk = _bucket_of(a_keys, bits)
    s = edges[torch.clamp(abk, max=nb)]
    # invalid probe rows get an empty window (e == s)
    e = torch.where(abk >= nb, s, edges[torch.clamp(abk + 1, max=nb)])
    off = torch.arange(lmax, dtype=torch.int32, device=a_keys.device)
    pos = s[:, None] + off[None, :]
    outside = pos >= e[:, None]
    pos_c = torch.clamp(pos, 0, keys_p.shape[0] - 1)
    return keys_p[pos_c].masked_fill(outside, B_INVALID), s


def window_probe_cuda(a_keys: torch.Tensor, win_keys: torch.Tensor):
    """(lt [A], cnt [A]) int32 over contiguous int32 CUDA windows."""
    check_cuda_int32(a_keys, win_keys)
    n, lmax = win_keys.shape
    if a_keys.shape[0] != n:
        raise ValueError("a_keys and win_keys disagree on the row count")
    group = min(32, 1 << max(lmax - 1, 0).bit_length())
    if n * group >= 1 << 31:
        raise ValueError("window probe too large for one launch")
    lt = torch.empty(n, dtype=torch.int32, device=a_keys.device)
    cnt = torch.empty(n, dtype=torch.int32, device=a_keys.device)
    if n:
        WINDOW_KERNEL.launch(ptr(a_keys), ptr(win_keys), n, lmax, group,
                             ptr(lt), ptr(cnt))
    return lt, cnt


def radix_scatter(a_rows, b_rows_p, lt, cnt, win_start, limit: int, *,
                  cap, new_sel, has_new):
    """Assemble matches into `cap` output slots ordered by probe row.

    Each output slot t pulls its match by index arithmetic: probe row i
    by searchsorted over the cumulative counts, match ordinal
    k = t - base[i] (subtraction form), build row
    win_start[i] + lt[i] + k.  Slots at or past min(limit, total) are
    -1-filled."""
    csum = torch.cumsum(cnt, 0, dtype=torch.int32)
    base = csum - cnt                                # exclusive, by A row
    t = torch.arange(cap, dtype=torch.int32, device=csum.device)
    i = torch.clamp(torch.searchsorted(csum, t, right=True, out_int32=True),
                    max=cnt.shape[0] - 1)
    k = t - base[i]
    invalid = ~(t < torch.clamp(csum[-1], max=limit))[:, None]
    left = a_rows[i].masked_fill(invalid, -1)
    if has_new:
        bj = torch.clamp(win_start[i] + lt[i] + k, 0, b_rows_p.shape[0] - 1)
        right = b_rows_p[bj][:, list(new_sel)].masked_fill(invalid, -1)
        return torch.cat([left, right], dim=1)
    return left
