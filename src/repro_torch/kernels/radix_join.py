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
  span probe        per row, the count of window keys below the probe key
                    (the match run's offset) and equal to it (its length),
                    and the window's start — the CUDA kernel
                    ``csrc/window_probe.cu`` reads each bucket span of
                    keys_p in place, so the window is never built; it
                    replaces ``repro.kernels.radix_join.window_probe_pallas``
                    with the radix_window before it.  Its plain version,
                    ``radix_probe_ref``, is radix_window + window_probe_ref
  radix_scatter     gather of the matches into output slots ordered by A,
                    through the join expand of every strategy
                    (``ops.expand_gather``)
"""
from __future__ import annotations

import torch

from . import ops
from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr
from .fused_join import B_INVALID
from .ref import window_probe_ref

# Knuth multiplicative hash: the bucket id is the top `bits` of the low
# 32 bits of key * KNUTH (a uint32 product in the reference).
_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF

WINDOW_KERNEL = CudaKernel("window_probe", "window_probe",
                           [PTR, INT, PTR, INT, PTR, INT, INT, PTR, PTR,
                            PTR])


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
    if keys_p.shape[0] == 0:                # an empty build side: all fill
        keys_p = torch.full((1,), B_INVALID, dtype=keys_p.dtype,
                            device=keys_p.device)
    pos_c = torch.clamp(pos, 0, keys_p.shape[0] - 1)
    return keys_p[pos_c].masked_fill(outside, B_INVALID), s


def radix_probe_ref(a_keys, keys_p, edges, bits: int, lmax: int):
    """(lt, cnt, win_start): the window probe over radix_window's
    windows — the plain version of the span kernel."""
    win, win_start = radix_window(a_keys, edges, keys_p, bits, lmax)
    lt, cnt = window_probe_ref(a_keys, win)
    return lt, cnt, win_start


def span_probe_cuda(a_keys: torch.Tensor, keys_p: torch.Tensor,
                    edges: torch.Tensor, bits: int, lmax: int):
    """(lt, cnt, win_start) [A] int32 from contiguous int32 CUDA tensors:
    probe keys, the partitioned build keys and the nb + 1 bucket edges of
    ``radix_partition``."""
    check_cuda_int32(a_keys, keys_p, edges)
    if not 1 <= bits <= 30 or edges.shape != ((1 << bits) + 1,):
        raise ValueError(f"expected 1 <= bits <= 30 and edges [2^bits + 1], "
                         f"got bits={bits}, edges {tuple(edges.shape)}")
    if lmax < 0:
        raise ValueError(f"lmax must be >= 0, got {lmax}")
    n = a_keys.shape[0]
    lt, cnt, win_start = torch.empty((3, n), dtype=torch.int32,
                                     device=a_keys.device)
    if n:
        WINDOW_KERNEL.launch(ptr(a_keys), n, ptr(keys_p), keys_p.shape[0],
                             ptr(edges), bits, lmax, ptr(lt), ptr(cnt),
                             ptr(win_start))
    return lt, cnt, win_start


def radix_scatter(a_rows, b_rows_p, lt, cnt, win_start, limit: int, *,
                  cap, new_sel, has_new):
    """Assemble matches into `cap` output slots ordered by probe row.

    Each output slot t pulls its match by index arithmetic: probe row i
    owns it by the cumulative counts, match ordinal k = t - base[i], build
    row win_start[i] + lt[i] + k — the join expand ``ops.expand_gather``
    with start = win_start + lt.  Slots at or past min(limit, total) are
    -1-filled."""
    return ops.expand_gather(a_rows, b_rows_p, win_start + lt, cnt, limit,
                             cap, new_sel if has_new else ())
