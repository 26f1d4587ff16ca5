"""Fused sort-merge join chain: pack -> sort -> probe -> expand, with one
host sync (the match total) per join.

Twin of ``repro.kernels.fused_join``.  The entry points:

  sort_probe_expand   the full chain at a known output capacity.  The
                      sorted sides and match ranges come back as
                      byproducts, so on CapacityOverflow the caller
                      re-runs ONLY the expand.
  sort_probe          pack+sort+probe when the capacity is not known up
                      front; the caller syncs the total and expands.
  pack_keys           the dense-rank key packing alone, for the staged
                      path: single-column keys are the column itself,
                      multi-column keys come from ONE lexsort over both
                      sides.
  lexsort_distinct    projection + lexsort + first-of-group mask + count,
                      for matching.dedup_project.

Multi-column joins sort once: the stable lexsort over the concatenated
sides gives the dense-rank keys AND both sides' sorted orders.

PyTorch has no lexsort, so ``_lexsort`` chains stable argsorts from the
last key to the first; every argsort here is stable, as ``jnp.argsort``
is, because row order is part of the contract (sort-order tags).  The
probe runs on the merge_probe kernel and the expand on the expand_gather
entry of the expand_segments kernel (``csrc/expand_segments.cu``, which
replaces ``repro.kernels.fused_join.expand_segments_pallas`` and the row
gather after it; the staged and radix joins expand through it too) for
CUDA tensors, on their plain versions for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import ops
from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr
from .ref import distinct_mask_sorted

# Join-key space (shared with core.matching): real packed keys live in
# [0, 2^31 - 3]; the top two int32 values are invalid-row sentinels,
# distinct per side so an invalid a-row never matches an invalid b-row.
A_INVALID = (1 << 31) - 1
B_INVALID = (1 << 31) - 2

# both entries of csrc/expand_segments.cu count as launches of one kernel
EXPAND_KERNEL = CudaKernel(
    "expand_segments", "expand_segments", [PTR, INT, INT, PTR],
    entries={"expand_gather": [PTR, INT, INT, PTR, INT, INT, PTR, PTR, INT,
                               INT, PTR, INT, PTR]})
MAX_NEW_COLS = 256          # MAX_SEL of csrc/expand_segments.cu
_I32_MAX = (1 << 31) - 1


def expand_segments_cuda(csum: torch.Tensor, cap: int) -> torch.Tensor:
    """seg [cap] int32 for a nondecreasing contiguous int32 CUDA csum."""
    check_cuda_int32(csum)
    seg = torch.empty(cap, dtype=torch.int32, device=csum.device)
    if cap:
        EXPAND_KERNEL.launch(ptr(csum), csum.shape[0], cap, ptr(seg))
    return seg


def expand_gather_cuda(a_rows: torch.Tensor, b_rows: torch.Tensor,
                       start: torch.Tensor, csum: torch.Tensor, limit: int,
                       cap: int, new_sel) -> torch.Tensor:
    """The whole join expand in one launch: [cap, ka + len(new_sel)] int32
    from contiguous int32 CUDA tensors a_rows [n, ka], b_rows [nb, kb],
    start [n] and the running counts csum [n]."""
    check_cuda_int32(a_rows, b_rows, start, csum)
    (n, ka), (nb, kb) = a_rows.shape, b_rows.shape
    new_sel = [int(c) for c in new_sel]
    if start.shape != (n,) or csum.shape != (n,):
        raise ValueError(f"expected start and csum [{n}], got "
                         f"{tuple(start.shape)} and {tuple(csum.shape)}")
    if len(new_sel) > MAX_NEW_COLS or any(not 0 <= c < kb for c in new_sel):
        raise ValueError(f"expected at most {MAX_NEW_COLS} columns of "
                         f"b_rows [*, {kb}], got {new_sel}")
    out = torch.empty((cap, ka + len(new_sel)), dtype=torch.int32,
                      device=a_rows.device)
    if cap:
        sel = (ctypes.c_int * max(len(new_sel), 1))(*new_sel)
        EXPAND_KERNEL.launch(
            ptr(a_rows), n, ka, ptr(b_rows), nb, kb, ptr(start), ptr(csum),
            max(0, min(int(limit), _I32_MAX)), cap, ctypes.cast(sel, PTR),
            len(new_sel), ptr(out), symbol="expand_gather")
    return out


def compact_indices(mask: torch.Tensor, size: int,
                    fill: int) -> torch.Tensor:
    """Positions of the True entries of a 1-D mask, in order, padded with
    ``fill`` (or cut) to ``size`` — ``jnp.nonzero(mask, size=, fill_value=)``
    as an int32 cumsum and a scatter, with no host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    # rows that are False or past `size` land in the spare slot `size`
    tgt = torch.where(mask & (pos < size), pos, size).long()
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int32,
                                      device=mask.device))
    return out[:size]


def _lexsort(cols) -> torch.Tensor:
    """Stable lexicographic order of the column tuple, cols[0] primary."""
    order = torch.argsort(cols[-1], stable=True)
    for c in reversed(cols[:-1]):
        order = order[torch.argsort(c[order], stable=True)]
    return order


# ------------------------- fused dense-rank pack ----------------------- #
def _side_cols(rows, sel, valid, sentinel):
    return tuple(rows[:, s].masked_fill(~valid, sentinel) for s in sel)


def _ranks_sorted(sorted_cols):
    """Dense ranks of lexicographically sorted column tuples: rank
    increments exactly at rows that differ from their predecessor."""
    n = sorted_cols[0].shape[0]
    boundary = torch.zeros(n - 1, dtype=torch.bool,
                           device=sorted_cols[0].device)
    for c in sorted_cols:
        boundary |= c[1:] != c[:-1]
    new = torch.cat([torch.ones(1, dtype=torch.int32, device=boundary.device),
                     boundary.to(torch.int32)])
    return torch.cumsum(new, 0, dtype=torch.int32) - 1


def _concat_cols(a_rows, b_rows, a_sel, b_sel, a_valid, b_valid):
    return tuple(torch.cat([va, vb]) for va, vb in zip(
        _side_cols(a_rows, a_sel, a_valid, A_INVALID),
        _side_cols(b_rows, b_sel, b_valid, B_INVALID)))


def pack_keys(a_rows, b_rows, a_sel, b_sel):
    """Pack the shared join columns of both tables into one int32 key per
    row (original row order).  Single shared column: the node id IS the
    key.  Multiple columns: ONE lexsort over the concatenated sides
    assigns dense ranks to the full column tuple (order- and
    equality-preserving)."""
    n_a = a_rows.shape[0]
    a_valid = a_rows[:, 0] >= 0
    b_valid = b_rows[:, 0] >= 0
    if len(a_sel) == 1:
        return (a_rows[:, a_sel[0]].masked_fill(~a_valid, A_INVALID),
                b_rows[:, b_sel[0]].masked_fill(~b_valid, B_INVALID))
    cols = _concat_cols(a_rows, b_rows, a_sel, b_sel, a_valid, b_valid)
    order = _lexsort(cols)
    ranks = _ranks_sorted(tuple(c[order] for c in cols))
    key = torch.zeros_like(ranks).scatter_(0, order, ranks)
    return (key[:n_a].masked_fill(~a_valid, A_INVALID),
            key[n_a:].masked_fill(~b_valid, B_INVALID))


# --------------------------- fused side sort --------------------------- #
def _sort_sides(a_rows, b_rows, a_sel, b_sel):
    """(a_keys_s, a_rows_s, b_keys_s, b_rows_s), both sides sorted by the
    packed key.  Multiple columns: the pack lexsort is reused as the sort
    — the stable combined order, filtered by side, is each side's
    sorted order."""
    n_a, n_b = a_rows.shape[0], b_rows.shape[0]
    a_valid = a_rows[:, 0] >= 0
    b_valid = b_rows[:, 0] >= 0
    if len(a_sel) == 1:
        a_keys = a_rows[:, a_sel[0]].masked_fill(~a_valid, A_INVALID)
        b_keys = b_rows[:, b_sel[0]].masked_fill(~b_valid, B_INVALID)
        ao = torch.argsort(a_keys, stable=True)
        bo = torch.argsort(b_keys, stable=True)
        return a_keys[ao], a_rows[ao], b_keys[bo], b_rows[bo]
    cols = _concat_cols(a_rows, b_rows, a_sel, b_sel, a_valid, b_valid)
    order = _lexsort(cols)
    key_sorted = _ranks_sorted(tuple(c[order] for c in cols))
    from_a = order < n_a
    ia = compact_indices(from_a, n_a, 0)       # exactly n_a entries
    ib = compact_indices(~from_a, n_b, 0)
    return (key_sorted[ia], a_rows[order[ia]],
            key_sorted[ib], b_rows[order[ib] - n_a])


def _expand(a_rows_s, b_rows_s, start, cnt, limit: int, cap: int,
            new_sel, has_new):
    """Segment-offset expansion of (start, cnt) match ranges, returning
    the match total as a device scalar byproduct."""
    csum = torch.cumsum(cnt, 0, dtype=torch.int32)
    rows = ops.expand_gather(a_rows_s, b_rows_s, start, cnt, limit, cap,
                             new_sel if has_new else (), csum=csum)
    return rows, csum[a_rows_s.shape[0] - 1]


# --------------------------- fused entry points ------------------------ #
def sort_probe_expand(a_rows, b_rows, limit: int, *, a_sel, b_sel, cap,
                      new_sel, has_new, probe):
    """The full fused join chain at a known output capacity.

    Returns (rows, total, a_keys_s, a_rows_s, b_keys_s, b_rows_s, start,
    cnt).  Caller contract: |A|*|B| < 2^31 so the total fits int32."""
    a_keys_s, a_rows_s, b_keys_s, b_rows_s = _sort_sides(
        a_rows, b_rows, a_sel, b_sel)
    start, cnt = ops.merge_probe(a_keys_s, b_keys_s, impl=probe)
    rows, total = _expand(a_rows_s, b_rows_s, start, cnt, limit, cap,
                          new_sel, has_new)
    return rows, total, a_keys_s, a_rows_s, b_keys_s, b_rows_s, start, cnt


def sort_probe(a_rows, b_rows, *, a_sel, b_sel, probe):
    """Fused pack+sort+probe for joins with no capacity hint: the caller
    syncs the int32 total, sizes the output, and expands separately."""
    a_keys_s, a_rows_s, b_keys_s, b_rows_s = _sort_sides(
        a_rows, b_rows, a_sel, b_sel)
    start, cnt = ops.merge_probe(a_keys_s, b_keys_s, impl=probe)
    total = cnt.sum(dtype=torch.int32)
    return a_keys_s, a_rows_s, b_keys_s, b_rows_s, start, cnt, total


# ------------------------ fused sort-distinct -------------------------- #
def lexsort_distinct(rows, sel):
    """Projection + lexsort + first-of-group mask + count for
    dedup_project: (sorted projection, keep mask, kept count).  Invalid
    rows map every projected value to the a-side sentinel, so they sort
    last and are masked out."""
    valid = rows[:, 0] >= 0
    cols = _side_cols(rows, sel, valid, A_INVALID)
    order = _lexsort(cols)
    proj = torch.stack(cols, dim=1)[order]
    keep = distinct_mask_sorted(proj) & (proj[:, 0] != A_INVALID)
    return proj, keep, keep.sum(dtype=torch.int32)
