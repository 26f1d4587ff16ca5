"""Kernel dispatch with the reference's names (``repro.kernels.ops``).

The device of the input decides:

  * a CUDA tensor always goes to the hand-written CUDA kernel;
  * a CPU tensor goes to the kernel's plain PyTorch version.

impl:
  'auto' | 'sorted' -> as above (the binary-search plain versions on CPU);
  'cuda'            -> the CUDA kernel; raises for a CPU tensor;
  'ref'             -> on CPU the O(A*B) / O(C*B*J) / O(P*A*B) compare
                       oracle, the form the kernels are validated against.

No wrapper falls back: a CUDA tensor whose kernel does not build or
launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref as _ref
from ._build import KernelError, upload
from .ref import CheckSegment
from .bitmask_contains import bitmask_contains_cuda
from .interval_count import (check_words, interval_check_cuda,
                             interval_count_cuda)
from .merge_probe import merge_probe_cuda
from .sorted_intersect import intersect_any_cuda, intersect_any_ragged_cuda

IMPLS = ("auto", "cuda", "sorted", "ref")


def on_cuda(t: torch.Tensor, impl: str) -> bool:
    """True iff ``t`` goes to a CUDA kernel under ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if t.is_cuda:
        return True
    if impl == "cuda":
        raise KernelError("impl='cuda' needs CUDA tensors")
    return False


def resolve_device(device) -> torch.device:
    """The device a caller asked for; "cuda" without CUDA raises (no
    silent CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def _i32(t) -> torch.Tensor:
    return torch.as_tensor(t).to(torch.int32).contiguous()


def bits32(x) -> torch.Tensor:
    """32-bit words as an int32 tensor with the same bits: a uint32 numpy
    array is reinterpreted, not converted."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = np.ascontiguousarray(x).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    return x.to(torch.int32)


def merge_probe(a_keys, b_keys, *, impl: str = "auto"):
    """Match ranges of sorted a_keys in sorted b_keys: (start, cnt)."""
    a_keys, b_keys = _i32(a_keys), _i32(b_keys)
    if on_cuda(a_keys, impl):
        return merge_probe_cuda(a_keys, b_keys)
    if impl == "ref":
        return _ref.merge_probe_ref(a_keys, b_keys)
    return _ref.merge_probe_sorted(a_keys, b_keys)


def expand_segments(csum, cap: int, *, impl: str = "auto"):
    """seg[t] = #{i : csum[i] <= t} for t in [0, cap)."""
    from .fused_join import expand_segments_cuda
    csum = _i32(csum)
    if on_cuda(csum, impl):
        return expand_segments_cuda(csum, cap)
    return _ref.expand_segments_ref(csum, cap)


def expand_gather(a_rows, b_rows, start, cnt, limit: int, cap: int,
                  new_sel=(), *, csum=None, impl: str = "auto"):
    """The join expand of every join strategy: [cap, ka + len(new_sel)]
    rows, slot t < min(total, limit) pairing the a-row that owns it with
    its b-row (columns new_sel), the rest -1 (``ref.expand_gather_ref``).
    ``csum`` is cumsum(cnt) when the caller has it; the total is read from
    it on the device.  On CUDA one launch writes the whole output."""
    from .fused_join import expand_gather_cuda
    a_rows, b_rows = _i32(a_rows), _i32(b_rows)
    start, cnt = _i32(start), _i32(cnt)
    csum = (torch.cumsum(cnt, 0, dtype=torch.int32) if csum is None
            else _i32(csum))
    if on_cuda(a_rows, impl):
        return expand_gather_cuda(a_rows, b_rows, start, csum, limit, cap,
                                  new_sel)
    return _ref.expand_gather_ref(a_rows, b_rows, start, cnt, limit, cap,
                                  new_sel, csum=csum)


def radix_probe(a_keys, keys_p, edges, *, bits: int, lmax: int,
                impl: str = "auto"):
    """Probe of the radix hash join over the bucket spans of
    ``radix_partition`` (keys_p, edges), each capped at lmax keys:
    (lt, cnt, win_start).  On CUDA the kernel reads each span in place;
    the plain version builds the [A, lmax] windows (radix_window) and
    probes them (ref.window_probe_ref)."""
    from .radix_join import radix_probe_ref, span_probe_cuda
    a_keys, keys_p, edges = _i32(a_keys), _i32(keys_p), _i32(edges)
    if on_cuda(a_keys, impl):
        return span_probe_cuda(a_keys, keys_p, edges, bits, lmax)
    return radix_probe_ref(a_keys, keys_p, edges, bits, lmax)


def interval_count(ids, lo, hi, *, cands=None, lens=None,
                   impl: str = "auto"):
    """counts[c, j] = #{b : lo[j] <= rows[c, b] < hi[j]} over rows =
    ids[cands] (or ids itself when cands is None).  Rows are ascending
    with -1 padding at the tail; ``lens`` [N], when given, is each row's
    stored length, and entries past it do not count (the CUDA kernel then
    searches only that prefix).  On CUDA the gather is fused into the
    kernel."""
    ids, lo, hi = _i32(ids), _i32(lo), _i32(hi)
    cands = (torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
             if cands is None else _i32(cands))
    lens = None if lens is None else _i32(lens)
    if on_cuda(ids, impl):
        return interval_count_cuda(ids, cands, lo, hi, lens)
    if impl == "ref":
        return _ref.interval_count_ref(_ref.gather_rows(ids, cands, lens),
                                       lo, hi)
    return _ref.interval_count_gather_ref(ids, cands, lo, hi, lens)


def interval_check(segments, lo: int, hi: int, *, impl: str = "auto",
                   chunk: int = 8192, out=None, tally=None, data=None,
                   data_at: int = 0) -> torch.Tensor:
    """ok [hi - lo] bool: the neighborhood check of one query node over
    candidates lo..hi-1 and its ``ref.CheckSegment`` list (each
    direction's distances in order, the first marked ``first``, one
    interval count J per direction).  On CUDA one launch covers every
    candidate and segment; on the CPU the plain version runs in chunks of
    ``chunk`` candidates.  With ``out`` (a [N] bool pass mask row) the
    verdict is written to out[lo:hi] and returned; with ``tally`` (two
    int32 counters) the passes and the passes with an overflowed row in
    any segment are added to it, on the device.  ``data``, ``data_at``:
    the segments' ``check_words`` already on the device, from word
    data_at on (CUDA only)."""
    segments = list(segments)
    if not segments or not segments[0].first:
        raise ValueError("expected segments, the first marked first")
    for prev, seg in zip(segments, segments[1:]):
        if not seg.first and len(seg.lo) != len(prev.lo):
            raise ValueError("one direction's segments differ in J")
    if any(len(s.lo) != len(s.hi) or (s.need is not None
                                      and len(s.need) != len(s.lo))
           for s in segments):
        raise ValueError("expected lo, hi and need of one length")
    if any(len(s.lo) == 0 for s in segments):
        # the kernel reads a segment's overflow bits in its first round
        raise ValueError("expected at least one interval a segment")
    if on_cuda(segments[0].ids, impl):
        return interval_check_cuda(segments, lo, hi, out=out, tally=tally,
                                   data=data, data_at=data_at)
    return _ref.interval_check_ref(segments, lo, hi, chunk, out=out,
                                   tally=tally)


def bitmask_contains(cand, query, *, impl: str = "auto"):
    """ok[c] = 1 iff every bit of query [W] is set in cand[c] [C, W].
    Words are int32 bit patterns (uint32 arrays are reinterpreted); on
    CUDA, cand may be a row slice of a larger signature table."""
    cand, query = bits32(cand), bits32(query).contiguous()
    if on_cuda(cand, impl):
        return bitmask_contains_cuda(cand, query)
    return _ref.bitmask_contains_ref(cand, query)


def intersect_any(a, b, *, impl: str = "auto"):
    """hit[p] = 1 iff the valid (>= 0) entries of a[p] and b[p] intersect
    (rows -1 padded, in any order)."""
    a, b = _i32(a), _i32(b)
    if on_cuda(a, impl):
        return intersect_any_cuda(a, b)
    if impl == "ref":
        return _ref.intersect_any_ref(a, b)
    return _ref.intersect_any_sorted(a, b)


def intersect_any_ragged(a_ids, a_off, b_ids, b_off, *, impl: str = "auto"):
    """hit[p] = 1 iff a_ids[a_off[p]:a_off[p+1]] and
    b_ids[b_off[p]:b_off[p+1]] share an id: ragged rows of valid ids
    (any order, duplicates allowed), offsets [P + 1].  On CUDA one launch
    reads only the ids, each pair's longer row up to its first hit."""
    a_ids, a_off, b_ids, b_off = map(_i32, (a_ids, a_off, b_ids, b_off))
    if on_cuda(a_ids, impl):
        return intersect_any_ragged_cuda(a_ids, a_off, b_ids, b_off)
    return _ref.intersect_any_ragged_ref(a_ids, a_off, b_ids, b_off)


def edge_select(src, dst, pred, pred_id: int, spec_src, spec_dst, *,
                self_loop: bool = False, impl: str = "auto"):
    """``row_select.Selection`` of the edges (src, dst) with pred ==
    pred_id (any when -1) whose endpoints pass their specs (a [N] bool
    mask or a (lo, hi) interval); with ``self_loop`` also src == dst, and
    the rows hold src alone.  On CUDA one count launch, and one
    compaction launch when the rows are written."""
    from .row_select import edge_select_cuda, edge_select_ref
    src, dst, pred = _i32(src), _i32(dst), _i32(pred)
    if on_cuda(src, impl):
        return edge_select_cuda(src, dst, pred, pred_id, spec_src, spec_dst,
                                self_loop)
    return edge_select_ref(src, dst, pred, pred_id, spec_src, spec_dst,
                           self_loop)


def distinct_select(rows, pairs, *, impl: str = "auto"):
    """``row_select.Selection`` of the rows [n, k] with a valid column 0
    whose column pairs (i, j) in ``pairs`` hold different values: the
    injective filter.  On CUDA two launches, as ``edge_select``."""
    from .row_select import distinct_select_cuda, distinct_select_ref
    rows = _i32(rows)
    if on_cuda(rows, impl):
        return distinct_select_cuda(rows, pairs)
    return distinct_select_ref(rows, pairs)


def masked_select(rows, keep, *, impl: str = "auto"):
    """``row_select.Selection`` of the rows r of [n, k] with keep[r], for a
    bool mask of at most n entries (rows past it are not kept).  On CUDA
    two launches, as ``edge_select``."""
    from .row_select import masked_select_cuda, masked_select_ref
    rows = _i32(rows)
    if on_cuda(rows, impl):
        return masked_select_cuda(rows, keep)
    return masked_select_ref(rows, keep)


def distinct_mask(rows, *, impl: str = "auto"):
    """First-of-group mask over lexicographically sorted rows [N, K].

    Like the reference, there is no hand kernel for this memory-bound
    elementwise compare; ``impl`` is validated for API uniformity."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    return _ref.distinct_mask_sorted(_i32(rows))


def cuda_kernels() -> dict:
    """name -> CudaKernel of every kernel of the package; each carries its
    ``launches`` count.  Each kernel belongs to a path: the first four and
    row_select to the engine's main path (joins and the neighborhood
    check; expand_segments counts the launches of its expand_gather entry,
    the expand of every join; row_select those of its count and
    compaction entries, the edge scan of every D-tree edge, the injective
    filter, filter_rows and dedup_project),
    bitmask_contains to the bloom prefilter (``EngineConfig.use_bloom``)
    and intersect_any to ``connectivity_mask_vectorized`` (which launches
    its intersect_any_ragged entry)."""
    from .bitmask_contains import KERNEL as BITMASK_KERNEL
    from .fused_join import EXPAND_KERNEL
    from .interval_count import KERNEL as INTERVAL_KERNEL
    from .merge_probe import KERNEL as MERGE_KERNEL
    from .radix_join import WINDOW_KERNEL
    from .row_select import KERNEL as ROW_SELECT_KERNEL
    from .sorted_intersect import KERNEL as INTERSECT_KERNEL
    return {"merge_probe": MERGE_KERNEL,
            "expand_segments": EXPAND_KERNEL,
            "window_probe": WINDOW_KERNEL,
            "interval_count": INTERVAL_KERNEL,
            "bitmask_contains": BITMASK_KERNEL,
            "intersect_any": INTERSECT_KERNEL,
            "row_select": ROW_SELECT_KERNEL}
