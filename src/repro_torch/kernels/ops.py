"""Kernel dispatch with the reference's names (``repro.kernels.ops``).

The device of the input decides:

  * a CUDA tensor always goes to the hand-written CUDA kernel;
  * a CPU tensor goes to the kernel's plain PyTorch version.

impl:
  'auto' | 'sorted' -> as above (the binary-search plain versions on CPU);
  'cuda'            -> the CUDA kernel; raises for a CPU tensor;
  'ref'             -> on CPU the O(A*B) / O(C*B*J) compare oracle, the
                       form the kernels are validated against.

No wrapper falls back: a CUDA tensor whose kernel does not build or
launch raises.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .interval_count import interval_count_cuda
from .merge_probe import merge_probe_cuda

IMPLS = ("auto", "cuda", "sorted", "ref")


def on_cuda(t: torch.Tensor, impl: str) -> bool:
    """True iff ``t`` goes to a CUDA kernel under ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if t.is_cuda:
        return True
    if impl == "cuda":
        raise RuntimeError("impl='cuda' needs CUDA tensors")
    return False


def _i32(t) -> torch.Tensor:
    return torch.as_tensor(t).to(torch.int32).contiguous()


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


def radix_probe(a_keys, win_keys, *, impl: str = "auto"):
    """Window probe of the radix hash join over the [A, Lmax] bucket
    windows: (lt, cnt)."""
    from .radix_join import window_probe_cuda
    a_keys, win_keys = _i32(a_keys), _i32(win_keys)
    if on_cuda(a_keys, impl):
        return window_probe_cuda(a_keys, win_keys)
    return _ref.window_probe_ref(a_keys, win_keys)


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


def distinct_mask(rows, *, impl: str = "auto"):
    """First-of-group mask over lexicographically sorted rows [N, K].

    Like the reference, there is no hand kernel for this memory-bound
    elementwise compare; ``impl`` is validated for API uniformity."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    return _ref.distinct_mask_sorted(_i32(rows))


def cuda_kernels() -> dict:
    """name -> CudaKernel of every kernel on the engine's path; each
    carries its ``launches`` count."""
    from .fused_join import EXPAND_KERNEL
    from .interval_count import KERNEL as INTERVAL_KERNEL
    from .merge_probe import KERNEL as MERGE_KERNEL
    from .radix_join import WINDOW_KERNEL
    return {"merge_probe": MERGE_KERNEL,
            "expand_segments": EXPAND_KERNEL,
            "window_probe": WINDOW_KERNEL,
            "interval_count": INTERVAL_KERNEL}
