"""Hand-written CUDA kernels for Hopper (sm_90a) of the engine's hot spots.

Each kernel replaces one Pallas TPU kernel of ``repro.kernels`` and has a
plain PyTorch version in ``ref.py``; ``ops.py`` dispatches by device (the
CUDA kernel for CUDA tensors, the plain version for CPU tensors).
"""
from . import ops, ref
from ._build import KernelError
from .ops import (bitmask_contains, distinct_mask, expand_gather,
                  expand_segments, interval_check, interval_count,
                  intersect_any, intersect_any_ragged, merge_probe,
                  radix_probe)
