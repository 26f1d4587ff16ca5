"""Hand-written CUDA kernels for Hopper (sm_90a) of the engine's hot spots.

Each kernel replaces one Pallas TPU kernel of ``repro.kernels`` and has a
plain PyTorch version in ``ref.py``; ``ops.py`` dispatches by device (the
CUDA kernel for CUDA tensors, the plain version for CPU tensors).
"""
from . import ops, ref
from .ops import (distinct_mask, expand_segments, interval_count,
                  merge_probe, radix_probe)
