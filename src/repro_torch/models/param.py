"""Parameter definitions: trees of PD (shape + logical axis names).

Models declare their parameters as nested dicts of PD.  From one
declaration come the initial tensors (`init_params`) and the parameter
count.  The logical axis names are the reference's (vocab, embed, heads,
kv, ff, expert, layers, ...); on one card nothing is sharded, so they are
kept for the reader and for the multi-card slice, and read by nothing
here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class PD:
    shape: tuple
    axes: tuple                  # logical axis name (or None) per dim
    init: str = "normal"         # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_params(defs, generator: torch.Generator,
                dtype=torch.float32, device="cpu"):
    """Tensors for a PD tree: normal x scale, zeros or ones, drawn from
    `generator` (which lives on `device`) leaf by leaf in the tree's
    order.  The numbers are not the reference's (JAX draws its own)."""
    def make(pd: PD):
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=device)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=device)
        return torch.randn(pd.shape, generator=generator, dtype=dtype,
                           device=device) * pd.scale
    return tree_map(make, defs)


def count_params(defs) -> int:
    total = 0
    for _, pd in tree_leaves(defs, lambda x: isinstance(x, PD)):
        n = 1
        for s in pd.shape:
            n *= s
        total += n
    return int(total)
