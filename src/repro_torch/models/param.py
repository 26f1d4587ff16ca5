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


@dataclass(frozen=True)
class PD:
    shape: tuple
    axes: tuple                  # logical axis name (or None) per dim
    init: str = "normal"         # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_pd(fn, defs):
    """fn applied to every PD leaf of a nested dict, keeping its layout."""
    if isinstance(defs, PD):
        return fn(defs)
    return {k: tree_map_pd(fn, v) for k, v in defs.items()}


def tree_leaves(tree, is_leaf=lambda x: not isinstance(x, dict)):
    """(path, leaf) pairs of a nested dict, keys in sorted order (the
    order in which JAX flattens a dict)."""
    if is_leaf(tree):
        yield (), tree
        return
    for k in sorted(tree):
        for path, leaf in tree_leaves(tree[k], is_leaf):
            yield (k,) + path, leaf


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
    return tree_map_pd(make, defs)


def count_params(defs) -> int:
    total = 0
    for _, pd in tree_leaves(defs, lambda x: isinstance(x, PD)):
        n = 1
        for s in pd.shape:
            n *= s
        total += n
    return int(total)
