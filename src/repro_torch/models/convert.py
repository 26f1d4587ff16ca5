"""Carry parameters and decode caches between the reference's trees and the
port's.

The reference's trees arrive as nested dicts of numpy arrays (for a JAX
tree, `jax.tree.map(np.asarray, tree)`).  Leaves are matched by their path
in the tree (`("blocks", "attn", "wq")`), never by flattened position, and
every path and shape is checked against the port's definitions.  bf16
arrays (numpy dtype name "bfloat16") travel as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import resolve_device
from ..tree import tree_from_leaves, tree_leaves
from .param import PD
from . import transformer as tf


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy, never a view: decode writes its caches in place."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:      # numpy has no bf16: widen, exactly
        t = t.float()
    return t.numpy()


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def params_from_reference(cfg, tree, device="cuda"):
    """The port's parameter tree from the reference's (numpy leaves), on
    `device` (the card unless "cpu" is asked for)."""
    dev = resolve_device(device)
    defs = list(tree_leaves(tf.model_defs(cfg), lambda x: isinstance(x, PD)))
    want, got = {p for p, _ in defs}, {p for p, _ in tree_leaves(tree)}
    if want != got:
        raise KeyError(f"parameter paths differ: missing "
                       f"{sorted(want - got)}, unexpected {sorted(got - want)}")
    out = []
    for path, pd in defs:
        a = np.asarray(_get(tree, path))
        if tuple(a.shape) != tuple(pd.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, "
                             f"expected {pd.shape}")
        out.append((path, _to_tensor(a, dev)))
    return tree_from_leaves(out)


def cache_to_numpy(cache):
    """A decode cache as a nested dict of numpy arrays (bf16 widened to
    fp32), laid out as the reference's: copies, which later decode steps
    (writing the attention caches in place) leave as they are."""
    return tree_from_leaves((path, _to_numpy(t))
                            for path, t in tree_leaves(cache))


def cache_from_numpy(tree, device="cuda"):
    """A decode cache from the reference's (numpy leaves) on `device`."""
    dev = resolve_device(device)
    return tree_from_leaves((path, _to_tensor(a, dev))
                            for path, a in tree_leaves(tree))
