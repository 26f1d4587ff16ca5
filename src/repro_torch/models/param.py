"""Parameter definitions: trees of PD (shape + logical axis names).

Models declare their parameters as nested dicts of PD.  From one
declaration come the initial tensors (`init_params`), the shape and dtype
records of the dry-run (`abstract_params`: meta tensors, no memory), the
parameter count and the partition specs (`param_pspecs`: logical axis ->
mesh axis through a rules table, with a divisibility fallback).

Logical axes (the reference's):
  vocab   token embedding rows          -> 'model'
  embed   d_model                        -> None (or dp axes under ZeRO-3)
  heads   flattened q-head dim (H*hd)    -> 'model' when H % tp == 0
  kv      flattened kv-head dim          -> 'model' when KV % tp == 0
  ff      feed-forward hidden            -> 'model'
  expert  MoE expert count               -> 'model'
  layers  stacked leading dim            -> None
  batch / cache_seq (decode caches)      -> dp axes / 'model'

A spec (`PS`) holds one entry per tensor dim: a mesh axis name, a tuple
of names or None, as jax.sharding.PartitionSpec does.  `placements` turns
it into DTensor placements on a DeviceMesh: the one place where the two
designs meet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

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


def tree_map_pd(fn, defs):
    """fn over the PD leaves of a definition tree."""
    if isinstance(defs, PD):
        return fn(defs)
    return {k: tree_map_pd(fn, v) for k, v in defs.items()}


def abstract_params(defs, dtype=torch.float32):
    """Shape and dtype records of a PD tree: tensors on the meta device,
    which hold no memory."""
    return tree_map_pd(
        lambda pd: torch.empty(pd.shape, dtype=dtype, device="meta"), defs)


class PS(tuple):
    """A partition spec: one entry per tensor dim, a mesh axis name, a
    tuple of names (the dim split over several mesh axes, major to minor)
    or None (the counterpart of jax.sharding.PartitionSpec)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PS{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> dict:
    """{mesh axis name: size} of a DeviceMesh (or anything with
    `mesh_dim_names` and `shape`)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements(spec, mesh) -> list:
    """DTensor placements of a spec on `mesh`: a mesh dim named by a
    tensor dim gets Shard(dim), also where a tuple names several mesh
    dims for one tensor dim (their order in the tuple must be the mesh's,
    major to minor, which is the order in which DTensor splits a dim over
    several mesh dims); every other mesh dim gets Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, part in enumerate(spec):
        flat = part if isinstance(part, tuple) else (part,) if part else ()
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {flat} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


@dataclass
class Rules:
    """logical axis -> mesh axis (name or tuple).  Divisibility-checked."""
    table: dict
    mesh_sizes: dict             # mesh axis name -> size

    def _size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self.mesh_sizes[a]
            return n
        return self.mesh_sizes[axis]

    def resolve(self, logical, dim) -> Any:
        axis = self.table.get(logical)
        if axis is None:
            return None
        if dim % self._size(axis) != 0:
            return None
        return axis

    def spec(self, pd: PD) -> PS:
        used = set()
        parts = []
        for dim, logical in zip(pd.shape, pd.axes):
            a = self.resolve(logical, dim)
            # a mesh axis may appear only once per spec
            flat = a if isinstance(a, tuple) else (a,) if a else ()
            if any(f in used for f in flat):
                a = None
            used.update(flat)
            parts.append(a)
        return PS(*parts)


def param_pspecs(defs, rules: Rules):
    return tree_map_pd(rules.spec, defs)


def make_rules(mesh, *, tp_heads: bool, tp_kv: bool,
               zero3: bool = False) -> Rules:
    sizes = mesh_sizes(mesh)
    dp = tuple(a for a in sizes if a != "model")
    dp = dp if len(dp) > 1 else dp[0] if dp else None
    table = {
        "vocab": "model",
        "ff": "model",
        "expert": "model",
        "heads": "model" if tp_heads else None,
        "kv": "model" if tp_kv else None,
        "embed": dp if zero3 else None,
        "layers": None,
        # decode caches / states
        "batch": dp,
        "cache_seq": "model",
    }
    return Rules(table=table, mesh_sizes=sizes)


def count_params(defs) -> int:
    total = 0
    for _, pd in tree_leaves(defs, lambda x: isinstance(x, PD)):
        n = 1
        for s in pd.shape:
            n *= s
        total += n
    return int(total)
