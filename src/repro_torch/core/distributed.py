"""Distributed neighborhood check of RDF-h over ``torch.distributed``.

Graph partitioning: node rows of each NI entry are range-partitioned over
the ranks of a process group; every rank evaluates the neighborhood check
for its own node range (embarrassingly parallel — the paper's phases only
synchronize at join boundaries, where candidate tables are orders of
magnitude smaller than the graph: pruning is what makes the all-gather
cheap).

The group's ranks play the role of the reference's ``data`` mesh axis;
nothing here replicates the index across a second axis.  Both functions
take host arrays, run on ``device`` (the card unless the caller asks for
the CPU) and return host numpy arrays.  With a process group of size 1
the collectives still run; with no process group initialised at all the
functions run as a world of one and call no collective.  NCCL needs CUDA
tensors, gloo takes CPU ones: pass the ``device`` the group's backend
reads.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops


def pad_rows(arr: np.ndarray, ndev: int, fill) -> np.ndarray:
    """arr with rows of ``fill`` appended up to a multiple of ``ndev``."""
    n = arr.shape[0]
    npad = (-n) % ndev
    if npad == 0:
        return arr
    pad_shape = (npad,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], 0)


def _world(group) -> tuple[int, int]:
    """(world size, rank) of ``group``; (1, 0) when no process group is
    initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def _device(device) -> torch.device:
    return ops.resolve_device("cuda" if device is None else device)


def _block(arr: np.ndarray, rank: int, block: int, fill) -> np.ndarray:
    """Rows rank*block .. (rank+1)*block of ``pad_rows(arr, world, fill)``,
    without padding (or copying) the whole array."""
    part = arr[rank * block:(rank + 1) * block]
    if part.shape[0] == block:
        return np.ascontiguousarray(part)
    pad = np.full((block - part.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([part, pad], 0)


def _all_gather(local: torch.Tensor, world: int, group) -> torch.Tensor:
    """Every rank's ``local`` concatenated in rank order."""
    if not (dist.is_available() and dist.is_initialized()):
        return local
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)


def shard_check(ids: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                need: np.ndarray, overflow: np.ndarray, *, group=None,
                device=None) -> np.ndarray:
    """Distributed single-distance neighborhood check.

    ids [N, cap] per-node neighbor ids (each row ascending, -1 padded at
    the tail: an NI entry), split by node row over the ranks of
    ``group``.  lo/hi/need [J]: required intervals (hi >= lo) and counts,
    the same on every rank.  overflow [N]: auto-pass bits.  Each rank
    counts its rows with ``ops.interval_count`` on ``device`` (the
    ``interval_count`` kernel on the card) and the pass masks are
    all-gathered; with no process group initialised it is a world of
    one.  Returns the pass mask [N] on every rank."""
    world, rank = _world(group)
    dev = _device(device)
    n = ids.shape[0]
    block = -(-n // world)
    ids = np.asarray(ids, np.int32)
    ids_blk = torch.from_numpy(_block(ids, rank, block, -1)).to(dev)
    of_blk = torch.from_numpy(
        _block(np.asarray(overflow, np.bool_), rank, block, True)).to(dev)
    lo_t, hi_t, need_t = (torch.as_tensor(np.asarray(x, np.int32),
                                          device=dev) for x in (lo, hi, need))
    cnt = ops.interval_count(ids_blk, lo_t, hi_t)
    ok = (cnt >= need_t[None, :]).all(dim=1) | of_blk
    # uint8 on the wire: not every backend reduces bool tensors
    mask = _all_gather(ok.to(torch.uint8), world, group)
    return mask.cpu().numpy().astype(np.bool_)[:n]


def gather_candidates(mask: np.ndarray, cap: int, *, group=None,
                      device=None) -> np.ndarray:
    """All-gather the (compact) candidate ids from every shard.

    The join-boundary collective: each rank keeps the first ``cap`` ids of
    its block of ``mask`` (any further ones are dropped, as the
    reference's fixed-size ``nonzero`` drops them), offsets them by its
    block's start and all-gathers ``cap`` slots per rank — bytes are
    O(pruned candidates), not O(N); with no process group initialised it
    is a world of one.  Returns the valid ids, int32, in rank order."""
    world, rank = _world(group)
    dev = _device(device)
    mask_p = pad_rows(np.asarray(mask, np.bool_), world, False)
    block = mask_p.shape[0] // world
    m_blk = torch.from_numpy(
        mask_p[rank * block:(rank + 1) * block].copy()).to(dev)
    ids = torch.nonzero(m_blk).flatten()[:cap].to(torch.int32)
    local = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    local[:ids.numel()] = ids + rank * block
    out = _all_gather(local, world, group).cpu().numpy()
    return out[out >= 0]
