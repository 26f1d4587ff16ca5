"""Per-device cost of one traced step, read from the ops that run on each
device's shards: the counterpart of the reference's
launch/hlo_analysis.py, which parses post-SPMD optimized HLO.

There is no HLO in eager PyTorch.  `OpCounter` is a TorchDispatchMode
entered around one step that runs on DTensors.  A mode sees a DTensor op
before DTensor does; the counter hands it on (NotImplemented), so that
DTensor lowers it to the local op on this rank's shards and the
collectives that redistribution needs, and those reach the counter.
Every number is therefore PER DEVICE, as the reference's are.  (A mode
that counted the DTensor op itself would count the global product, and
the local op runs with the mode off.)  DTensor's sharding propagation
runs ops of global shape under a fake mode of its own; they are not
counted: the dry-run's shards are meta tensors, and an op that runs
under an active fake mode is propagation.

It sums:
  * flops: the products' (mm, bmm, addmm, ... and their out_dtype forms),
    by torch.utils.flop_counter's formulas;
  * hbm_bytes: operand + output bytes of every op that moves data (views,
    allocations and metadata ops excluded) — each eager op is one kernel
    that reads its operands from and writes its result to device memory;
  * hbm_bytes_min: the products' and collectives' bytes only (the
    reference's perfect-elementwise-fusion bound);
  * collectives: count and operand bytes per kind (all-gather,
    all-reduce, reduce-scatter, all-to-all, collective-permute);
  * collectives_by_op: the same, per kind, split by what issued each
    collective: an explicit redistribution ("redistribute": Sharder.c, a
    gradient put in its parameter's placements; "redistribute.backward":
    the transpose of one) or DTensor's dispatch of an aten op whose
    inputs it had to redistribute (the op's name), with the pass it ran
    in (":fw", or ":bw" inside autograd's backward, a checkpoint's
    recompute included) and the innermost frame of the port that was
    running ("@ nn_ops.py:c"; a backward pass shows its caller);
  * peak_bytes: the largest sum of the storages that ops of the step
    allocated and that were alive at once (a storage dies when the last
    tensor on it does, including tensors autograd saved).

The reference also lists `while_loops` with their trip counts: eager code
has no loops to recover (every iteration runs and is counted), so there
is no counterpart.
"""
from __future__ import annotations

import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name fragments (c10d functional ops and DTensor's own) -> kind
_KINDS = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "collective-permute"),
          ("permute_tensor", "collective-permute"))

# aten ops that move no data: allocations, aliases, metadata
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "set_", "resize_"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if "c10d" not in ns and ns != "_dtensor":
        return None
    name = func.__name__
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


_REDISTRIBUTE = os.path.join("distributed", "tensor", "_redistribute.py")
_PORT = os.sep + "repro_torch" + os.sep


def _issuer(last_op: str | None) -> str:
    """What issued the collective now running (see the module
    docstring), read from the Python stack: DTensor's dispatch of an op
    leaves no frame that tells it from the op's caller, so a collective
    outside a redistribution is charged to the last DTensor op seen."""
    names, site = set(), None
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.endswith(_REDISTRIBUTE):
            names.add(f.f_code.co_name)
        elif site is None and _PORT in path:
            site = f"{os.path.basename(path)}:{f.f_code.co_name}"
        f = f.f_back
    what = ("redistribute.backward" if "backward" in names else
            "redistribute" if "forward" in names else last_op or "?")
    bw = torch._C._current_autograd_node() is not None
    return f"{what}:{'bw' if bw else 'fw'} @ {site or '?'}"


def _in_fake_mode() -> bool:
    from torch._guards import active_fake_mode
    return active_fake_mode() is not None


class OpCounter(TorchDispatchMode):
    """Counts the local ops of a step (see the module docstring).
    `exclude`: tensors that exist before the step (its arguments, as
    DTensors or plain tensors), whose storages are not allocations."""

    def __init__(self, exclude=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.hbm_bytes_min = 0.0
        self.collectives = {c: {"count": 0.0, "bytes": 0.0}
                            for c in COLLECTIVES}
        self.collectives_by_op = {c: {} for c in COLLECTIVES}
        self._last_op = None
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, tuple] = {}
        self._known = {self._key(t) for t in _local_tensors(exclude)}

    @staticmethod
    def _key(t) -> int:
        return t.untyped_storage()._cdata

    def _track(self, t):
        key = self._key(t)
        if key in self._known or key in self._live:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, lambda _r, k=key: self._free(k)),
                           n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key):
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self._last_op = str(func)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_fake_mode():             # DTensor's sharding propagation
            return out
        self.ops += 1
        pkt = func.overloadpacket
        kind = _collective_kind(func)
        if kind is not None:
            b = _nbytes(args)
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += b
            split = self.collectives_by_op[kind].setdefault(
                _issuer(self._last_op), {"count": 0.0, "bytes": 0.0})
            split["count"] += 1
            split["bytes"] += b
            moved = b + _nbytes(out)
            self.hbm_bytes += moved
            self.hbm_bytes_min += moved
        elif pkt in self._flops_of:
            # mm.dtype / bmm.dtype: the formula of mm / bmm on the operands
            fargs = args[:2] if func._overloadname == "dtype" else args
            self.flops += self._flops_of[pkt](*fargs, **kwargs, out_val=out)
            moved = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            self.hbm_bytes += moved
            self.hbm_bytes_min += moved
        elif not func.is_view and func.__name__.split(".")[0] \
                not in _NO_TRAFFIC and func.namespace == "aten":
            self.hbm_bytes += _nbytes(args) + _nbytes(kwargs) \
                + _nbytes(out)
        for t in _tensors(out):
            self._track(t)
        return out

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    def as_dict(self) -> dict:
        """The reference's keys (without while_loops), plus the op count
        and the intermediates' peak."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_min": self.hbm_bytes_min,
                "collective_bytes": self.collective_bytes,
                "collectives": self.collectives,
                "collectives_by_op": self.collectives_by_op, "ops": self.ops,
                "peak_intermediate_bytes": self.peak_bytes}


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor
    for t in _tensors(tree):
        yield t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree` (nested
    lists, tuples and dicts; DTensors count their local shard)."""
    seen, total = set(), 0
    for t in _local_tensors(tree):
        key = OpCounter._key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def analyze(step, *args) -> tuple:
    """Run step(*args) under an OpCounter: (its result, the counts as a
    dict with the reference's keys)."""
    with OpCounter(exclude=args) as c:
        out = step(*args)
    return out, c.as_dict()
