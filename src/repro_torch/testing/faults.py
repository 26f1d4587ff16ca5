"""Deterministic fault injection for chaos-testing the serving stack.

The harness monkeypatches a small set of *injection points* — the
load-bearing seams of the execution pipeline — with wrappers that count
calls and fire configured faults at exact call indices, so a chaos test
can say "the 3rd merge-probe dispatch of this run raises" and get the
same failure every time.

Injection points (name -> patched attributes):

  kernel_dispatch   repro_torch.kernels.ops.merge_probe — every staged
                    sort-merge join's probe kernel dispatch (the fused
                    chain probes through fused_join._probe and bypasses
                    this seam; chaos configs that target it run with
                    EngineConfig.fuse_joins=False).
  join_expand       repro_torch.core.matching._merge_expand — the
                    segment-offset match expansion of staged sort-merge
                    joins and of uncapped fused joins (the capped fused
                    chain and the radix join expand without it; same
                    fuse_joins caveat).
  fused_probe       repro_torch.kernels.fused_join.sort_probe_expand /
                    sort_probe (one shared counter) — every fused-chain
                    join dispatch.
  radix_probe       repro_torch.kernels.ops.radix_probe — the bucket-window
                    probe of every radix hash join.
  reach_gather      repro_torch.core.connectivity.reach_pairs — the reach-set
                    pair-table gather of the reach-join path.
  cache_lookup      ReachCache.get_set / get_array (one shared counter)
                    — every reach-cache probe.

Fault kinds:

  raise             raise InjectedFault (an unexpected hard failure).
  corrupt_capacity  raise matching.CapacityOverflow(needed=1) — a lying
                    capacity estimate, exercising the overflow retry /
                    degraded-retry paths.  Deliberately NOT a silent
                    output corruption: the serving stack's contract is
                    "exact or typed error", so injected faults must be
                    *detectable* — capacity lies are the realistic
                    detectable corruption in this engine (every table is
                    capacity-padded and overflow-checked).
  delay             sleep `delay_s` then proceed normally — exercises
                    deadline budgets without changing results.

Trigger matrix (1-based per-point call index; exactly one of the three
modes is active per Fault — `first` wins over `every` wins over `at`):

  trigger     fires on calls        models
  ---------   -------------------   ----------------------------------
  at=k        k exactly (once)      an isolated one-shot blip
  every=n     n, 2n, 3n, ...        a persistent / periodic fault
  first=k     1..k, then clears     a transient fault that heals — the
                                    retry-classification case: call
                                    k+1 onward succeeds, so ONE retry
                                    recovers iff k == 1

`FaultInjector` is a context manager; the original attributes are
always restored on exit.
"""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass


class InjectedFault(RuntimeError):
    """The error raised by kind='raise' injections."""

    def __init__(self, point: str, call_index: int):
        self.point = point
        self.call_index = call_index
        super().__init__(f"injected fault at {point} (call {call_index})")


# point name -> tuple of (module path, attribute path) targets; multiple
# targets share the point's single call counter
INJECTION_POINTS: dict[str, tuple[tuple[str, str], ...]] = {
    "kernel_dispatch": (("repro_torch.kernels.ops", "merge_probe"),),
    "join_expand": (("repro_torch.core.matching", "_merge_expand"),),
    "fused_probe": (("repro_torch.kernels.fused_join", "sort_probe_expand"),
                    ("repro_torch.kernels.fused_join", "sort_probe")),
    "radix_probe": (("repro_torch.kernels.ops", "radix_probe"),),
    "reach_gather": (("repro_torch.core.connectivity", "reach_pairs"),),
    "cache_lookup": (("repro_torch.core.connectivity", "ReachCache.get_set"),
                     ("repro_torch.core.connectivity",
                      "ReachCache.get_array")),
}

FAULT_KINDS = ("raise", "corrupt_capacity", "delay")


@dataclass(frozen=True)
class Fault:
    """One fault to inject: fire `kind` at injection point `point` on the
    `at`-th call (1-based), on every `every`-th call, or on the first
    `first` calls then clear (a healing transient) — see the trigger
    matrix in the module docstring."""
    point: str
    kind: str
    at: int = 1
    every: int | None = None
    first: int | None = None
    delay_s: float = 0.05

    def __post_init__(self):
        if self.point not in INJECTION_POINTS:
            raise ValueError(f"unknown injection point {self.point!r}; "
                             f"known: {sorted(INJECTION_POINTS)}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")

    def triggers(self, call_index: int) -> bool:
        if self.first is not None:
            return call_index <= self.first
        if self.every is not None:
            return call_index % self.every == 0
        return call_index == self.at


def _resolve(target: tuple[str, str]):
    """(owner object, attribute name, current value) for a target like
    ('repro_torch.core.connectivity', 'ReachCache.get_set')."""
    mod = importlib.import_module(target[0])
    owner = mod
    parts = target[1].split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1], getattr(owner, parts[-1])


class FaultInjector:
    """Context manager installing the configured faults.

    `calls` maps point name -> calls observed; `fired` lists
    (point, kind, call_index) for every fault that actually triggered —
    chaos tests assert on it to prove the fault was exercised."""

    def __init__(self, *faults: Fault):
        self.faults = faults
        self._by_point: dict[str, list[Fault]] = {}
        for f in faults:
            self._by_point.setdefault(f.point, []).append(f)
        self.calls: dict[str, int] = {}
        self.fired: list[tuple[str, str, int]] = []
        self._saved: list[tuple[object, str, object]] = []

    # ---------------------------------------------------------------- #
    def _make_wrapper(self, point: str, original):
        def wrapper(*args, **kwargs):
            self.calls[point] += 1
            idx = self.calls[point]
            for f in self._by_point[point]:
                if not f.triggers(idx):
                    continue
                self.fired.append((point, f.kind, idx))
                if f.kind == "raise":
                    raise InjectedFault(point, idx)
                if f.kind == "corrupt_capacity":
                    from repro_torch.core.matching import CapacityOverflow
                    raise CapacityOverflow(1)
                time.sleep(f.delay_s)
            return original(*args, **kwargs)
        return wrapper

    def __enter__(self) -> "FaultInjector":
        for point in self._by_point:
            self.calls[point] = 0
            for target in INJECTION_POINTS[point]:
                owner, name, original = _resolve(target)
                self._saved.append((owner, name, original))
                setattr(owner, name, self._make_wrapper(point, original))
        return self

    def __exit__(self, *exc) -> None:
        while self._saved:
            owner, name, original = self._saved.pop()
            setattr(owner, name, original)
