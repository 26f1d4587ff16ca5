"""The traced run's probe: torch.profiler over the window, and read-only
taps on the program's kernel entries.

Each ``bench/roofline/<kernel>.py`` names the entry it taps (``MODULE``,
``ATTR``), the device kernels that entry launches (``KERNELS``, parts of
their names) and ``cost(*args, **kwargs)``: the bytes and operations the
call's work needs, or a callable that gives them once the window has
closed.  The tap records the cost and calls the entry unchanged.
"""
from __future__ import annotations

import importlib
import importlib.util
import time
from pathlib import Path

from .peaks import PEAKS


def load_roofline(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"bench_roofline_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def union_seconds(spans) -> tuple[float, list]:
    """Length of the union of (start, end) spans, sorted by start, and
    the gaps between its pieces as (gap, index of the span that ended the
    piece before it, index of the span after it)."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    last = None
    for k, (s, e) in enumerate(spans):
        if cur_e is not None and s <= cur_e:
            if e > cur_e:
                cur_e, last = e, k
            continue
        if cur_e is not None:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, last, k))
        cur_s, cur_e, last = s, e, k
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list and namespaces."""
    head = name.split("(")[0]
    if head.startswith("void "):
        head = head[5:]
    head = head.split("::")[-1] if "<" not in head else head
    return head[:width]


class Probe:
    def __init__(self, roofline_dir: Path, device: str):
        self.device = device
        self.kernels = {}
        for path in sorted(roofline_dir.glob("*.py")):
            mod = load_roofline(path)
            self.kernels[path.stem] = mod
        self.calls = {k: [] for k in self.kernels}
        self._undo = []
        self.events = []          # (name, start_s, end_s) of device ops
        self.busy_s = self.window_s = 0.0

    # -- taps ----------------------------------------------------------- #
    def _tap(self, name, mod):
        target = importlib.import_module(mod.MODULE)
        inner = getattr(target, mod.ATTR)
        calls = self.calls[name]

        def tapped(*args, **kwargs):
            calls.append(mod.cost(*args, **kwargs))
            return inner(*args, **kwargs)

        setattr(target, mod.ATTR, tapped)
        self._undo.append((target, mod.ATTR, inner))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        for name, mod in self.kernels.items():
            self._tap(name, mod)
        acts = [ProfilerActivity.CUDA if self.device == "cuda"
                else ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        for target, attr, inner in reversed(self._undo):
            setattr(target, attr, inner)
        for name, calls in self.calls.items():
            self.calls[name] = [c() if callable(c) else c for c in calls]
        self.events = sorted(self._device_events(), key=lambda x: x[1:])
        self.busy_s, self._gaps = union_seconds(
            [(s, e) for _, s, e in self.events])

    def _device_events(self) -> list:
        from torch.autograd import DeviceType
        want = DeviceType.CUDA if self.device == "cuda" else DeviceType.CPU
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != want:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((e.name(), s, s + d))
        return out

    # -- readings ------------------------------------------------------- #
    def device_seconds(self, parts) -> float:
        """Device seconds of the ops whose name holds one of ``parts``."""
        return sum(e - s for n, s, e in self.events
                   if any(p in n for p in parts))

    def roofline(self, name: str) -> float | None:
        """Percent of the least time the chip needs for the tapped calls'
        work (bytes at the memory peak or operations at the compute peak,
        whichever is longer) against their kernels' device time; None
        where nothing ran."""
        mod = self.kernels[name]
        dev = self.device_seconds(mod.KERNELS)
        calls = self.calls[name]
        if not calls or dev <= 0:
            return None
        bound = sum(max(b / PEAKS["bytes_per_s"], o / PEAKS["ops_per_s"])
                    for b, o in calls)
        return 100.0 * bound / dev

    def breakdown(self) -> dict:
        by_name: dict = {}
        for n, s, e in self.events:
            k = short(n)
            by_name[k] = by_name.get(k, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self._gaps, key=lambda g: -g[0])[:10]
        ev = self.events
        idle = [[f"after {short(ev[a][0], 48)}, before "
                 f"{short(ev[b][0], 48)}", gap] for gap, a, b in gaps]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}
