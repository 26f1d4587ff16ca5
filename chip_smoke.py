"""Smoke run of the PyTorch/CUDA port (repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: lubm_like(scale=13)

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without its final line:

  device    the card's name and power limit (nvidia-smi)
  build     nvcc of every kernel source under src/repro_torch/kernels/csrc
  dataset   the main path's Dataset, built on the host
  kernels   each CUDA kernel against its plain PyTorch version on the card,
            at the shapes the main path gives it; exact equality, device
            time per call (torch.profiler) beside the plain version, the
            library call and the least time the card could take
            (bound_ms), and the wrapper's time per call between CUDA
            events, host launch gaps included (call_ms).  A row's times
            come from one timer, named in its `timer`.  The merge_probe
            rows time both kernels of merge_probe.cu, forced: the merge
            path and the bisection kernel that small probes run
            (yardstick_path_ms, yardstick_bisect_ms).  The row
            interval_count_node_check is the neighborhood check of one
            query node in one launch over 65,536 candidates, timed beside
            the chunked launch pattern (one count launch per chunk,
            direction and distance) as host time per node.  The row
            expand_gather is the join expand in one launch, timed beside
            the slot-map path (expand_segments + the PyTorch gather) and the
            library composition (torch.searchsorted + the gather);
            merge_probe and expand_gather are also timed with L2 flushed
            between calls (ms_l2_flushed).  intersect_any has a row for
            each entry: the padded rows of reach_sets, and
            intersect_any_ragged on the ragged rows of the conn path's
            gather at P = 1,024 and at P = 65,536, the second also timed
            with L2 flushed
  main      12 RDF-h queries (the last 4 with a connection edge) through
            Dataset.engine("rdf_h") -> Engine.execute on the card, cold
            then warm; each of the four kernels of this path must have
            launched during this phase, the check must launch
            interval_count at most once per call cold and never warm,
            every join expand must be exactly one expand_segments
            launch, and results must equal the same engine's on the CPU;
            prints the shapes of every sort-merge probe, join expand and
            radix join.  Then merge_probe and expand_gather run again as
            kernel rows on the real inputs of the commonest probe and
            expand shape (merge_probe_main_shape,
            expand_gather_main_shape), and merge_probe_shapes times the
            merge path, the bisection kernel and the searchsorted pair in
            turn in one trace at every probe shape, in 5 rounds
  serve     the main phase's 12 templates through the serving tier
            (repro_torch.serve.QueryServer) on the same Dataset, each
            future held to the main engine's result (a truncated result,
            cut at max_rows in the plan's row order, to the main engine's
            run of the template's canonical form, which a server plans):
            a server cold then warm (the warm round must hit the plan
            cache 12 times and launch no interval_count; the phase must
            launch every MAIN_KERNELS kernel), its snapshot restored into
            a fresh server (no interval_count launch), a server with the
            result cache whose repeat round launches nothing, and three
            faults of repro_torch.testing.faults that heal by the first
            retry (corrupt_capacity and raise at fused_probe, raise at
            reach_gather), each exact and undegraded, then a failing
            expand_segments launch that must fail its query with the
            KernelError, unretried and undegraded; prints the server's
            latency percentiles and qps from its metrics registry, its
            cache gauges, the phase's peak memory and one EXPLAIN
  bloom     6 queries with exact keywords through SPath(NI2) with the
            bloom prefilter (EngineConfig(check_policy="always",
            use_bloom=True)), cold then warm: bitmask_contains must have
            launched, and the result sets must equal those of the card's
            spath_ni2 engine without the prefilter
  conn      8,192 endpoint pairs of the main phase's connection edges
            (half from their result rows, half random) through
            connectivity_mask_vectorized on the card, directed and
            bidirectional: intersect_any's ragged entry must have launched
            exactly once per chunk of 1,024 pairs (the padded entry never),
            and the masks must equal the host's per-pair
            connectivity_mask; prints the seconds split into the host's
            reach gathering, the upload, the kernel with its copy back and
            the _exact_reach fallbacks, and the pairs the fallback decided
  parity    lubm_like and dblp_like at scale 0.3: the card's result sets
            equal the CPU engine's, exactly, for rdf_h and for the bloom
            configuration

The last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit rate
# outside the tensor cores, used for the integer compares of these kernels
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

A_INVALID = (1 << 31) - 1
B_INVALID = (1 << 31) - 2

# where the engines run; a CPU rehearsal of the phases sets "cpu"
DEVICE = "cuda"

# timing rounds of each probe shape of the main path
REPEATS = 5

# the kernels each path must launch
MAIN_KERNELS = ("merge_probe", "expand_segments", "window_probe",
                "interval_count")
BLOOM_KERNELS = ("bitmask_contains",)
CONN_KERNELS = ("intersect_any",)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time per call between CUDA events: the card's time plus any
    gap the host leaves between back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_times(prof) -> dict:
    """Device time (ms) by kernel or copy name from a torch.profiler run."""
    from torch.autograd import DeviceType
    dev = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:      # kernels and copies only
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            dev[e.key] = dev.get(e.key, 0.0) + us / 1e3
    return dev


def profiled_ms(step, iters: int, kernel: str | None = None):
    """Device time (ms) of `iters` calls of step under torch.profiler, of
    every kernel and copy or of those whose name holds `kernel`; None
    when three traces in a row hold no such time (the profiler missed
    the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
        ms = sum(v for k, v in device_times(prof).items()
                 if kernel is None or kernel in k)
        if ms > 0:
            return ms
    emit({"phase": "profiler_missed", "timing": kernel or "all kernels"})
    return None


def time_group(fns: dict, iters: int = 20, warmup: int = 3):
    """Time per call (ms) of each callable of fns, as ({name: ms}, timer).
    The timer is "profiler": device time under torch.profiler, the
    kernels and copies each call puts on the card without the host's
    launch gaps.  Where the profiler traces nothing for one of them,
    every one of them is timed between CUDA events instead ("cuda_events",
    host launch gaps included): times that are compared with each other
    always come from one timer."""
    import torch
    ms = {}
    for name, fn in fns.items():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t = profiled_ms(fn, iters)
        if t is None:
            return ({k: cuda_ms(f, iters, warmup) for k, f in fns.items()},
                    "cuda_events")
        ms[name] = t / iters
    return ms, "profiler"


def interleaved_ms(fns: dict, kernels: dict, iters: int = 20,
                   warmup: int = 3):
    """Device time per call (ms) of each callable of fns, all run in turn
    in one torch.profiler trace, so that each sees the same clocks and
    the order they are timed in cannot favour one; the trace's device
    time is split by kernel name (kernels: key -> a substring of its
    kernel's name, or None for the time of no other key).  None where
    the profiler traces no time for one of them three times in a row."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for fn in fns.values():
                    fn()
            torch.cuda.synchronize()
        dev = device_times(prof)
        ms = {k: sum(v for name, v in dev.items() if sub in name)
              for k, sub in kernels.items() if sub is not None}
        ms.update({k: sum(dev.values()) - sum(ms.values())
                   for k, sub in kernels.items() if sub is None})
        if all(v > 0 for v in ms.values()):
            return {k: v / iters for k, v in ms.items()}
    emit({"phase": "profiler_missed", "timing": sorted(kernels)})
    return None


def device_ms_l2_flushed(fn, kernel: str, iters: int = 20,
                         warmup: int = 3):
    """Device time per call of the kernel whose name holds `kernel`, with
    the 50 MB L2 flushed before every call by a 64 MB write and a read of
    it, so that the call finds neither its inputs nor dirty lines to
    write back in L2 (the flush's own kernels are not counted).  None
    (not measured) where the profiler traces nothing."""
    import torch
    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")

    def flushed():
        flush.fill_(1)
        flush.max()
        fn()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = profiled_ms(flushed, iters, kernel)
    del flush
    return None if ms is None else ms / iters


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_launches() -> None:
    from repro_torch.kernels import ops
    for k in ops.cuda_kernels().values():
        k.reset()


def launch_counts() -> dict:
    from repro_torch.kernels import ops
    return {name: k.launches for name, k in ops.cuda_kernels().items()}


def read_launches(path: str, required) -> dict:
    """Launch counts of every kernel since reset_launches(); fails when a
    kernel of `path` was launched no time."""
    from repro_torch.kernels import ops
    launches = {name: k.launches for name, k in ops.cuda_kernels().items()}
    missing = [name for name in required if launches[name] == 0]
    if missing:
        fail(f"the {path} path launched no {missing} kernel")
    return launches


def compare(name, got, want) -> dict:
    import torch
    mism, err = 0, 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}: kernel gives {g.shape} {g.dtype}, "
                 f"plain {w.shape} {w.dtype}")
        d = (g.long() - w.long()).abs()
        mism += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    if mism:
        fail(f"{name}: {mism} elements differ from the plain version")
    return {"mismatches": mism, "max_abs_err": err}


def record_row(out, name, src, replaces, fn, plain, lib, nbytes, nops, got,
               want, counter=None, cold_kernel=None, yardsticks=None):
    """One kernel row: the kernel against its plain version (exact
    equality), times of both, of the library call and of the yardsticks
    ({row key: callable}), all from one timer (`timer`), and the bound.
    counter: the launch counter of the kernel, where the row is an entry
    point of another kernel's source or another shape; cold_kernel: the
    CUDA kernel's name, to time it again with L2 flushed between calls."""
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{src}",
           "replaces": replaces, "counter": counter or name}
    row.update(compare(name, got, want))
    group = {"ms": fn, "plain_ms": plain, **(yardsticks or {})}
    if lib is not None:
        group["library_ms"] = lib
    times, row["timer"] = time_group(group)
    row.update(times)
    row["kernel_ms"] = row["ms"]
    row.setdefault("library_ms", None)
    # the wrapper's time per call with the host's launch gaps
    row["call_ms"] = cuda_ms(fn)
    if cold_kernel is not None:
        row["ms_l2_flushed"] = device_ms_l2_flushed(fn, cold_kernel)
    row["bound_ms"], row["bound_by"] = bound(nbytes, nops)
    out.append(row)
    return row


def expand_bytes(cnt, start, limit: int, ka: int, nsel: int, cap: int):
    """Bytes the join expand must move for these inputs: the running
    counts read once (the row base is the previous running count, so cnt
    is not read), the start of each a-row that owns a slot below
    min(total, limit), that a-row and the new columns of each b-row such
    a slot pairs it with; the [cap, ka + nsel] output written once."""
    import numpy as np
    cnt = np.asarray(cnt, np.int64)
    start = np.asarray(start, np.int64)
    n = cnt.shape[0]
    csum = np.cumsum(cnt)
    end = min(int(csum[-1]) if n else 0, limit)
    # each row's slots below end: max(0, min(csum, end) - base)
    take = np.clip(np.minimum(csum, end) - (csum - cnt), 0, None)
    used_a = int((take > 0).sum())
    # distinct b-rows of the ranges [start, start + take)
    lo, hi = start[take > 0], start[take > 0] + take[take > 0]
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    reach = np.maximum.accumulate(hi) if hi.size else hi
    prev = np.concatenate([[-1], reach[:-1]]) if hi.size else hi
    used_b = int(np.clip(hi - np.maximum(lo, prev), 0, None).sum())
    return (4 * (n + used_a * (1 + ka) + used_b * nsel + cap * (ka + nsel)),
            used_a, used_b)


def record_expand(out, name, a_rows, b_rows, start, cnt, limit, cap, new_sel,
                  counter="expand_segments"):
    """The expand_gather row: the one launch against its plain version
    (torch.searchsorted + the gather: the library composition, so the row
    has no library_ms of its own), beside the slot-map path
    (yardstick_slot_map_path_ms: the expand_segments kernel's slot map,
    then the same gather in PyTorch), at these inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    csum = torch.cumsum(cnt, 0, dtype=torch.int32)
    n, ka, nsel = a_rows.shape[0], a_rows.shape[1], len(new_sel)

    def kernel():
        return ops.expand_gather(a_rows, b_rows, start, cnt, limit, cap,
                                 new_sel, csum=csum)

    def plain():
        return ref.expand_gather_ref(a_rows, b_rows, start, cnt, limit, cap,
                                     new_sel, csum=csum)

    def slot_map_path():
        seg = ops.expand_segments(csum, cap)
        t = torch.arange(cap, dtype=torch.int32, device=csum.device)
        invalid = ~((t < csum[n - 1]) & (t < limit))[:, None]
        i = torch.clamp(seg, max=n - 1)
        base = csum[i] - cnt[i]
        j = torch.clamp(start[i] + (t - base), 0, b_rows.shape[0] - 1)
        left = a_rows[i].masked_fill(invalid, -1)
        if not new_sel:
            return left
        right = b_rows[j][:, list(new_sel)].masked_fill(invalid, -1)
        return torch.cat([left, right], dim=1)
    compare(f"{name} (slot-map path)", (slot_map_path(),), (plain(),))
    nbytes, used_a, used_b = expand_bytes(cnt.cpu().numpy(),
                                          start.cpu().numpy(), limit, ka,
                                          nsel, cap)
    row = record_row(out, name, "expand_segments.cu",
                     "src/repro/kernels/fused_join.py:198", kernel, plain,
                     None, nbytes, cap * (ka + nsel), (kernel(),), (plain(),),
                     counter=counter, cold_kernel="expand_gather_kernel",
                     yardsticks={"yardstick_slot_map_path_ms": slot_map_path})
    row["shape"] = {"n": n, "nb": b_rows.shape[0], "ka": ka,
                    "new": nsel, "cap": cap, "limit": limit,
                    "used_a_rows": used_a, "used_b_rows": used_b}
    return row


def record_probe(out, name, a, b, counter=None):
    """A merge_probe row at these keys: the launch the engine makes (the
    kernel chosen by na + nb) beside each of the two kernels forced
    (yardstick_path_ms, yardstick_bisect_ms) and the searchsorted pair."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.merge_probe import merge_probe_cuda
    row = record_row(
        out, name, "merge_probe.cu", "src/repro/kernels/merge_probe.py:92",
        lambda: ops.merge_probe(a, b), lambda: ref.merge_probe_sorted(a, b),
        lambda: (torch.searchsorted(b, a, out_int32=True),
                 torch.searchsorted(b, a, right=True, out_int32=True)),
        4 * (3 * a.shape[0] + b.shape[0]), a.shape[0] + b.shape[0],
        ops.merge_probe(a, b), ref.merge_probe_sorted(a, b),
        counter=counter, cold_kernel="merge_probe",
        yardsticks={f"yardstick_{m}_ms":
                    (lambda m=m: merge_probe_cuda(a, b, m))
                    for m in ("path", "bisect")})
    row["shape"] = {"na": a.shape[0], "nb": b.shape[0]}
    return row


# ---------------------------------------------------------------------- #
def kernel_phase(ds, rng) -> list:
    """Each kernel vs its plain version at the main path's shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import radix_join as krad
    from repro_torch.core.matching import _radix_bits
    from repro_torch.core.connectivity import reach_sets
    from repro_torch.core.signature import bloom_query_sig, build_bloom

    dev = torch.device(DEVICE)
    out = []

    # merge_probe: A = B = 2^20 sorted keys with duplicate runs and the
    # per-side invalid sentinels
    n = 1 << 20
    a = rng.integers(0, 1 << 18, n).astype(np.int32)
    b = rng.integers(0, 1 << 18, n).astype(np.int32)
    a[rng.random(n) < 0.05] = A_INVALID
    b[rng.random(n) < 0.05] = B_INVALID
    a = torch.as_tensor(np.sort(a), device=dev)
    b = torch.as_tensor(np.sort(b), device=dev)
    record_probe(out, "merge_probe", a, b)

    # expand_segments: cap = 2^20 output slots over 2^20 running counts
    cnt = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32), device=dev)
    csum = torch.cumsum(cnt, 0, dtype=torch.int32)
    cap = 1 << 20
    t = torch.arange(cap, dtype=torch.int32, device=dev)
    record_row(out, "expand_segments", "expand_segments.cu",
               "src/repro/kernels/fused_join.py:198",
               lambda: ops.expand_segments(csum, cap),
               lambda: ref.expand_segments_ref(csum, cap),
               lambda: torch.searchsorted(csum, t, right=True, out_int32=True),
               4 * (n + cap), cap * math.ceil(math.log2(n + 1)),
               (ops.expand_segments(csum, cap),),
               (ref.expand_segments_ref(csum, cap),))

    # expand_gather: the whole expand in one launch at cap = 2^20 over the
    # same 2^20 running counts, a-rows of 3 columns, one new column of
    # 2-column b-rows; match ranges ascending in b, as a sort-merge join
    # gives them
    ka, nb_exp, new_sel = 3, 1 << 20, (1,)
    a_rows = torch.as_tensor(rng.integers(0, 1 << 30, (n, ka))
                             .astype(np.int32), device=dev)
    b_rows = torch.as_tensor(rng.integers(0, 1 << 30, (nb_exp, 2))
                             .astype(np.int32), device=dev)
    start = torch.as_tensor(np.sort(rng.integers(0, nb_exp - 2, n))
                            .astype(np.int32), device=dev)
    record_expand(out, "expand_gather", a_rows, b_rows, start, cnt, cap, cap,
                  new_sel)
    del a_rows, b_rows, start

    # window_probe: A = 2^20 probe rows against the bucket spans of a real
    # radix partition of B = 2^16 keys, windows of Lmax = 16.  The kernel
    # reads the spans in place; the plain version and the library call
    # build the [A, Lmax] window first (radix_window), as the windowed
    # probe did
    nb_rows, lmax = 1 << 16, 16
    b_keys = torch.as_tensor(rng.integers(0, 1 << 20, nb_rows)
                             .astype(np.int32), device=dev)
    b_rows = torch.stack([b_keys, torch.arange(nb_rows, dtype=torch.int32,
                                               device=dev)], dim=1)
    bits = _radix_bits(nb_rows)
    keys_p, _, edges, _ = krad.radix_partition(b_keys, b_rows, bits)
    probe_np = rng.integers(0, 1 << 20, n).astype(np.int32)
    probe = torch.as_tensor(probe_np, device=dev)
    win, _ = krad.radix_window(probe, edges, keys_p, bits, lmax)

    def searchsorted_pair(w):
        # windows are ascending (each bucket span sorted, B_INVALID tail):
        # the left and right searches give lt and lt + cnt
        return (torch.searchsorted(w, probe[:, None], out_int32=True),
                torch.searchsorted(w, probe[:, None], right=True,
                                   out_int32=True))
    # the keys_p words each probe's span holds (capped at lmax), and the
    # words the spans cover together (each read once); the probe keys are
    # all valid, so every bucket is a real one
    pb = (((probe_np.astype(np.uint64) * 2654435761) & 0xFFFFFFFF)
          >> (32 - bits)).astype(np.int64)
    edges_np = edges.cpu().numpy().astype(np.int64)
    span = np.minimum(edges_np[pb + 1] - edges_np[pb], lmax)
    covered = int(span[np.unique(pb, return_index=True)[1]].sum())
    record_row(out, "window_probe", "window_probe.cu",
               "src/repro/kernels/radix_join.py:135",
               lambda: ops.radix_probe(probe, keys_p, edges, bits=bits,
                                       lmax=lmax),
               lambda: krad.radix_probe_ref(probe, keys_p, edges, bits, lmax),
               lambda: searchsorted_pair(
                   krad.radix_window(probe, edges, keys_p, bits, lmax)[0]),
               4 * n + 4 * edges.shape[0] + 4 * covered + 12 * n,
               2 * int(span.sum()),
               ops.radix_probe(probe, keys_p, edges, bits=bits, lmax=lmax),
               krad.radix_probe_ref(probe, keys_p, edges, bits, lmax),
               # the windowed probe's yardstick: the searchsorted pair
               # over a prebuilt window
               yardsticks={"library_ms_window_only":
                           lambda: searchsorted_pair(win)})
    out[-1]["keys_p_words_covered"] = covered
    del win

    # interval_count: C = 8192 candidates over real NI rows of the 2-hop
    # backward entry (cap 4096), J = 8 keyword intervals, with each row's
    # stored length beside the ids as the engine's check passes it
    entry = ds.ni.entries[-2]
    ids = torch.as_tensor(entry.ids, device=dev)
    lens_np = np.minimum(entry.count, entry.cap).astype(np.int32)
    lens = torch.as_tensor(lens_np, device=dev)
    c, j = 8192, 8
    n_rows = entry.ids.shape[0]
    cand_np = np.sort(rng.choice(n_rows, c, replace=n_rows < c))
    cands = torch.as_tensor(cand_np.astype(np.int32), device=dev)
    nn = ds.graph.num_nodes
    lo_np = np.sort(rng.integers(0, nn, j)).astype(np.int32)
    hi_np = (lo_np + rng.integers(1, max(nn // 8, 2), j)).astype(np.int32)
    lo = torch.as_tensor(lo_np, device=dev)
    hi = torch.as_tensor(hi_np, device=dev)
    row_len = lens_np[cand_np].astype(np.int64)
    valid = int(row_len.sum())
    searches = int(np.ceil(np.log2(row_len + 1)).sum())
    # the same kernel searching whole rows (no lens), timed in the same
    # run so the valid-prefix search is compared with it on one card
    compare("interval_count_full_rows",
            (ops.interval_count(ids, lo, hi, cands=cands),),
            (ref.interval_count_gather_ref(ids, cands, lo, hi),))

    def full_rows():
        return ops.interval_count(ids, lo, hi, cands=cands)
    record_row(out, "interval_count", "interval_count.cu",
               "src/repro/kernels/interval_count.py:58",
               lambda: ops.interval_count(ids, lo, hi, cands=cands, lens=lens),
               lambda: ref.interval_count_gather_ref(ids, cands, lo, hi, lens),
               None, 8 * c + 4 * valid + 8 * j + 4 * c * j, 2 * j * searches,
               (ops.interval_count(ids, lo, hi, cands=cands, lens=lens),),
               (ref.interval_count_gather_ref(ids, cands, lo, hi, lens),),
               yardsticks={"full_rows_ms": full_rows})
    emit({"phase": "interval_count_full_rows",
          "ms": out[-1]["full_rows_ms"], "call_ms": cuda_ms(full_rows),
          "ms_valid_prefix": out[-1]["ms"],
          "call_ms_valid_prefix": out[-1]["call_ms"],
          "mean_row_len": valid / c})
    del ids, lens
    torch.cuda.empty_cache()

    # interval_count_node_check: the whole check of one query node in one
    # launch (both directions, distances 1 and 2, J = 8) over 65,536
    # contiguous candidate nodes of the real NI entries, against its plain
    # version.  The bound counts each candidate's stored prefix in each
    # segment once, its length and overflow bit, and the ok byte
    segs, host_over = node_check_segments(ds, rng, j, dev)
    nn_cand = min(1 << 16, nn)
    c_lo = (nn - nn_cand) // 2
    c_hi = c_lo + nn_cand
    prefix = sum(int(s.lens[c_lo:c_hi].sum()) for s in segs)
    node_ok = ops.interval_check(segs, c_lo, c_hi)
    record_row(out, "interval_count_node_check", "interval_count.cu",
               "src/repro/kernels/interval_count.py:58",
               lambda: ops.interval_check(segs, c_lo, c_hi),
               lambda: ref.interval_check_ref(segs, c_lo, c_hi),
               None, 4 * prefix + 5 * len(segs) * nn_cand + nn_cand,
               2 * j * prefix, (node_ok,),
               (ref.interval_check_ref(segs, c_lo, c_hi),),
               counter="interval_count")
    # beside it, host wall time per node of the one launch with its copy
    # back, and of the chunked pattern on the same inputs: a count launch
    # per 8,192-candidate chunk, direction and distance, each copied back
    new_s, old_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = ops.interval_check(segs, c_lo, c_hi).cpu().numpy()
        new_s.append(time.perf_counter() - t0)
        before = ops.cuda_kernels()["interval_count"].launches
        t0 = time.perf_counter()
        old = chunked_check(segs, host_over, c_lo, c_hi)
        old_s.append(time.perf_counter() - t0)
        old_launches = ops.cuda_kernels()["interval_count"].launches - before
        if not np.array_equal(got, old):
            fail("interval_count_node_check: the one-launch verdict differs "
                 "from the chunked launch pattern's")
    emit({"phase": "interval_count_node_check", "candidates": nn_cand,
          "first": c_lo, "segments": len(segs), "j": j,
          "stored_ids": prefix, "pass_share": float(got.mean()),
          "rows_over_32_ids": [int((s.lens[c_lo:c_hi] > 32).sum())
                               for s in segs],
          "host_ms_per_node": float(np.median(new_s)) * 1e3,
          "host_ms_per_node_chunked": float(np.median(old_s)) * 1e3,
          "launches_per_node_chunked": old_launches})
    del segs, node_ok
    torch.cuda.empty_cache()

    # bitmask_contains: the real 1-hop bloom signatures of every node
    # (W = 8 words) against the query signature of two real node ids.  The
    # test of a row ends at its first word with a missing bit: the bound
    # counts the words up to there
    e1 = ds.ni.entries[1]
    sigs_np = build_bloom(e1)
    sigs = ops.bits32(sigs_np).to(dev)
    n_sig, w = sigs.shape
    node = int(np.argmax((e1.ids >= 0).sum(axis=1)))
    required = e1.ids[node][e1.ids[node] >= 0][:2].astype(np.int64)
    qsig_np = bloom_query_sig(required)
    qsig = ops.bits32(qsig_np).to(dev)
    miss = (qsig_np[None, :] & ~sigs_np) != 0
    words = int(np.where(miss.any(1), miss.argmax(1) + 1, w).sum())
    record_row(out, "bitmask_contains", "bitmask_contains.cu",
               "src/repro/kernels/bitmask_contains.py:39",
               lambda: ops.bitmask_contains(sigs, qsig),
               lambda: ref.bitmask_contains_ref(sigs, qsig),
               None, 4 * words + 4 * w + 4 * n_sig, 2 * words,
               (ops.bitmask_contains(sigs, qsig),),
               (ref.bitmask_contains_ref(sigs, qsig),))
    sig_pass = int((~miss.any(1)).sum())

    # intersect_any: real reach sets of two sets of 1,024 random nodes,
    # forward 2 hops against backward 2 hops (the hop split of d_c = 4).
    # A pair's test ends at the first b entry found in its a-row: the
    # bound counts the b-row up to there
    p = 1024
    a_nodes = rng.integers(0, ds.graph.num_nodes, p)
    b_nodes = rng.integers(0, ds.graph.num_nodes, p)
    fa, _ = reach_sets(ds.ni, a_nodes, 2, +1)
    bb, _ = reach_sets(ds.ni, b_nodes, 2, -1)
    fa, bb = np.ascontiguousarray(fa), np.ascontiguousarray(bb)
    ra = torch.as_tensor(fa, device=dev)
    rb = torch.as_tensor(bb, device=dev)
    wa, wb = fa.shape[1], bb.shape[1]
    found = np.stack([np.isin(bb[i], fa[i][fa[i] >= 0]) for i in range(p)])
    b_read = np.where(found.any(1), found.argmax(1) + 1, wb)
    record_row(out, "intersect_any", "intersect_any.cu",
               "src/repro/kernels/sorted_intersect.py:47",
               lambda: ops.intersect_any(ra, rb),
               lambda: ref.intersect_any_sorted(ra, rb),
               None, 4 * (p * wa + int(b_read.sum())) + 4 * p,
               int(((fa >= 0).sum(1) * b_read).sum()),
               (ops.intersect_any(ra, rb),),
               (ref.intersect_any_sorted(ra, rb),))
    del ra, rb

    # intersect_any_ragged: the same nodes' rows from the ragged gather of
    # connectivity_mask_vectorized (valid ids only, overflowed rows empty),
    # then 65,536 random pairs, their rows gathered 1,024 pairs at a time
    ragged = {"intersect_any_ragged": ragged_rows(ds.ni, a_nodes, b_nodes)}
    big = 1 << 16
    ragged["intersect_any_ragged_65536"] = ragged_rows(
        ds.ni, rng.integers(0, ds.graph.num_nodes, big),
        rng.integers(0, ds.graph.num_nodes, big))
    for name, host in ragged.items():
        record_ragged(out, name, host, dev)
    emit({"phase": "kernels", "cap": entry.cap,
          "shapes": {"merge_probe": [n, n], "expand_segments": [n, cap],
                     "expand_gather": out[2]["shape"],
                     "window_probe": {"a": n, "b": nb_rows, "bits": bits,
                                      "lmax": lmax},
                     "interval_count": [c, entry.cap, j],
                     "interval_count_node_check": [nn_cand, 4, j],
                     "bitmask_contains": [n_sig, w],
                     "intersect_any": [p, wa, wb],
                     **{r["name"]: r["shape"] for r in out
                        if r["name"] in ragged}},
          "bitmask_contains_pass": sig_pass,
          "bitmask_contains_words_read": words,
          "intersect_any_hits": int(found.any(1).sum()),
          "intersect_any_b_read": int(b_read.sum()),
          "intersect_any_valid_per_row": [float((fa >= 0).sum(1).mean()),
                                          float((bb >= 0).sum(1).mean())]})
    del sigs
    torch.cuda.empty_cache()
    return out


def ragged_rows(ni, a_nodes, b_nodes, chunk: int = 1024):
    """The ragged rows (a_ids, a_off, b_ids, b_off) of these pairs,
    forward 2 hops against backward 2 hops, as
    connectivity_mask_vectorized gathers them, chunk pairs at a time and
    concatenated (a dense gather of 65,536 backward rows would take 2 GB
    of host memory)."""
    import numpy as np
    from repro_torch.core.connectivity import ragged_reach
    sides = []
    for nodes, sign in ((a_nodes, +1), (b_nodes, -1)):
        ids, lens = [], []
        for s in range(0, len(nodes), chunk):
            x, off, _ = ragged_reach(ni, nodes[s:s + chunk], 2, sign)
            ids.append(x)
            lens.append(np.diff(off))
        lens = np.concatenate(lens)
        off = np.concatenate([[0], np.cumsum(lens)])
        if off[-1] >= 1 << 31:
            fail("ragged rows: more than 2^31 - 1 ids a side")
        sides += [np.concatenate(ids), off.astype(np.int32)]
    return sides


def record_ragged(out, name, host, dev):
    """An intersect_any_ragged row at these ragged rows (host arrays).
    The bound counts both sides' offsets, each pair's shorter row whole
    and its longer up to the first id found in the shorter (nothing of a
    pair with an empty row), and one int out a pair; the operations are
    the compares of those reads.  Beside it, the kernel's tier of each
    pair (csrc/intersect_any.cu: group, warp or block)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    fa, fa_off, bb, bb_off = host
    p = len(fa_off) - 1
    la, lb = np.diff(fa_off), np.diff(bb_off)
    short, long_ = np.minimum(la, lb), np.maximum(la, lb)
    read = nops = hits = 0
    for i in np.flatnonzero(short > 0):
        x = fa[fa_off[i]:fa_off[i + 1]]
        y = bb[bb_off[i]:bb_off[i + 1]]
        s, l = (x, y) if len(x) <= len(y) else (y, x)
        f = np.isin(l, s)
        upto = int(f.argmax()) + 1 if f.any() else len(l)
        read += len(s) + upto
        nops += len(s) * upto
        hits += bool(f.any())
    rows = [torch.as_tensor(x, device=dev) for x in host]
    big = p > 1024
    record_row(out, name, "intersect_any.cu",
               "src/repro/kernels/sorted_intersect.py:47",
               lambda: ops.intersect_any_ragged(*rows),
               lambda: ref.intersect_any_ragged_ref(*rows),
               None, 4 * read + 8 * (p + 1) + 4 * p, nops,
               (ops.intersect_any_ragged(*rows),),
               (ref.intersect_any_ragged_ref(*rows),),
               counter="intersect_any",
               cold_kernel="intersect_any_ragged" if big else None)
    # csrc/intersect_any.cu: staged <= 32 and streamed <= 64 (group) or
    # <= 1,024 (warp)
    group = (short > 0) & (short <= 32) & (long_ <= 64)
    warp = (short > 0) & (short <= 32) & (long_ > 64) & (long_ <= 1024)
    out[-1]["shape"] = {
        "p": p, "a_ids": len(fa), "b_ids": len(bb),
        "mean_len": [float(la.mean()), float(lb.mean())],
        "max_len": [int(la.max()), int(lb.max())],
        "empty_rows": [int((la == 0).sum()), int((lb == 0).sum())],
        "ids_read": read, "hits": hits,
        "tiers": {"empty": int((short == 0).sum()), "group": int(group.sum()),
                  "warp": int(warp.sum()),
                  "block": int(p - (short == 0).sum() - group.sum()
                               - warp.sum())}}
    return out[-1]


def node_check_segments(ds, rng, j: int, dev):
    """The CheckSegments of one query node on the real NI entries, as
    check_interval_candidates builds them: forward then backward,
    distances 1 and 2, J intervals each (the first the whole id range:
    one forward neighbor needed at 1 hop and two within 2, one backward
    neighbor within 2); and each entry's overflow bits on the host."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    nn = ds.graph.num_nodes
    segs, host_over = [], []
    for sign in (1, -1):
        lo = np.sort(rng.integers(0, nn, j))
        hi = lo + rng.integers(1, max(nn // 8, 2), j)
        lo[0], hi[0] = 0, nn
        need = np.zeros((2, j), np.int32)
        need[:, 0] = (1, 2) if sign > 0 else (0, 1)
        for d in (1, 2):
            e = ds.ni.entries[sign * d]
            lens = np.minimum(e.count, e.cap).astype(np.int32)
            segs.append(ops.CheckSegment(
                torch.as_tensor(e.ids, device=dev),
                torch.as_tensor(lens, device=dev),
                torch.as_tensor(e.overflow, device=dev), lo, hi,
                need[d - 1], d == 1))
            host_over.append(e.overflow)
    return segs, host_over


def chunked_check(segs, host_over, lo: int, hi: int, chunk: int = 8192):
    """The neighborhood check with one count launch per chunk, as the
    reference's loop runs it, for comparison: per chunk of candidates,
    direction and distance one ops.interval_count launch and a copy of
    its [chunk, j_pad] counts to the host, where the sums over distance,
    the overflow bits and the verdict are taken."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    dev = segs[0].ids.device
    n = hi - lo
    out = np.ones(n, dtype=bool)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        cands = np.arange(lo + start, lo + stop, dtype=np.int32)
        cands_dev = torch.as_tensor(cands, device=dev)
        ok = np.ones(stop - start, dtype=bool)
        for seg, over_np in zip(segs, host_over):
            if seg.first:
                j = len(seg.lo)
                j_pad = max(4, 1 << (j - 1).bit_length())
                lo_b = np.zeros(j_pad, np.int32)
                hi_b = np.zeros(j_pad, np.int32)
                lo_b[:j], hi_b[:j] = seg.lo, seg.hi
                lo_dev = torch.as_tensor(lo_b, device=dev)
                hi_dev = torch.as_tensor(hi_b, device=dev)
                cum = np.zeros((stop - start, j), dtype=np.int64)
                over = np.zeros(stop - start, dtype=bool)
            cnt = ops.interval_count(seg.ids, lo_dev, hi_dev,
                                     cands=cands_dev, lens=seg.lens)
            cum += cnt[:, :j].cpu().numpy()
            over |= over_np[cands]
            if seg.need is not None:
                ok &= (cum >= np.asarray(seg.need)[None, :]).all(axis=1) \
                    | over
        out[start:stop] = ok
    return out


def check_rows(r, n_nodes: int, n_query: int) -> None:
    import numpy as np
    if r.rows.shape != (r.count, n_query):
        fail(f"result shape {r.rows.shape}, expected ({r.count}, {n_query})")
    if r.count and not (np.all(r.rows >= 0) and np.all(r.rows < n_nodes)):
        fail("result rows hold ids outside the graph")


def profile_warm(gpu, pqs) -> dict:
    """One more warm pass under torch.profiler: device kernel time by
    name and the device's busy share of the pass's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pq in pqs:
            gpu.execute_prepared(pq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = device_times(prof)
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "top_device_ms": dict(top)}


N_QUERIES = 12          # the last 4 carry one connection edge each


def main_phase(ds, n_queries: int):
    import numpy as np
    import torch
    import repro_torch.core.engine as engine_mod
    import repro_torch.core.matching as matching
    from repro_torch.data import random_query
    from repro_torch.kernels import fused_join, ops

    g = ds.graph
    gpu = ds.engine("rdf_h", device=DEVICE)
    cpu = ds.engine("rdf_h", device="cpu")
    queries = [random_query(g, size=6, seed=100 + i,
                            n_connection=1 if i >= n_queries - 4 else 0)
               for i in range(n_queries)]

    # read-only taps for this phase: the check calls that launched the
    # node check, the shapes of every radix join (a.cap, b.count from
    # the join, bits and lmax from its probe), of every sort-merge probe
    # and of every join expand, whose expand_segments-counter launches
    # are counted call by call
    counter = ops.cuda_kernels()["interval_count"]
    expand_counter = ops.cuda_kernels()["expand_segments"]
    checks = {"calls": 0, "launched": 0}
    radix, probes, expands = [], [], []
    inputs = {"probe": {}, "expand": {}}     # first inputs of each shape
    check, join_radix, probe = (engine_mod.check_interval_candidates,
                                matching._join_radix, ops.radix_probe)
    # the staged and reach-join probes go through ops.merge_probe, the
    # fused chain's through fused_join._probe
    merge, fused, expand = (ops.merge_probe, fused_join._probe,
                            ops.expand_gather)

    def tapped(fn):
        def tap(a, b, *rest, **kw):
            start, cnt = fn(a, b, *rest, **kw)
            shape = (a.shape[0], b.shape[0])
            probes.append({"shape": shape, "cnt": cnt})
            inputs["probe"].setdefault(shape, (a, b))
            return start, cnt
        return tap

    def tap_expand(a_rows, b_rows, start, cnt, limit, cap, new_sel=(),
                   **kw):
        before = expand_counter.launches
        rows = expand(a_rows, b_rows, start, cnt, limit, cap, new_sel, **kw)
        shape = (a_rows.shape[0], cap, a_rows.shape[1], len(new_sel))
        expands.append({"shape": shape,
                        "path": sys._getframe(1).f_code.co_name,
                        "launches": expand_counter.launches - before})
        inputs["expand"].setdefault(shape, (a_rows, b_rows, start, cnt,
                                            limit, cap, tuple(new_sel)))
        return rows

    def tap_check(*a, **kw):
        before = counter.launches
        ok = check(*a, **kw)
        checks["calls"] += 1
        checks["launched"] += counter.launches > before
        return ok

    def tap_join(a, b, *rest, **kw):
        radix.append({"a_cap": a.cap, "b_count": b.count,
                      "resume": kw.get("resume") is not None})
        return join_radix(a, b, *rest, **kw)

    def tap_probe(*a, **kw):
        radix[-1].update(bits=kw["bits"], lmax=kw["lmax"])
        return probe(*a, **kw)
    engine_mod.check_interval_candidates = tap_check
    matching._join_radix, ops.radix_probe = tap_join, tap_probe
    ops.merge_probe, ops.expand_gather = tapped(merge), tap_expand
    fused_join._probe = tapped(fused)
    try:
        reset_launches()
        torch.cuda.synchronize()
        lat = {"cold": [], "warm": []}
        results = {}
        pqs = [None] * n_queries
        check_launches, n_radix, by_run = {}, {}, {}
        n_probes, n_expands = {}, {}
        t_start = time.perf_counter()
        for run in ("cold", "warm"):
            t_run = time.perf_counter()
            before = counter.launches
            start = launch_counts()
            for i, q in enumerate(queries):
                t0 = time.perf_counter()
                if run == "cold":              # first sight: plan, then run
                    pqs[i] = gpu.prepare(q)
                r = gpu.execute_prepared(pqs[i])   # rows come back
                torch.cuda.synchronize()
                lat[run].append(time.perf_counter() - t0)
                results[(run, i)] = r
            lat[run + "_wall"] = time.perf_counter() - t_run
            check_launches[run] = counter.launches - before
            n_radix[run] = len(radix)
            n_probes[run], n_expands[run] = len(probes), len(expands)
            by_run[run] = {k: v - start[k]
                           for k, v in launch_counts().items()}
        wall = time.perf_counter() - t_start
        launches = read_launches("main", MAIN_KERNELS)
    finally:
        engine_mod.check_interval_candidates = check
        matching._join_radix, ops.radix_probe = join_radix, probe
        ops.merge_probe, ops.expand_gather = merge, expand
        fused_join._probe = fused
    if check_launches["cold"] > checks["launched"]:
        fail(f"main: {check_launches['cold']} interval_count launches for "
             f"{checks['launched']} check calls that launched")
    if check_launches["warm"]:
        fail(f"main: the warm run launched interval_count "
             f"{check_launches['warm']} times")
    # every join expand, cold and warm, was one launch of the expand
    # kernel, and the phase launched it for nothing else
    not_one = [e for e in expands if e["launches"] != 1]
    if not_one:
        fail(f"main: {len(not_one)} join expands were not exactly one "
             f"expand_segments launch: {not_one[:3]}")
    if by_run["cold"]["expand_segments"] + by_run["warm"]["expand_segments"] \
            != len(expands):
        fail(f"main: {len(expands)} join expands, "
             f"{launches['expand_segments']} expand_segments launches")
    profile = profile_warm(gpu, pqs)

    # correctness: shape and id range, warm == cold, and — for the first
    # query and the last (a connection edge through the reach-join), the
    # CPU engine being slow at full size — the card's result sets equal
    # the CPU engine's on the same Dataset (the parity phase compares
    # every query shape at a small scale)
    cpu_checked = (0, n_queries - 1)
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        cold, warm = results[("cold", i)], results[("warm", i)]
        check_rows(cold, g.num_nodes, q.num_nodes)
        if warm.result_set() != cold.result_set():
            fail(f"query {i}: warm result differs from cold")
        if i in cpu_checked and \
                cpu.execute(q).result_set() != cold.result_set():
            fail(f"query {i}: the card's result differs from the CPU's")
    cpu_check_s = time.perf_counter() - t0

    stats = [results[("cold", i)].stats for i in range(n_queries)]
    served, serve_ref_s = serve_references(gpu, queries, results, stats)
    summary = {
        "phase": "main", "queries": n_queries,
        "qps_cold": n_queries / lat["cold_wall"],
        "qps_warm": n_queries / lat["warm_wall"],
        "p50_ms_cold": pct(lat["cold"], 50), "p95_ms_cold": pct(lat["cold"], 95),
        "p50_ms_warm": pct(lat["warm"], 50), "p95_ms_warm": pct(lat["warm"], 95),
        "latency_ms_cold": [x * 1e3 for x in lat["cold"]],
        "latency_ms_warm": [x * 1e3 for x in lat["warm"]],
        "matches": [results[("cold", i)].count for i in range(n_queries)],
        "used_check": [s.used_check for s in stats],
        "join_strategies": [s.join_strategies for s in stats],
        "conn_strategies": [s.conn_strategies for s in stats],
        "truncated": [s.truncated for s in stats],
        "check_ms": [s.check_time * 1e3 for s in stats],
        "match_ms": [s.match_time * 1e3 for s in stats],
        "conn_ms": [s.conn_time * 1e3 for s in stats],
        "launches": launches,
        "launches_per_query": {k: launches[k] / (2 * n_queries)
                               for k in MAIN_KERNELS},
        "launches_by_run": by_run,
        "check_calls": checks["calls"],
        "check_calls_launched": checks["launched"],
        "interval_count_launches_per_query": {
            run: check_launches[run] / n_queries for run in ("cold", "warm")},
        "check_ms_cold_median": float(np.median(
            [s.check_time * 1e3 for s in stats if s.used_check])),
        "radix_joins": {run: radix[lo:n_radix[run]] for run, lo in
                        (("cold", 0), ("warm", n_radix["cold"]))},
        # [na, nb, match total] of every sort-merge probe and [n, cap, ka,
        # new, the calling join path] of every join expand, by run
        "merge_probes": {run: [[*p["shape"], int(p["cnt"].sum())]
                               for p in probes[lo:n_probes[run]]]
                         for run, lo in (("cold", 0),
                                         ("warm", n_probes["cold"]))},
        "join_expands": {run: [[*e["shape"], e["path"]]
                               for e in expands[lo:n_expands[run]]]
                         for run, lo in (("cold", 0),
                                         ("warm", n_expands["cold"]))},
        "wall_s": wall, "cpu_checked": list(cpu_checked),
        "cpu_check_s": cpu_check_s, "warm_profile": profile,
        "serve_reference_s": serve_ref_s,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(summary)
    conn = [(queries[i], results[("cold", i)]) for i in range(n_queries)
            if queries[i].connections]
    # the inputs of the commonest probe and expand shapes, for the kernel
    # rows at the main path's shapes
    common = {"probe_all": {
        shape: (*ab, [p["shape"] for p in probes].count(shape))
        for shape, ab in inputs["probe"].items()}}
    for kind, calls in (("probe", probes), ("expand", expands)):
        shapes = [c["shape"] for c in calls]
        if shapes:
            top = max(inputs[kind], key=shapes.count)
            common[kind] = (inputs[kind][top], shapes.count(top))
    return launches, by_run, conn, common, served


def main_shape_rows(common) -> list:
    """merge_probe and expand_gather again, on the real inputs of the
    commonest sort-merge probe and join expand of the main phase."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.merge_probe import BISECT_BELOW, merge_probe_cuda
    out = []
    if "probe" in common:
        (a, b), calls = common["probe"]
        row = record_probe(out, "merge_probe_main_shape", a, b,
                           counter="merge_probe")
        row["shape"]["calls_of_this_shape"] = calls
    # every probe shape of the main phase, on its first inputs: the merge
    # path, the bisection kernel and the searchsorted pair, in turn in one
    # trace, in REPEATS rounds (small shapes' times vary from one trace to
    # the next); bisect_over_path is the median of the rounds' ratios
    shapes = []
    kernels = {"path": "merge_probe_kernel",
               "bisect": "merge_probe_bisect_kernel", "pair": None}
    for (na, nb), (a, b, calls) in sorted(common["probe_all"].items()):
        want = ref.merge_probe_sorted(a, b)
        group = {}
        for m in ("path", "bisect"):
            compare(f"merge_probe {na}x{nb} {m}", merge_probe_cuda(a, b, m),
                    want)
            group[m] = lambda m=m: merge_probe_cuda(a, b, m)
        group["pair"] = lambda: (
            torch.searchsorted(b, a, out_int32=True),
            torch.searchsorted(b, a, right=True, out_int32=True))
        rounds = [r for r in (interleaved_ms(group, kernels)
                              for _ in range(REPEATS)) if r is not None]
        shape = {"na": na, "nb": nb, "calls": calls, "rounds": len(rounds),
                 "engine_runs": "bisect" if na + nb < BISECT_BELOW
                 else "path"}
        for k in group:
            ms = [r[k] for r in rounds]
            shape[f"{k}_ms"] = float(np.median(ms)) if ms else None
            shape[f"{k}_ms_range"] = [min(ms), max(ms)] if ms else None
        shape["bisect_over_path"] = float(np.median(
            [r["bisect"] / r["path"] for r in rounds])) if rounds else None
        shapes.append(shape)
    emit({"phase": "merge_probe_shapes", "repeats": REPEATS,
          "shapes": shapes})
    if "expand" in common:
        (a_rows, b_rows, start, cnt, limit, cap, new_sel), calls = \
            common["expand"]
        row = record_expand(out, "expand_gather_main_shape", a_rows, b_rows,
                            start, cnt, limit, cap, new_sel)
        row["shape"]["calls_of_this_shape"] = calls
    return out


def result_digest(res) -> str:
    """The result set of a MatchResult as a digest: its distinct rows with
    the columns in query-node order, sorted, hashed, and the row count."""
    import hashlib
    import numpy as np
    rows = np.asarray(res.rows)[:, np.argsort(res.cols)]
    if len(rows):
        rows = np.unique(rows, axis=0)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    return f"{hashlib.sha256(rows.tobytes()).hexdigest()}:{len(rows)}"


def serve_references(gpu, queries, results, stats):
    """What the serve phase holds its servers to, from the main phase's
    engine: each template's result as a digest.  A server plans the
    template's canonical numbering (serve.plan_cache.canonicalize); a
    complete result is the same set under any numbering, but a result
    cut at max_rows keeps rows in the plan's order, so a truncated
    template's digest is the main engine's run of its canonical form,
    remapped to the template's numbering."""
    from repro_torch.serve.plan_cache import canonicalize, remap_result
    t0 = time.perf_counter()
    digests = []
    for i, q in enumerate(queries):
        res = results[("cold", i)]
        if stats[i].truncated:
            canon, order, _ = canonicalize(q)
            res = remap_result(gpu.execute(canon), order)
            if not res.stats.truncated:
                fail(f"query {i}: the canonical form ran untruncated")
        digests.append(result_digest(res))
    served = {"queries": queries, "digests": digests,
              "truncated": [s.truncated for s in stats],
              "reach": [bool(s.conn_strategies.get("reach"))
                        for s in stats]}
    return served, time.perf_counter() - t0


def serve_round(srv, queries, want, where: str) -> dict:
    """One round of `queries` through QueryServer.submit_many + flush,
    every result held to the main phase's digest; returns the round's
    wall time, launches and plan-cache hits."""
    import torch
    hits0 = srv.plan_cache.hits
    start = launch_counts()
    t0 = time.perf_counter()
    futures = srv.submit_many(queries)
    srv.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "qps": len(queries) / wall,
           "plan_cache_hits": srv.plan_cache.hits - hits0,
           "launches": {k: v - start[k] for k, v in launch_counts().items()},
           "result_cache_hits": 0, "warm": 0, "degraded": 0}
    for f, q, d in zip(futures, queries, want):
        res = f.result()                 # a failed future raises here
        check_rows(res, srv.dataset.num_nodes, q.num_nodes)
        if result_digest(res) != d:
            fail(f"serve {where}: a result differs from the main phase's")
        out["result_cache_hits"] += bool(res.stats.result_cache_hit)
        out["warm"] += bool(res.stats.cache_hit)
        out["degraded"] += bool(res.stats.degraded_steps)
    return out


def serve_phase(ds, served) -> None:
    """The main phase's templates through the serving tier on the card:
    a QueryServer cold then warm, a snapshot restored into a fresh
    server, a server with the result cache, and three injected faults
    that heal by the first retry — every result equal to the main
    phase's engine's (serve_references) — and a kernel launch that fails
    and must fail its query on the governed server."""
    import tempfile
    import torch
    from repro_torch.kernels import KernelError, ops
    from repro_torch.serve import GovernorConfig, QueryError, QueryServer
    from repro_torch.testing import Fault, FaultInjector

    queries, want = served["queries"], served["digests"]
    n = len(queries)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_phase = time.perf_counter()
    # calibrate=False: the warm round replays every learned plan (online
    # calibration may move a τ and re-decide a template's check)
    srv = QueryServer(ds, "rdf_h", calibrate=False, device=DEVICE)
    rounds = {"cold": serve_round(srv, queries, want, "cold"),
              "warm": serve_round(srv, queries, want, "warm")}
    launches = read_launches("serve", MAIN_KERNELS)
    warm = rounds["warm"]
    if warm["plan_cache_hits"] != n or warm["warm"] != n:
        fail(f"serve: the warm round hit the plan cache "
             f"{warm['plan_cache_hits']} times for {n} templates")
    if warm["launches"]["interval_count"]:
        fail(f"serve: the warm round launched interval_count "
             f"{warm['launches']['interval_count']} times")
    m = srv.metrics
    tele = srv.telemetry()
    explain = srv.explain(queries[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.snap")
        manifest = srv.save_snapshot(path)
        metrics = {
            "p50_ms": m.histogram("latency_s").percentile(50) * 1e3,
            "p95_ms": m.histogram("latency_s").percentile(95) * 1e3,
            "p50_ms_cold": m.histogram("latency_cold_s").percentile(50) * 1e3,
            "p95_ms_cold": m.histogram("latency_cold_s").percentile(95) * 1e3,
            "p50_ms_warm": m.histogram("latency_warm_s").percentile(50) * 1e3,
            "p95_ms_warm": m.histogram("latency_warm_s").percentile(95) * 1e3,
            "qps_cold": rounds["cold"]["qps"], "qps_warm": warm["qps"],
            "counters": tele["metrics"]["counters"],
            "gauges": tele["metrics"]["gauges"]}
        caches = {"plan_cache": tele["plan_cache"],
                  "reach_cache": tele["reach_cache"], "batch": tele["batch"]}
        del srv, m, tele
        torch.cuda.empty_cache()

        # a fresh server restores the snapshot: the plans replay warm,
        # with no neighborhood check
        fresh = QueryServer(ds, "rdf_h", calibrate=False, device=DEVICE)
        fresh.restore_snapshot(path)
        rounds["restored"] = serve_round(fresh, queries, want, "restored")
    restored = rounds["restored"]
    if restored["launches"]["interval_count"] or restored["warm"] != n:
        fail(f"serve: the restored round ran {n - restored['warm']} "
             f"templates cold, with {restored['launches']['interval_count']}"
             " interval_count launches")
    del fresh
    torch.cuda.empty_cache()

    # the result cache serves a repeat with no engine work; the engine
    # caches no truncated result, so the round takes the templates whose
    # main-phase result was complete
    whole = [i for i in range(n) if not served["truncated"][i]]
    if not whole:
        fail("serve: every template's result was truncated")
    rc = QueryServer(ds, "rdf_h", calibrate=False, result_cache_size=64,
                     device=DEVICE)
    sub = ([queries[i] for i in whole], [want[i] for i in whole])
    rounds["result_cache_first"] = serve_round(rc, *sub, "result cache")
    rounds["result_cache_repeat"] = rep = serve_round(rc, *sub,
                                                      "result cache repeat")
    if any(rep["launches"].values()) or rep["result_cache_hits"] != len(whole):
        fail(f"serve: the result-cache repeat launched {rep['launches']} "
             f"with {rep['result_cache_hits']} hits for {len(whole)}")
    del rc
    torch.cuda.empty_cache()

    # faults that heal by the first retry (the governor's transient retry
    # or the engine's capacity retry), on a governed server: the fused
    # probe's on the templates without connection edges, the reach
    # gather's on the last template whose connection edge the main phase
    # ran as a reach-join.  The ladder's rungs past
    # the first retry run nested joins (a quadratic join at this size),
    # so no case may need one
    plain = [i for i in range(n) if not queries[i].connections]
    reach = [i for i in range(n) if served["reach"][i]]
    if not reach:
        fail("serve: no template ran its connection edge as a reach-join")
    gov = QueryServer(ds, "rdf_h", calibrate=False, device=DEVICE,
                      governor=GovernorConfig(retry_backoff_s=0.001))
    cases = [("fused_probe", "corrupt_capacity", plain),
             ("fused_probe", "raise", plain),
             ("reach_gather", "raise", reach[-1:])]
    chaos = []
    for point, kind, idx in cases:
        with FaultInjector(Fault(point, kind, first=1)) as fi:
            r = serve_round(gov, [queries[i] for i in idx],
                            [want[i] for i in idx], f"{point} {kind}")
        if not fi.fired:
            fail(f"serve: the {kind} fault at {point} never fired")
        if r["degraded"]:
            fail(f"serve: the {kind} fault at {point} needed the ladder")
        chaos.append({"point": point, "kind": kind, "templates": idx,
                      "fired": fi.fired, "calls": fi.calls,
                      "wall_s": r["wall_s"]})
    # a kernel that fails to launch fails its query: the governor neither
    # retries it nor answers it from a rung with the plain versions
    kernel = ops.cuda_kernels()["expand_segments"]
    for symbol in kernel.entries:
        kernel._bind(symbol)
    bound = dict(kernel._fns)
    gv = gov.governor
    before = (gv.transient_retries, gv.ladder_entries, gv.degraded_queries)
    kernel._fns.update({s: (lambda *a: 1) for s in bound})
    try:
        f = gov.submit(queries[plain[0]])
        gov.flush()
        try:
            f.result()
            fail("serve: a query whose expand kernel failed to launch "
                 "was answered")
        except QueryError as e:
            if not isinstance(e.__cause__, KernelError):
                fail(f"serve: a failed launch surfaced as {e.__cause__!r}")
    finally:
        kernel._fns.update(bound)
    after = (gv.transient_retries, gv.ladder_entries, gv.degraded_queries)
    if after != before:
        fail(f"serve: a failed launch was retried or degraded "
             f"({before} -> {after})")
    chaos.append({"point": "expand_segments launch", "kind": "KernelError",
                  "templates": plain[:1], "raised": True})
    gov_t = gov.telemetry()["governor"]
    del gov
    torch.cuda.empty_cache()

    emit({"phase": "serve", "templates": n, "metrics": metrics,
          "caches": caches, "snapshot": {k: manifest[k] for k in
                                         ("format_version", "plans",
                                          "bytes")},
          "rounds": rounds, "launches": launches, "chaos": chaos,
          "governor": {k: gov_t[k] for k in
                       ("transient_retries", "transient_recoveries",
                        "ladder_entries", "degraded_queries", "exhausted")},
          "result_cache_templates": whole,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
          / 2**30,
          "seconds": time.perf_counter() - t_phase})
    emit({"phase": "serve_explain", "template": 0, "text": explain})


def pct(xs, p):
    import numpy as np
    return float(np.percentile(np.asarray(xs) * 1e3, p))


N_BLOOM = 6


def bloom_phase(ds) -> tuple:
    """SPath(NI2) with the bloom prefilter at full size, cold then warm,
    against the card's spath_ni2 engine without it."""
    import numpy as np
    import torch
    import repro_torch.core.engine as engine_mod
    from repro_torch.core import Engine, EngineConfig
    from repro_torch.data import random_query

    g = ds.graph
    queries = [random_query(g, size=6, seed=200 + i, exact_nodes=0.5)
               for i in range(N_BLOOM)]
    plain = ds.engine("spath_ni2", device=DEVICE)
    bloom = Engine(ds, EngineConfig(check_policy="always", use_bloom=True,
                                    device=DEVICE))
    want = [plain.execute(q) for q in queries]
    torch.cuda.synchronize()

    # the candidates each prefilter call rejects, read by wrapping the
    # engine's call for this phase only
    removed = []
    prefilter = engine_mod.bloom_prefilter

    def counting(*a, **kw):
        ok = prefilter(*a, **kw)
        removed.append(int((~ok).sum()))
        return ok
    engine_mod.bloom_prefilter = counting
    try:
        reset_launches()
        lat = {"cold": [], "warm": []}
        res = {}
        pqs = [None] * N_BLOOM
        by_run = {}
        for run in ("cold", "warm"):
            start = launch_counts()
            for i, q in enumerate(queries):
                t0 = time.perf_counter()
                if run == "cold":
                    pqs[i] = bloom.prepare(q)
                res[(run, i)] = bloom.execute_prepared(pqs[i])
                torch.cuda.synchronize()
                lat[run].append(time.perf_counter() - t0)
            by_run[run] = {k: v - start[k]
                           for k, v in launch_counts().items()}
        launches = read_launches("bloom", BLOOM_KERNELS)
    finally:
        engine_mod.bloom_prefilter = prefilter

    for i, q in enumerate(queries):
        cold = res[("cold", i)]
        check_rows(cold, g.num_nodes, q.num_nodes)
        if cold.result_set() != want[i].result_set():
            fail(f"bloom query {i}: the result differs from spath_ni2's")
        if res[("warm", i)].result_set() != cold.result_set():
            fail(f"bloom query {i}: warm result differs from cold")
        if cold.stats.candidates_after != want[i].stats.candidates_after:
            fail(f"bloom query {i}: candidates after the check differ")
    check_bloom = [res[("cold", i)].stats.check_time * 1e3
                   for i in range(N_BLOOM)]
    check_plain = [r.stats.check_time * 1e3 for r in want]
    emit({"phase": "bloom", "queries": N_BLOOM,
          "launches": {k: launches[k] for k in BLOOM_KERNELS},
          "launches_by_run": by_run,
          "prefilter_calls": len(removed),
          "prefilter_removed": sum(removed),
          "candidates_before": [r.stats.candidates_before for r in want],
          "candidates_after": [r.stats.candidates_after for r in want],
          "matches": [r.count for r in want],
          "check_ms_bloom": check_bloom, "check_ms_plain": check_plain,
          "check_ms_bloom_median": float(np.median(check_bloom)),
          "check_ms_plain_median": float(np.median(check_plain)),
          "p50_ms_cold": pct(lat["cold"], 50),
          "p50_ms_warm": pct(lat["warm"], 50),
          "latency_ms_cold": [x * 1e3 for x in lat["cold"]],
          "latency_ms_warm": [x * 1e3 for x in lat["warm"]]})
    return launches, by_run


N_PAIRS = 8192
CONN_CHUNK = 1024


def conn_phase(ds, conn) -> dict:
    """connectivity_mask_vectorized on the card over pairs of the main
    phase's connection edges: half from their result rows (connected),
    half random from their endpoint intervals; held against the host's
    per-pair connectivity_mask.  The intersect_any_ragged entry must
    launch exactly once per chunk of pairs and the padded entry never;
    the seconds are split by step (the function's `timings`)."""
    import numpy as np
    import torch
    from repro_torch.core import connectivity_mask, \
        connectivity_mask_vectorized
    from repro_torch.kernels import ops

    g, rng = ds.graph, np.random.default_rng(1)
    per = N_PAIRS // 2 // len(conn)
    reset_launches()
    t_dev = t_host = 0.0
    n_pairs, chunks, hits = 0, 0, {False: 0, True: 0}
    split = {}
    for q, r in conn:
        c = q.connections[0]
        iv = q.intervals(ds.idmap)
        rows = r.rows[rng.integers(0, r.count, per)] if r.count \
            else np.empty((0, q.num_nodes), np.int32)
        a = np.concatenate([rows[:, r.cols.index(c.src)],
                            rng.integers(iv[c.src, 0], iv[c.src, 1], per)])
        b = np.concatenate([rows[:, r.cols.index(c.dst)],
                            rng.integers(iv[c.dst, 0], iv[c.dst, 1], per)])
        for bi in (False, True):
            t0 = time.perf_counter()
            got = connectivity_mask_vectorized(g, ds.ni, a, b, c.max_dist,
                                               bi, chunk=CONN_CHUNK,
                                               device=DEVICE, timings=split)
            torch.cuda.synchronize()
            t_dev += time.perf_counter() - t0
            chunks += -(-len(a) // CONN_CHUNK) * (2 if bi else 1)
            t0 = time.perf_counter()
            want = connectivity_mask(g, ds.ni, a, b, c.max_dist, bi)
            t_host += time.perf_counter() - t0
            if not np.array_equal(got, want):
                fail(f"conn: {int((got != want).sum())} pairs differ from "
                     "the host's per-pair mask")
            if bi == c.bidirectional and not got[: len(rows)].all():
                fail("conn: a result row's endpoints are not connected")
            hits[bi] += int(got.sum())
        n_pairs += len(a)
    launches = read_launches("conn", CONN_KERNELS)
    by_entry = dict(ops.cuda_kernels()["intersect_any"].entry_launches)
    if by_entry != {"intersect_any": 0, "intersect_any_ragged": chunks}:
        fail(f"conn: expected {chunks} intersect_any_ragged launches, one "
             f"a chunk, and no padded one; got {by_entry}")
    steps = ("gather", "upload", "kernel", "fallback")
    emit({"phase": "conn", "pairs": n_pairs, "queries": len(conn),
          "launches": {k: launches[k] for k in CONN_KERNELS},
          "launches_by_entry": by_entry, "chunks": chunks,
          "hit_share": hits[False] / n_pairs,
          "hit_share_bidirectional": hits[True] / n_pairs,
          "seconds": t_dev, "host_mask_seconds": t_host,
          "seconds_split": {**{k: split.get(k, 0.0) for k in steps},
                            "rest": t_dev - sum(split.get(k, 0.0)
                                                for k in steps)},
          "fallback_pairs": split.get("fallback_pairs", 0)})
    return launches


def parity_phase(scale: float) -> None:
    from repro_torch.core import Dataset, Engine, EngineConfig
    from repro_torch.data import dblp_like, lubm_like, random_query
    bloom = dict(check_policy="always", use_bloom=True)
    for name, gen in (("lubm", lubm_like), ("dblp", dblp_like)):
        t0 = time.perf_counter()
        ds = Dataset.build(gen(scale=scale, seed=1))
        # (card engine, CPU engine, query of seed i) per configuration
        configs = {
            "rdf_h": (ds.engine("rdf_h", device=DEVICE),
                      ds.engine("rdf_h", device="cpu"),
                      lambda i: random_query(ds.graph, size=6, seed=100 + i,
                                             n_connection=int(i >= 4))),
            "bloom": (Engine(ds, EngineConfig(device=DEVICE, **bloom)),
                      Engine(ds, EngineConfig(device="cpu", **bloom)),
                      lambda i: random_query(ds.graph, size=6, seed=100 + i,
                                             exact_nodes=0.5))}
        counts = {}
        for cname, (gpu, cpu, query) in configs.items():
            counts[cname] = []
            for i in range(6):
                q = query(i)
                a, b = gpu.execute(q), cpu.execute(q)
                if a.result_set() != b.result_set():
                    fail(f"parity {name} {cname} query {i}: "
                         "card and CPU differ")
                counts[cname].append(a.count)
        emit({"phase": "parity", "dataset": name, "scale": scale,
              "triples": ds.num_edges, "matches": counts, "equal": True,
              "seconds": time.perf_counter() - t0})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=13.0,
                    help="lubm_like scale of the main path (13: ~1M triples)")
    ap.add_argument("--parity-scale", type=float, default=0.3)
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import torch
        import numpy as np
        from repro_torch.kernels import _build
        from repro_torch.core import Dataset
        from repro_torch.data import lubm_like
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA GPU")

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    g = lubm_like(scale=args.scale, seed=1)
    ds = Dataset.build(g)
    emit({"phase": "dataset", "name": "lubm_like", "scale": args.scale,
          "triples": g.num_edges, "nodes": g.num_nodes,
          "ni_gb": ds.ni.dense_bytes() / 2**30,
          "ni_caps": {str(k): e.cap for k, e in ds.ni.entries.items()},
          "seconds": time.perf_counter() - t0})

    rows = kernel_phase(ds, np.random.default_rng(0))
    main_launches, main_runs, conn, common, served = main_phase(ds,
                                                                N_QUERIES)
    rows += main_shape_rows(common)
    del common
    serve_phase(ds, served)
    del served
    bloom_launches, bloom_runs = bloom_phase(ds)
    conn_launches = conn_phase(ds, conn)
    # each kernel's launches come from the phase that runs its path, and
    # per cold and per warm execution where the path has both
    launches = {**{k: main_launches[k] for k in MAIN_KERNELS},
                **{k: bloom_launches[k] for k in BLOOM_KERNELS},
                **{k: conn_launches[k] for k in CONN_KERNELS}}
    per_run = {**{k: (main_runs, N_QUERIES) for k in MAIN_KERNELS},
               **{k: (bloom_runs, N_BLOOM) for k in BLOOM_KERNELS}}
    for row in rows:
        counter = row.pop("counter")
        row["launches"] = launches[counter]
        if counter in per_run:
            runs, n_exec = per_run[counter]
            for run in ("cold", "warm"):
                row[f"launches_per_{run}_execution"] = \
                    runs[run][counter] / n_exec
    del ds, conn
    parity_phase(args.parity_scale)

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
