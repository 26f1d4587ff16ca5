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
            events, host launch gaps included (call_ms)
  main      12 RDF-h queries (the last 4 with a connection edge) through
            Dataset.engine("rdf_h") -> Engine.execute on the card, cold
            then warm; every kernel must have launched during this phase,
            and every result must equal the same engine's on the CPU
  parity    lubm_like and dblp_like at scale 0.3: the card's result sets
            equal the CPU engine's, exactly

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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call under torch.profiler: the kernels and copies
    that fn puts on the card, without the host's launch gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(device_times(prof).values())
    if busy <= 0:
        fail("the profiler traced no device time")
    return busy / iters


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


# ---------------------------------------------------------------------- #
def kernel_phase(ds, rng) -> list:
    """Each kernel vs its plain version at the main path's shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import radix_join as krad
    from repro_torch.core.matching import _radix_bits

    dev = torch.device("cuda")
    out = []

    def record(name, src, replaces, fn, plain, lib, nbytes, nops, got, want):
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": replaces}
        row.update(compare(name, got, want))
        row["ms"] = row["kernel_ms"] = device_ms(fn)
        row["plain_ms"] = device_ms(plain)
        row["library_ms"] = None if lib is None else device_ms(lib)
        # the wrapper's time per call with the host's launch gaps
        row["call_ms"] = cuda_ms(fn)
        row["bound_ms"], row["bound_by"] = bound(nbytes, nops)
        out.append(row)

    # merge_probe: A = B = 2^20 sorted keys with duplicate runs and the
    # per-side invalid sentinels
    n = 1 << 20
    a = rng.integers(0, 1 << 18, n).astype(np.int32)
    b = rng.integers(0, 1 << 18, n).astype(np.int32)
    a[rng.random(n) < 0.05] = A_INVALID
    b[rng.random(n) < 0.05] = B_INVALID
    a = torch.as_tensor(np.sort(a), device=dev)
    b = torch.as_tensor(np.sort(b), device=dev)
    record("merge_probe", "merge_probe.cu",
           "src/repro/kernels/merge_probe.py:92",
           lambda: ops.merge_probe(a, b),
           lambda: ref.merge_probe_sorted(a, b),
           lambda: (torch.searchsorted(b, a, out_int32=True),
                    torch.searchsorted(b, a, right=True, out_int32=True)),
           4 * (3 * n + n), 2 * n * math.ceil(math.log2(n + 1)),
           ops.merge_probe(a, b), ref.merge_probe_sorted(a, b))

    # expand_segments: cap = 2^20 output slots over 2^20 running counts
    cnt = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32), device=dev)
    csum = torch.cumsum(cnt, 0, dtype=torch.int32)
    cap = 1 << 20
    t = torch.arange(cap, dtype=torch.int32, device=dev)
    record("expand_segments", "expand_segments.cu",
           "src/repro/kernels/fused_join.py:198",
           lambda: ops.expand_segments(csum, cap),
           lambda: ref.expand_segments_ref(csum, cap),
           lambda: torch.searchsorted(csum, t, right=True, out_int32=True),
           4 * (n + cap), cap * math.ceil(math.log2(n + 1)),
           (ops.expand_segments(csum, cap),),
           (ref.expand_segments_ref(csum, cap),))

    # window_probe: A = 2^20 probe rows against real radix-partitioned
    # bucket windows of Lmax = 16
    nb_rows, lmax = 1 << 16, 16
    b_keys = torch.as_tensor(rng.integers(0, 1 << 20, nb_rows)
                             .astype(np.int32), device=dev)
    b_rows = torch.stack([b_keys, torch.arange(nb_rows, dtype=torch.int32,
                                               device=dev)], dim=1)
    bits = _radix_bits(nb_rows)
    keys_p, _, edges, _ = krad.radix_partition(b_keys, b_rows, bits)
    probe = torch.as_tensor(rng.integers(0, 1 << 20, n).astype(np.int32),
                            device=dev)
    win, _ = krad.radix_window(probe, edges, keys_p, bits, lmax)
    record("window_probe", "window_probe.cu",
           "src/repro/kernels/radix_join.py:135",
           lambda: ops.radix_probe(probe, win),
           lambda: ref.window_probe_ref(probe, win),
           None, 4 * (n * lmax + 3 * n), 2 * n * lmax,
           ops.radix_probe(probe, win), ref.window_probe_ref(probe, win))

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
    record("interval_count", "interval_count.cu",
           "src/repro/kernels/interval_count.py:58",
           lambda: ops.interval_count(ids, lo, hi, cands=cands, lens=lens),
           lambda: ref.interval_count_gather_ref(ids, cands, lo, hi, lens),
           None, 8 * c + 4 * valid + 8 * j + 4 * c * j, 2 * j * searches,
           (ops.interval_count(ids, lo, hi, cands=cands, lens=lens),),
           (ref.interval_count_gather_ref(ids, cands, lo, hi, lens),))
    # the same kernel searching whole rows (no lens), timed in the same
    # run so the valid-prefix search is compared with it on one card
    compare("interval_count_full_rows",
            (ops.interval_count(ids, lo, hi, cands=cands),),
            (ref.interval_count_gather_ref(ids, cands, lo, hi),))
    def full_rows():
        return ops.interval_count(ids, lo, hi, cands=cands)
    emit({"phase": "interval_count_full_rows",
          "ms": device_ms(full_rows), "call_ms": cuda_ms(full_rows),
          "ms_valid_prefix": out[-1]["ms"],
          "call_ms_valid_prefix": out[-1]["call_ms"],
          "mean_row_len": valid / c})
    emit({"phase": "kernels", "cap": entry.cap,
          "shapes": {"merge_probe": [n, n], "expand_segments": [n, cap],
                     "window_probe": [n, lmax],
                     "interval_count": [c, entry.cap, j]}})
    del ids, lens
    torch.cuda.empty_cache()
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


def main_phase(ds, n_queries: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.data import random_query
    from repro_torch.kernels import ops

    g = ds.graph
    gpu = ds.engine("rdf_h")                       # device="cuda" default
    cpu = ds.engine("rdf_h", device="cpu")
    queries = [random_query(g, size=6, seed=100 + i,
                            n_connection=1 if i >= n_queries - 4 else 0)
               for i in range(n_queries)]
    kernels = ops.cuda_kernels()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    lat = {"cold": [], "warm": []}
    results = {}
    pqs = [None] * n_queries
    t_start = time.perf_counter()
    for run in ("cold", "warm"):
        t_run = time.perf_counter()
        for i, q in enumerate(queries):
            t0 = time.perf_counter()
            if run == "cold":                  # first sight: plan, then run
                pqs[i] = gpu.prepare(q)
            r = gpu.execute_prepared(pqs[i])   # rows come back to the host
            torch.cuda.synchronize()
            lat[run].append(time.perf_counter() - t0)
            results[(run, i)] = r
        lat[run + "_wall"] = time.perf_counter() - t_run
    wall = time.perf_counter() - t_start
    launches = {name: k.launches for name, k in kernels.items()}
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        fail(f"the main path launched no {missing} kernel")
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

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs) * 1e3, p))
    stats = [results[("cold", i)].stats for i in range(n_queries)]
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
        "launches_per_query": {k: v / (2 * n_queries)
                               for k, v in launches.items()},
        "wall_s": wall, "cpu_checked": list(cpu_checked),
        "cpu_check_s": cpu_check_s, "warm_profile": profile,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(summary)
    return launches


def parity_phase(scale: float) -> None:
    from repro_torch.core import Dataset
    from repro_torch.data import dblp_like, lubm_like, random_query
    for name, gen in (("lubm", lubm_like), ("dblp", dblp_like)):
        t0 = time.perf_counter()
        ds = Dataset.build(gen(scale=scale, seed=1))
        gpu, cpu = ds.engine("rdf_h"), ds.engine("rdf_h", device="cpu")
        counts = []
        for i in range(6):
            q = random_query(ds.graph, size=6, seed=100 + i,
                             n_connection=1 if i >= 4 else 0)
            a, b = gpu.execute(q), cpu.execute(q)
            if a.result_set() != b.result_set():
                fail(f"parity {name} query {i}: card and CPU differ")
            counts.append(a.count)
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
    launches = main_phase(ds, N_QUERIES)
    for row in rows:
        row["launches"] = launches[row["name"]]
    del ds
    parity_phase(args.parity_scale)

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
