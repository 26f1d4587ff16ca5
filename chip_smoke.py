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
            query node in one launch over 65,536 candidates, called as
            the engine calls it (the verdict in place in a row of a
            [Q, N] pass mask buffer, the passes on device counters, the
            segment words at an offset of one packed upload) and held,
            buffer and counters, to the plain version given the same;
            timed beside the chunked launch pattern (one count launch per
            chunk, direction and distance) as host time per node.  The row
            expand_gather is the join expand in one launch, timed beside
            the slot-map path (expand_segments + the PyTorch gather) and the
            library composition (torch.searchsorted + the gather);
            merge_probe and expand_gather are also timed with L2 flushed
            between calls (ms_l2_flushed).  intersect_any has a row for
            each entry: the padded rows of reach_sets, and
            intersect_any_ragged on the ragged rows of the conn path's
            gather at P = 1,024 and at P = 65,536, the second also timed
            with L2 flushed.  row_select has two rows, a count launch and
            a compaction launch each: the edge scan of one D-tree edge
            (row_select_edges) and the injective filter of a 2^20 x 6
            table (row_select_distinct)
  main      12 RDF-h queries (the last 4 with a connection edge) through
            Dataset.engine("rdf_h") -> Engine.execute on the card, cold
            then warm; each of the five kernels of this path must have
            launched during this phase, the check must launch
            interval_count at most once per call cold and never warm,
            every join expand must be exactly one expand_segments
            launch, and the results of the first and the last template
            must equal the CPU engine's on the same Dataset, run after
            the timed rounds;
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
  delta     live deltas through QueryServer.apply_delta at full size: a
            server warmed with one round of the 12 templates absorbs the
            delta of examples/serve_queries.py (about num_edges / 200
            deletes and the recombined inserts, incremental), then a
            no-op delta that carries every NI tensor; after each, one
            round whose results equal a fresh card engine's (its own cold
            run for complete results, its run of the server's plan for
            every result) and every carried device-cache tensor equals a
            fresh upload; prints the delta's info, the carried and
            re-uploaded keys and the migrated round's time against the
            fresh engine's cold round
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
  distributed
            repro_torch.core.distributed over an NCCL group of one rank:
            shard_check on the NI entry with the largest cap (every row,
            about 177,342 x 4,096 ids) must equal ref.interval_count_ref
            over the same rows, computed in chunks on the card, and launch
            the interval_count entry of interval_count.cu (row
            interval_count_shard times it at this shape);
            gather_candidates must return the mask's first candidates;
            both are timed
  governed  governed serving on the card at lubm_like(scale=1): the
            force_simple_impls rung runs nested joins and cross-product
            connection edges, quadratic at full size.  A deadline below
            the connection templates' primary time, admission control
            that sheds part of a batch with RejectedError, a persistent
            join_expand fault that drives the ladder past the first retry
            and a template that fails at every rung until the breaker
            quarantines it; every future exact (to an ungoverned card
            engine), the truncate rung's (within its row cap) or its own
            typed error, and the fault's and breaker's counters equal to
            the CPU port's run of the same scenario
  delta_rebuild
            every path of apply_delta on the full NI variant, one delta
            after another through one server at the governed phase's
            scale: the rebuilds for a new label, a literal as a subject
            (node-kind), churn above churn_threshold and a dropped label,
            each carrying no device tensor, then an incremental delta
            whose deletes name triples the graph lacks and whose inserts
            repeat triples it holds; each step's mode and reason the ones
            it aimed at; its graph's triples in edge order, labels,
            predicates and node kinds those of a triple list kept in
            plain Python (every copy of each delete dropped, the inserts
            appended), and its digest that of Dataset.from_triples on
            that list; every result of the round after it equal to a
            fresh card engine's; one line a step
  parity    lubm_like and dblp_like at scale 0.3: the card's result sets
            equal the CPU engine's, exactly, for rdf_h and for the bloom
            configuration
  examples  python -m repro_torch.examples.quickstart and serve_queries
            --governed --chaos --delta --snapshot PATH, in this process on
            the card at their default scales, and train_lm (30 steps,
            --ckpt-every 10, then again with --resume: the final losses
            within 1e-3 relative); any exception fails
  lm        the LM scaffold's serving path (repro_torch.models; plain
            PyTorch, no hand kernel: the phase fails if one launches),
            weights from a torch.Generator seeded 0 on the card:
            (a) qwen2-0.5b at full width and depth (bf16 activations,
            fp32 master weights), 8 prompts of 2,048 tokens from
            concrete_batch and 32 greedy decode steps; (b) one prompt of
            32,768 tokens (PREFILL_32K's length) and 8 steps, its time to
            first token; (c) the same weights in fp32, TF32 off, on the
            card against the port on the CPU, 2 x 128 tokens and 2 steps
            (on (a)'s line), the logits and every cache leaf within
            1e-3·max(1, max|ref|);
            (d) stablelm-1.6b, starcoder2-15b, minitron-8b,
            granite-moe-1b-a400m (capacity_factor 16), paligemma-3b
            (256 patches + 512 tokens), hymba-1.5b (2 x 2,400 tokens: the
            ring wraps) and rwkv6-7b at full width, 2 blocks deep, 2 x 512
            tokens and 4 steps, each with (c)'s check at 1 x 64; (e)
            hubert-xlarge (an encoder: prefill only) likewise and
            llama4-maverick-400b-a17b at reduced_config.  Decode is held
            to a prefill of the tokens fed, after the first and the last
            step (lm_decode_checks: fp32 under tests/test_models.py's
            2e-2·max(max|ref|, 1); bf16 under fixed limits, the step 4e-2
            and the bf16 prefill 5e-2 from an fp32 one, with both steps
            run again in fp32 under the 2e-2 criterion); (a) also holds
            nn_ops.matmul_f32's bf16 products with an fp32 result to the
            widened product at its five shapes.  Prints per config the
            parameter count, prefill tokens/s, decode ms per step and
            tokens/s, the peak memory, the errors, the per-call cast's
            share of a step and the device's busy share of a step
            (torch.profiler)
  train     the LM scaffold's training path (repro_torch.models' loss and
            train step, optim, checkpoint, data; plain PyTorch, no hand
            kernel: the phase fails if one launches), weights from a
            torch.Generator seeded 0 on the card: (a) qwen2-0.5b at full
            width and depth, bf16 activations over fp32 masters,
            TrainConfig(grad_dtype="bfloat16", microbatch=4, remat=True),
            3 steps (the first a warm-up) of 16 x 4,096 tokens from
            TokenPipeline (train_4k's length; its global batch of 256 cut
            to 16 for time), each loss and grad_norm finite; prints
            seconds a step, tokens/s, the step's FLOPs (4x the forward:
            the recompute and the backward; attention masked, not
            skipped; the loss head; beside them the work the step needs:
            no recompute, causal pairs only) and their bounds at 989
            TFLOP/s, the model-FLOPs (6·N·D) share of peak and the peak
            memory; one more step of (a) split by part on the device
            (CUDA events where attention, the loss head and the
            optimizer begin and end, in the forward pass, the recompute
            and the backward pass); and, on one microbatch's rows as a
            step of its own, a step with the blocks indexed one by one
            in place of unbind (the trunk's way before
            transformer.unstack) between two with unbind, and that
            microbatch step's busy share and top kernels under
            torch.profiler; (b) 8 steps on one
            fixed 2 x 512 batch (lr 1e-3, warm-up 1): the loss must fall;
            (c) fp32, TF32 off, card against the port on the CPU at
            2 x 128: loss within 1e-5, grad_norm 1e-4 (relative), every
            gradient leaf within 1e-4·max|ref leaf|; matmul_f32's
            backward (bf16) at (a)'s attention and loss-head products
            against widened fp32 autograd, within one bf16 ulp of
            max|ref|; the parts' times (one layer's attention, the loss
            head, the optimizer); (d) stablelm, starcoder2, minitron,
            granite-moe (capacity_factor 16), paligemma (256 patches),
            hymba, rwkv6 and hubert (its mask) at full width, 2 blocks
            deep, and llama4 at reduced_config: one step of 2 x 512 with
            microbatch 2 and fp32 gradients, a finite loss and parameters
            that moved; (e) (a)'s params and AdamW state saved by the
            Checkpointer asynchronously, a step taken (in place), and
            restored onto the card: every leaf equal bit for bit, and a
            step from the restored state equal to the same step from the
            in-memory state as closely as two in-memory runs of it are
            (deterministic algorithms on: bit for bit where they are)
  mesh      the LM scaffold's mesh path (repro_torch.launch.mesh,
            models.api with mesh=, runtime.elastic; DTensor, no hand
            kernel: the phase fails if one launches) over an NCCL world
            of one rank on make_local_mesh(), qwen2-0.5b at full width
            and depth placed by reshard(..., model_pspecs): the train
            phase's step (16 x 4,096, microbatch 4, bf16 gradients,
            remat) through make_train_step(cfg, tcfg, mesh) against the
            unmeshed step from the same state and batch (loss 1e-4 and
            grad_norm 1e-3 relative, every parameter within 4·lr, each
            leaf's update p - p0 within 0.5 of the unmeshed one's norm
            (a lost update reads 1), AdamW's m and v within 4 bf16 ulps
            of each leaf's max), a
            second meshed step timed with its peak memory; elastic: a
            checkpoint of the meshed state, a step on one microbatch's
            rows, run_with_retries over that step whose first attempt
            raises, on_failure restoring the checkpoint with
            restore(shardings=), the replayed loss within 1e-4 of the
            original.  Before the train step a prefill of 8 x 2,048
            and 4 decode steps
            through the meshed functions against the unmeshed ones
            (1e-2·max(1, max|ref|)); each timed beside the unmeshed
  dryrun    repro_torch.launch.dryrun on the host (a fake process group,
            meta DTensors): (1) qwen2-0.5b at the mesh phase's step on
            a (1, 1) mesh, its counted FLOPs within 2 % of train_flops'
            step_flop_remat, and that formula within 2 % of the
            products a 1 x 4,096 step of qwen2-0.5b cut to 4 blocks
            ran on the card (torch.profiler's
            aten::mm / aten::bmm calls that launched a kernel, with
            their shapes), its
            predicted peak beside the mesh step's measured one and its
            roofline time beside the measured step;
            (2) qwen2-0.5b and llama4-maverick-400b-a17b train_4k on the
            (16, 16) production mesh at full width, each ok, with peak
            GiB, FLOPs, collectives by kind (and split by issuer) and the
            roofline's terms (traced by `python -m
            repro_torch.launch.dryrun` in processes
            of their own at the lowest priority, started before the
            train phase, whose steps the card runs meanwhile: they need
            the host only, and they are done before the mesh phase); (3) the RDF-h check cell on that mesh (traced
            likewise), and one device's shard
            of it on the card (262,144 x 256 ids, J = 8) through the
            interval_count entry of interval_count.cu, exactly equal to
            its plain version: the kernel row interval_count_rdfh_shard,
            beside the cell's memory term
  seconds   each phase's wall seconds

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
import tempfile
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
                "interval_count", "row_select")
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
               counter="interval_count_entry",
               yardsticks={"full_rows_ms": full_rows})
    emit({"phase": "interval_count_full_rows",
          "ms": out[-1]["full_rows_ms"], "call_ms": cuda_ms(full_rows),
          "ms_valid_prefix": out[-1]["ms"],
          "call_ms_valid_prefix": out[-1]["call_ms"],
          "mean_row_len": valid / c})
    del ids, lens
    torch.cuda.empty_cache()

    nn_cand = record_node_check(out, ds, rng, j, dev)


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
    record_row_select(out, ds, rng, dev)
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


def record_node_check(out, ds, rng, j: int, dev) -> int:
    """The row interval_count_node_check: the whole check of one query
    node in one launch (both directions, distances 1 and 2, J = j) over
    65,536 contiguous candidate nodes of the real NI entries, called as
    the engine's check_template calls it: the verdict written in place into
    row 1 of a zeroed [2, N] pass mask buffer, the passes and the passes
    with an overflowed row added to the row's device counters, and the
    segment words read at an offset of one packed upload.  Held to the
    plain version with the same out and tally: the whole buffer (row 0
    and the columns outside lo..hi stay false) and the counters.  The
    bound counts each candidate's stored prefix in each segment once,
    its length and overflow bit, and the ok byte.  Returns the number of
    candidates."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    nn = ds.graph.num_nodes
    segs, host_over = node_check_segments(ds, rng, j, dev)
    nn_cand = min(1 << 16, nn)
    c_lo = (nn - nn_cand) // 2
    c_hi = c_lo + nn_cand
    prefix = sum(int(s.lens[c_lo:c_hi].sum()) for s in segs)
    data_at = 7             # the words of an earlier node come first
    data = ops.upload(np.concatenate([rng.integers(0, nn, data_at),
                                      ops.check_words(segs)]), dev)
    rows = torch.zeros((2, nn), dtype=torch.bool, device=dev)
    tally = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    plain_rows = torch.zeros((2, nn), dtype=torch.bool, device=dev)
    plain_tally = torch.zeros((2, 3), dtype=torch.int32, device=dev)

    def node_check():
        return ops.interval_check(segs, c_lo, c_hi, out=rows[1],
                                  tally=tally[1, :2], data=data,
                                  data_at=data_at)

    def node_check_plain():
        return ref.interval_check_ref(segs, c_lo, c_hi, out=plain_rows[1],
                                      tally=plain_tally[1, :2])
    node_check()
    node_check_plain()
    if rows[:, :c_lo].any() or rows[:, c_hi:].any() or rows[0].any():
        fail("interval_count_node_check: the launch wrote outside its "
             "row's columns lo..hi")
    if int(tally[1, 0]) != int(rows[1].sum()):
        fail(f"interval_count_node_check: {int(tally[1, 0])} passes "
             f"counted, {int(rows[1].sum())} in the row")
    node_ok = (rows.clone(), tally.clone())
    record_row(out, "interval_count_node_check", "interval_count.cu",
               "src/repro/kernels/interval_count.py:58",
               node_check, node_check_plain,
               None, 4 * prefix + 5 * len(segs) * nn_cand + nn_cand,
               2 * j * prefix, node_ok, (plain_rows.clone(),
                                         plain_tally.clone()),
               counter="interval_count")
    # beside it, host wall time per node of the one launch with its copy
    # back, and of the chunked pattern on the same inputs: a count launch
    # per 8,192-candidate chunk, direction and distance, each copied back
    new_s, old_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = node_check().cpu().numpy()
        new_s.append(time.perf_counter() - t0)
        before = ops.cuda_kernels()["interval_count"].launches
        t0 = time.perf_counter()
        old = chunked_check(segs, host_over, c_lo, c_hi)
        old_s.append(time.perf_counter() - t0)
        old_launches = ops.cuda_kernels()["interval_count"].launches - before
        if not np.array_equal(got, old):
            fail("interval_count_node_check: the one-launch verdict differs "
                 "from the chunked launch pattern's")
    over_any = np.zeros(nn_cand, dtype=bool)
    for o in host_over:
        over_any |= o[c_lo:c_hi]
    if int(node_ok[1][1, 1]) != int((got & over_any).sum()):
        fail("interval_count_node_check: the device's overflow_passed "
             "differs from the host's count")
    emit({"phase": "interval_count_node_check", "candidates": nn_cand,
          "first": c_lo, "segments": len(segs), "j": j,
          "stored_ids": prefix, "pass_share": float(got.mean()),
          "passed": int(node_ok[1][1, 0]),
          "overflow_passed": int(node_ok[1][1, 1]),
          "rows_over_32_ids": [int((s.lens[c_lo:c_hi] > 32).sum())
                               for s in segs],
          "host_ms_per_node": float(np.median(new_s)) * 1e3,
          "host_ms_per_node_chunked": float(np.median(old_s)) * 1e3,
          "launches_per_node_chunked": old_launches})
    del segs, node_ok, rows, plain_rows, data
    torch.cuda.empty_cache()
    return nn_cand


def record_row_select(out, ds, rng, dev) -> None:
    """The two row_select rows, each a count launch and a compaction launch
    at the engine's capacity against the plain composition on the card:
    row_select_edges, the edge scan of one D-tree edge over the graph's
    edges (the commonest predicate, a mask on the source and an interval
    on the target, the two forms the main path passes), and
    row_select_distinct, the injective filter of a 2^20 x 6 table (the
    size at which a join is cut) whose last column repeats the first's
    query node, 1 % padding rows among the others.  Bytes: what the
    inputs need (the predicate of every edge, the ends and the source's
    mask byte of the edges with that predicate; every row), the keep
    bitmap written and read, the kept items read and the output written."""
    import numpy as np
    import torch
    from repro_torch.core.matching import _pow2, graph_edges
    from repro_torch.kernels import ops, row_select as rsel

    src, dst, pred = graph_edges(ds.graph, dev)
    n_nodes, e = ds.graph.num_nodes, int(src.shape[0])
    pred_id = int(np.bincount(ds.graph.pred).argmax())
    n_pred = int((ds.graph.pred == pred_id).sum())
    mask = torch.as_tensor(rng.random(n_nodes) < 0.5, device=dev)
    iv = (0, n_nodes // 2)
    kept = int(rsel.edge_select_ref(src, dst, pred, pred_id, mask, iv,
                                    False).total)
    cap = _pow2(kept)

    def edges():
        return ops.edge_select(src, dst, pred, pred_id, mask, iv).rows(cap)

    def edges_plain():
        return rsel.edge_select_ref(src, dst, pred, pred_id, mask, iv,
                                    False).rows(cap)
    row = record_row(out, "row_select_edges", "row_select.cu",
                     "none: jnp ops of src/repro/core/matching.py:edge_pairs",
                     edges, edges_plain, None,
                     4 * e + 9 * n_pred + e // 4 + 8 * (kept + cap),
                     e + 3 * n_pred, (edges(),), (edges_plain(),),
                     counter="row_select")
    row["shape"] = {"edges": e, "with_pred": n_pred, "kept": kept,
                    "cap": cap}

    n, cols = 1 << 20, (1, 2, 3, 4, 5, 1)
    host = rng.integers(0, 64, (n, 6)).astype(np.int32)
    host[:, 5] = host[:, 0]
    host[rng.random(n) < 0.01] = -1
    rows = torch.as_tensor(host, device=dev)
    pairs = tuple((i, j) for i in range(6) for j in range(i + 1, 6)
                  if cols[i] != cols[j])
    kept = int(rsel.distinct_select_ref(rows, pairs).total)
    cap = _pow2(kept)

    def distinct():
        return ops.distinct_select(rows, pairs).rows(cap)

    def distinct_plain():
        return rsel.distinct_select_ref(rows, pairs).rows(cap)
    row = record_row(out, "row_select_distinct", "row_select.cu",
                     "none: jnp ops of src/repro/core/matching.py:"
                     "injective_filter", distinct, distinct_plain, None,
                     24 * n + n // 4 + 24 * (kept + cap), len(pairs) * n,
                     (distinct(),), (distinct_plain(),),
                     counter="row_select")
    row["shape"] = {"rows": n, "k": 6, "pairs": len(pairs), "kept": kept,
                    "cap": cap}


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
    the engine's check builds them: forward then backward,
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
    import repro_torch.core.matching as matching
    from repro_torch.data import random_query
    from repro_torch.kernels import fused_join, ops

    g = ds.graph
    gpu = ds.engine("rdf_h", device=DEVICE)
    queries = [random_query(g, size=6, seed=100 + i,
                            n_connection=1 if i >= n_queries - 4 else 0)
               for i in range(n_queries)]

    # read-only taps for this phase: the node checks (ops.interval_check,
    # one a checked query node) that launched, the shapes of every radix join (a.cap, b.count from
    # the join, bits and lmax from its probe), of every sort-merge probe
    # and of every join expand, whose expand_segments-counter launches
    # are counted call by call
    counter = ops.cuda_kernels()["interval_count"]
    expand_counter = ops.cuda_kernels()["expand_segments"]
    checks = {"calls": 0, "launched": 0}
    radix, probes, expands = [], [], []
    inputs = {"probe": {}, "expand": {}}     # first inputs of each shape
    check, join_radix, probe = (ops.interval_check, matching._join_radix,
                                ops.radix_probe)
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
    ops.interval_check = tap_check
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
        ops.interval_check = check
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

    # correctness, after the timed rounds: shape and id range, warm ==
    # cold, and — for the first query and the last (a connection edge
    # through the reach-join), the CPU engine being slow at full size —
    # the card's results equal the CPU engine's on the same Dataset (the
    # parity phase compares every query shape at a small scale)
    cpu_checked = (0, n_queries - 1)
    for i, q in enumerate(queries):
        cold, warm = results[("cold", i)], results[("warm", i)]
        check_rows(cold, g.num_nodes, q.num_nodes)
        if result_digest(warm) != result_digest(cold):
            fail(f"query {i}: warm result differs from cold")
    t0 = time.perf_counter()
    cpu = ds.engine("rdf_h", device="cpu")
    for i in cpu_checked:
        if result_digest(cpu.execute(queries[i])) != \
                result_digest(results[("cold", i)]):
            fail(f"query {i}: the card's result differs from the CPU's")
    del cpu
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
    the columns in query-node order, sorted, hashed, and the row count.
    The rows are sorted and deduplicated on the card: torch.unique takes
    milliseconds there for a million rows that np.unique takes over a
    second for on the host."""
    import hashlib
    import numpy as np
    import torch
    rows = np.ascontiguousarray(
        np.asarray(res.rows)[:, np.argsort(res.cols)], dtype=np.int32)
    if len(rows):
        rows = torch.unique(torch.from_numpy(rows).to(DEVICE),
                            dim=0).cpu().numpy()
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
            fail(f"serve {where}: a result differs from its reference")
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
        if result_digest(cold) != result_digest(want[i]):
            fail(f"bloom query {i}: the result differs from spath_ni2's")
        if result_digest(res[("warm", i)]) != result_digest(cold):
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


# ---------------------------------------------------------------------- #
# distributed: core.distributed over NCCL in a world of one
# ---------------------------------------------------------------------- #
DIST_CAP = 1 << 16          # gather_candidates' per-shard candidate cap
DIST_CHUNK = 8192           # rows per chunk of the plain reference


def distributed_phase(ds, query, rows: list) -> dict:
    """shard_check and gather_candidates (repro_torch.core.distributed)
    over an NCCL process group of one rank, on the NI entry with the
    largest cap at full size and the keyword intervals of one main-phase
    template; the mask is held to ref.interval_count_ref over the same
    rows, computed in chunks on the card, and shard_check must have
    launched the interval_count entry of interval_count.cu."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import gather_candidates, shard_check
    from repro_torch.kernels import ops, ref

    key = max(ds.ni.entries, key=lambda k: (ds.ni.entries[k].cap, k))
    e = ds.ni.entries[key]
    iv = query.intervals(ds.idmap)
    lo = np.ascontiguousarray(iv[:, 0], np.int32)
    hi = np.ascontiguousarray(iv[:, 1], np.int32)
    need = np.zeros(len(lo), np.int32)
    need[0] = 1                         # the first keyword within one hop
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            reset_launches()
            t0 = time.perf_counter()
            mask = shard_check(e.ids, lo, hi, need, e.overflow,
                               device=DEVICE)
            t_check = time.perf_counter() - t0
            entry = dict(ops.cuda_kernels()["interval_count"].entry_launches)
            t0 = time.perf_counter()
            cands = gather_candidates(mask, DIST_CAP, device=DEVICE)
            t_gather = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    if entry["interval_count"] == 0:
        fail("distributed: shard_check launched no interval_count entry")
    # the plain version over the same rows, in chunks on the card
    lo_t, hi_t, need_t = (torch.as_tensor(x, device=DEVICE)
                          for x in (lo, hi, need))
    want = np.empty(len(mask), bool)
    for s in range(0, len(mask), DIST_CHUNK):
        chunk = torch.as_tensor(e.ids[s:s + DIST_CHUNK], device=DEVICE)
        cnt = ref.interval_count_ref(chunk, lo_t, hi_t)
        ok = (cnt >= need_t[None, :]).all(1).cpu().numpy()
        want[s:s + DIST_CHUNK] = ok | e.overflow[s:s + DIST_CHUNK]
    if mask.shape != want.shape or not np.array_equal(mask, want):
        fail(f"distributed: {int((mask != want).sum())} of {len(want)} "
             "rows of the mask differ from the plain version")
    if not np.array_equal(cands, np.flatnonzero(want)[:DIST_CAP]):
        fail("distributed: gather_candidates differs from the mask's "
             "first candidates")
    # the interval_count entry at this path's shape: every row of the
    # entry, whole rows searched (shard_check passes no stored lengths);
    # the bound counts the stored ids, each read once
    ids = torch.as_tensor(e.ids, device=DEVICE)
    stored = int(np.minimum(e.count, e.cap).sum())
    n, j = ids.shape[0], len(lo)
    record_row(rows, "interval_count_shard", "interval_count.cu",
               "src/repro/kernels/interval_count.py:58",
               lambda: ops.interval_count(ids, lo_t, hi_t),
               lambda: ref.interval_count_ref(ids, lo_t, hi_t), None,
               4 * stored + 8 * j + 4 * n * j,
               2 * j * n * math.ceil(math.log2(e.cap + 1)),
               (ops.interval_count(ids, lo_t, hi_t),),
               (ref.interval_count_ref(ids, lo_t, hi_t),),
               counter="interval_count_entry")
    rows[-1]["shape"] = {"rows": n, "cap": int(e.cap), "intervals": j,
                         "stored_ids": stored}
    del ids
    torch.cuda.empty_cache()
    emit({"phase": "distributed", "backend": "nccl", "world_size": 1,
          "entry": key, "rows": int(e.ids.shape[0]), "cap": int(e.cap),
          "ids_gb": e.ids.nbytes / 2**30, "intervals": len(lo),
          "passed": int(mask.sum()), "candidates": int(len(cands)),
          "gather_cap": DIST_CAP, "entry_launches": entry,
          "shard_check_s": t_check, "gather_candidates_s": t_gather,
          "equal": True, "seconds": time.perf_counter() - t_phase})
    return entry


# ---------------------------------------------------------------------- #
# delta: QueryServer.apply_delta with the device tensor cache migrated
# ---------------------------------------------------------------------- #
def engine_round(eng, queries) -> tuple:
    """Every template cold through `eng`: its results and the round's
    wall time (host clock, ending in a synchronize)."""
    import torch
    t0 = time.perf_counter()
    results = [eng.execute(q) for q in queries]
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def carried_equal(eng, keys) -> None:
    """Each device-cache entry of `eng` in `keys` against a fresh upload
    of the same entry from eng's dataset (Engine.upload); fails on any
    difference."""
    import torch
    for key in keys:
        kept, fresh = eng._dev_cache[key], eng.upload(key)
        kept = kept if isinstance(kept, tuple) else (kept,)
        fresh = fresh if isinstance(fresh, tuple) else (fresh,)
        if len(kept) != len(fresh) or not all(
                a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b) for a, b in zip(kept, fresh)):
            fail(f"delta: the carried device tensor {key!r} differs from a "
                 "fresh upload of the new dataset")
        del kept, fresh


def delta_step(srv, queries, inserts, deletes, where: str,
               churn_threshold: float = 0.05) -> dict:
    """srv.apply_delta, then one round of `queries` on the migrated server.
    Every result is held to a fresh card engine built on srv.dataset with
    an empty device cache: a complete result to that engine's own cold
    run, a truncated one to that engine's execution of the server's plan
    for the template (a result cut at max_rows keeps rows in its plan's
    order, and a plan the delta kept may order joins by the old
    statistics); every carried device-cache entry is held to a fresh
    upload."""
    import copy
    import torch
    from repro_torch.serve.plan_cache import canonicalize, remap_result

    t0 = time.perf_counter()
    info = srv.apply_delta(inserts, deletes, churn_threshold=churn_threshold)
    t_delta = time.perf_counter() - t0
    carried = list(srv.engine._dev_cache)
    start = launch_counts()
    t0 = time.perf_counter()
    futures = srv.submit_many(queries)
    srv.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - start[k] for k, v in launch_counts().items()}
    got = []
    for f, q in zip(futures, queries):
        res = f.result()
        check_rows(res, srv.dataset.num_nodes, q.num_nodes)
        got.append(res)
    reuploaded = [k for k in srv.engine._dev_cache if k not in carried]
    t0 = time.perf_counter()
    carried_equal(srv.engine, carried)
    t_carried = time.perf_counter() - t0

    fresh = srv.dataset.engine("rdf_h", device=DEVICE)
    if fresh._dev_cache:
        fail("delta: a fresh engine started with a device cache")
    cold, fresh_wall = engine_round(fresh, queries)
    complete = 0
    for i, (q, res, ref_res) in enumerate(zip(queries, got, cold)):
        if not res.stats.truncated:
            complete += 1
            if ref_res.stats.truncated or \
                    result_digest(res) != result_digest(ref_res):
                fail(f"delta {where}: template {i} differs from a fresh "
                     "engine's cold run")
            continue
        _, order, fp = canonicalize(q)
        pq = srv.plan_cache.peek(srv.dataset_id, fp)
        if pq is None:
            fail(f"delta {where}: template {i} has no plan after its round")
        same = remap_result(fresh.execute_prepared(copy.deepcopy(pq)), order)
        if result_digest(same) != result_digest(res):
            fail(f"delta {where}: template {i} differs from a fresh "
                 "engine's run of the server's plan")
    del fresh, cold
    torch.cuda.empty_cache()
    return {"where": where, "info": info, "delta_s": t_delta,
            "carried": [str(k) for k in carried],
            "reuploaded": [str(k) for k in reuploaded],
            "carried_check_s": t_carried,
            "migrated_round_s": wall, "fresh_cold_round_s": fresh_wall,
            "complete_templates": complete, "launches": launches}


def delta_phase(ds, served) -> dict:
    """Live deltas on the card at full size: a QueryServer warmed with one
    round of the main phase's templates absorbs the delta that
    examples/serve_queries.py builds (about num_edges / 200 deletes and
    the recombined inserts, incremental at this size), then a delete of
    a triple the graph does not hold (incremental, no row changes: every
    NI tensor and the bloom signatures stay on the card); each followed by
    a round held to a fresh card engine (delta_step)."""
    import torch
    from repro_torch.examples.serve_queries import delta_triples
    from repro_torch.serve import QueryServer

    queries = served["queries"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    reset_launches()
    srv = QueryServer(ds, "rdf_h", calibrate=False, device=DEVICE)
    warm = serve_round(srv, queries, served["digests"], "delta warm-up")
    inserts, deletes = delta_triples(ds.graph, 0)
    steps = [delta_step(srv, queries, inserts, deletes, "incremental")]
    if steps[0]["info"]["mode"] != "incremental":
        fail(f"delta: the full-size delta took the {steps[0]['info']} path")
    # every NI entry resident, so the no-op delta has each one to carry
    for key in [(s, d) for s in (1, -1) for d in range(1, ds.ni.d_max + 1)]:
        if key not in srv.engine._dev_cache:
            srv.engine._dev_cache[key] = srv.engine.upload(key)
    resident = {str(k) for k in srv.engine._dev_cache if k != "edges"}
    steps.append(delta_step(srv, queries, [],
                            [("no/such", "no/such", "no/such")], "no-op"))
    noop = steps[1]
    if noop["info"]["mode"] != "incremental" or \
            set(noop["carried"]) != resident:
        fail(f"delta: the no-op delta carried {noop['carried']}, not "
             f"{sorted(resident)}")
    launches = read_launches("delta", MAIN_KERNELS)
    del srv
    torch.cuda.empty_cache()
    out = {"phase": "delta", "dataset": "lubm_like", "triples":
           ds.num_edges, "inserts": len(inserts), "deletes": len(deletes),
           "warm_up_round_s": warm["wall_s"], "steps": steps,
           "launches": launches,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 2**30, "seconds": time.perf_counter() - t_phase}
    emit(out)
    return launches


# ---------------------------------------------------------------------- #
# governed: budgets, admission, the ladder and the breaker on the card
# ---------------------------------------------------------------------- #
# force_simple_impls (nested joins, cross-product connection edges) is
# quadratic; at lubm_like(scale=1) the rung answers every template within
# seconds (the slowest, 4 and 7, took 91 and 10 s on a CPU)
GOV_SCALE = 1.0
GOV_TEMPLATES = range(10)           # 10 and 11 are truncated at this scale
GOV_FAULT = ("join_expand", (1, 5, 6))      # point, templates
GOV_BREAKER = ("cache_lookup", 8)           # point, template
GOV_ADMIT = (4, range(8))           # max_pending, templates of one batch


def gov_outcome(f, truth, cap: int) -> tuple:
    """An exact result (equal to the ungoverned engine's), a result of
    the truncate rung (at most `cap` rows, each a row of the exact
    result), or the future's typed error; fails on anything else."""
    from repro_torch.serve import ServingError
    try:
        res = f.result()
    except ServingError as e:
        cause = e.__cause__
        return ("error", type(e).__name__,
                None if cause is None else type(cause).__name__)
    if res.stats.truncated:
        if "truncate" not in res.stats.degraded_steps or res.count > cap \
                or not res.result_set() <= truth.result_set():
            fail(f"governed: a truncated result ({res.count} rows, steps "
                 f"{res.stats.degraded_steps}) is not the truncate rung's")
        return ("truncated", res.count, tuple(res.stats.degraded_steps))
    if res.result_set() != truth.result_set():
        fail("governed: a result differs from the ungoverned engine's")
    return ("ok", res.count, tuple(res.stats.degraded_steps))


def gov_view(srv) -> dict:
    """The governor's counters that no clock moves in these scenarios."""
    g = srv.telemetry()["governor"]
    out = {k: g[k] for k in ("shed_submit", "shed_flush", "budget_exceeded",
                             "degraded_queries", "degraded_by_rung",
                             "exhausted", "transient_retries",
                             "transient_recoveries", "ladder_entries")}
    out["breaker"] = {k: g["breaker"][k] for k in
                      ("trips", "denials", "probes", "recoveries", "open")}
    rm = g["rung_memory"]
    out["rung_memory"] = None if rm is None else {
        k: rm[k] for k in ("hits", "jumps", "probes", "probe_recoveries",
                           "probe_failures", "chronic")}
    return out


def forcing_cfg(point: str, device: str):
    """The chaos suite's engine config: every join a staged sort-merge
    join (through the expand and probe seams), every connection edge a
    reach-join."""
    from repro_torch.core import EngineConfig, Thresholds
    return EngineConfig(check_policy="selective", d_check=2,
                        thresholds=Thresholds(nested_join_max=1),
                        join_impl="sorted", fuse_joins=False,
                        connection_impl="reach", device=device)


def fault_scenario(ds, queries, idx, device: str) -> dict:
    """A persistent `raise` at GOV_FAULT's point on every call, after a
    warm pass: each template walks the ladder past the first retry."""
    from repro_torch.serve import GovernorConfig, QueryServer
    from repro_torch.testing import Fault, FaultInjector
    point, _ = GOV_FAULT
    srv = QueryServer(ds, cfg=forcing_cfg(point, device), calibrate=False,
                      governor=GovernorConfig(retry_backoff_s=0.001))
    sub = [queries[i] for i in idx]
    for f in srv.submit_many(sub, wait=True):
        f.result()
    with FaultInjector(Fault(point, "raise", every=1)) as fi:
        futs = srv.submit_many(sub, wait=True)
        results = [f.result() for f in futs]
    return {"results": results, "calls": dict(fi.calls),
            "fired": len(fi.fired), "governor": gov_view(srv)}


def breaker_scenario(ds, query, device: str) -> dict:
    """A template that fails at every rung (`raise` at GOV_BREAKER's
    point on every call) until the breaker quarantines it; after the
    fault clears and the cooldown passes, one probe closes it again."""
    from repro_torch.serve import GovernorConfig, QueryServer
    from repro_torch.testing import Fault, FaultInjector
    from repro_torch.serve import ServingError
    point, _ = GOV_BREAKER
    srv = QueryServer(ds, cfg=forcing_cfg("kernel_dispatch", device),
                      calibrate=False,
                      governor=GovernorConfig(breaker_threshold=2,
                                              breaker_cooldown_s=0.2,
                                              retry_backoff_s=0.001))
    want = srv.query(query).result_set()
    seen = []
    with FaultInjector(Fault(point, "raise", every=1)) as fi:
        for _ in range(3):
            f = srv.submit(query)
            srv.flush()
            try:
                f.result()
                seen.append("ok")
            except ServingError as e:
                seen.append(type(e).__name__)
        state = srv.governor.breaker.state(f.fingerprint)
    time.sleep(0.25)
    res = srv.query(query)
    if res.result_set() != want:
        fail("governed: the breaker's recovery probe answered inexactly")
    br = srv.governor.breaker.snapshot()
    return {"outcomes": seen, "state_under_fault": state,
            "state_after": srv.governor.breaker.state(f.fingerprint),
            "calls": dict(fi.calls),
            "breaker": {k: br[k] for k in ("trips", "denials", "probes",
                                           "recoveries")},
            "governor": gov_view(srv)}


def governed_phase() -> tuple:
    """Governed serving on the card at lubm_like(scale=GOV_SCALE): a
    deadline below the connection templates' primary time, admission
    control that sheds part of a batch, a persistent fault that drives
    the ladder past the first retry and a breaker that quarantines a
    template that fails at every rung.  Every future is exact (to an
    ungoverned card engine), the truncate rung's (within its row cap) or
    its own typed error; the fault's and the breaker's counters equal
    the CPU port's run of the same scenario.  Returns the dataset and
    templates for the rebuild delta."""
    import numpy as np
    import torch
    from repro_torch.core import Dataset
    from repro_torch.data import lubm_like, random_query
    from repro_torch.serve import (GovernorConfig, QueryServer,
                                   RejectedError)

    t_phase = time.perf_counter()
    ds = Dataset.build(lubm_like(scale=GOV_SCALE, seed=1))
    queries = [random_query(ds.graph, size=6, seed=100 + i,
                            n_connection=1 if i >= N_QUERIES - 4 else 0)
               for i in range(N_QUERIES)]
    plain = ds.engine("rdf_h", device=DEVICE)
    truth, primary_s = {}, {}
    for i in GOV_TEMPLATES:
        t0 = time.perf_counter()
        truth[i] = plain.execute(queries[i])
        torch.cuda.synchronize()
        primary_s[i] = time.perf_counter() - t0
        if truth[i].stats.truncated:
            fail(f"governed: template {i} is truncated at scale {GOV_SCALE}")
    del plain
    reset_launches()
    cap = GovernorConfig().degraded_row_cap
    out = {"phase": "governed", "dataset": "lubm_like", "scale": GOV_SCALE,
           "triples": ds.num_edges,
           "why_reduced": "the force_simple_impls rung runs nested joins "
                          "and cross-product connection edges, quadratic "
                          "at full size",
           "primary_s": primary_s}

    # deadline: below the primary time of the connection templates
    conn = [i for i in GOV_TEMPLATES if queries[i].connections]
    deadline = 0.5 * min(primary_s[i] for i in conn)
    srv = QueryServer(ds, "rdf_h", calibrate=False, device=DEVICE,
                      governor=GovernorConfig(deadline_s=deadline,
                                              retry_backoff_s=0.001))
    idx = conn + [i for i in GOV_TEMPLATES if i not in conn][:2]
    t0 = time.perf_counter()
    futs = srv.submit_many([queries[i] for i in idx], wait=True)
    outs = [gov_outcome(f, truth[i], cap) for f, i in zip(futs, idx)]
    gv = gov_view(srv)
    if not gv["budget_exceeded"]:
        fail(f"governed: a {deadline:.3f} s deadline never fired")
    out["deadline"] = {"deadline_s": deadline, "templates": idx,
                       "outcomes": outs, "governor": gv,
                       "seconds": time.perf_counter() - t0}

    # admission: a batch larger than the pending bound
    bound, batch = GOV_ADMIT
    srv = QueryServer(ds, "rdf_h", calibrate=False, device=DEVICE,
                      governor=GovernorConfig(max_pending=bound))
    futs = srv.submit_many([queries[i] for i in batch])
    shed = [f for f in futs if f.done()]
    srv.flush()
    outs = []
    for f, i in zip(futs, batch):
        if f in shed:
            try:
                f.result()
                fail("governed: a shed future was answered")
            except RejectedError:
                outs.append(("error", "RejectedError", None))
        else:
            outs.append(gov_outcome(f, truth[i], cap))
    if len(shed) != len(batch) - bound:
        fail(f"governed: {len(shed)} of {len(batch)} shed at max_pending "
             f"{bound}")
    out["admission"] = {"max_pending": bound, "batch": len(batch),
                        "outcomes": outs, "governor": gov_view(srv)}
    del srv

    # the time-independent scenarios, on the card and on the CPU
    point, fidx = GOV_FAULT
    card = fault_scenario(ds, queries, fidx, DEVICE)
    cpu = fault_scenario(ds, queries, fidx, "cpu")
    for i, r, c in zip(fidx, card["results"], cpu["results"]):
        if r.result_set() != truth[i].result_set() or \
                c.result_set() != r.result_set():
            fail(f"governed: the {point} fault's template {i} is inexact")
        if not r.stats.degraded_steps:
            fail(f"governed: the {point} fault's template {i} was not "
                 "degraded")
    steps = [tuple(r.stats.degraded_steps) for r in card["results"]]
    card_view = {k: card[k] for k in ("calls", "fired", "governor")}
    cpu_view = {k: cpu[k] for k in ("calls", "fired", "governor")}
    if card_view != cpu_view or steps != [tuple(r.stats.degraded_steps)
                                          for r in cpu["results"]]:
        fail(f"governed: the {point} fault's counters differ from the "
             f"CPU port's: {card_view} / {cpu_view}")
    out["fault"] = {"point": point, "templates": list(fidx),
                    "degraded_steps": steps, **card_view}

    bpoint, bi = GOV_BREAKER
    card = breaker_scenario(ds, queries[bi], DEVICE)
    cpu = breaker_scenario(ds, queries[bi], "cpu")
    if card["outcomes"] != ["DegradationExhausted"] * 2 + \
            ["QuarantinedError"] or card["state_under_fault"] != "open" \
            or card["state_after"] != "closed":
        fail(f"governed: the breaker went {card}")
    if card != cpu:
        fail(f"governed: the breaker's counters differ from the CPU "
             f"port's: {card} / {cpu}")
    out["breaker"] = {"point": bpoint, "template": bi, **card}
    out["launches"] = read_launches("governed", GOV_KERNELS)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return ds, queries


GOV_KERNELS = ("merge_probe", "expand_segments", "interval_count")


def rebuild_deltas(g) -> list:
    """The deltas of the delta_rebuild phase, one per path that
    Dataset.apply_delta takes on the full NI variant, in the order they
    are applied, each built from the graph it applies to: (name, its
    (inserts, deletes) as a function of that graph, churn_threshold, the
    mode and reason it must take)."""
    import numpy as np
    from repro_torch.core import LITERAL
    from repro_torch.examples.serve_queries import delta_triples

    def triple(g, i):
        return (g.labels[g.src[i]], g.predicates[g.pred[i]],
                g.labels[g.dst[i]])

    def new_label(g):
        return [("Zz/new-subject-404", g.predicates[0], g.labels[0])], []

    def node_kind(g):             # a literal as a subject
        lit = int(np.flatnonzero(g.node_kind == LITERAL)[0])
        return [(g.labels[lit], g.predicates[0], g.labels[0])], []

    def label_dropped(g):         # every edge of the least-mentioned node
        ment = (np.bincount(g.src, minlength=g.num_nodes)
                + np.bincount(g.dst, minlength=g.num_nodes))
        ment[ment == 0] = np.iinfo(ment.dtype).max
        victim = int(np.argmin(ment))
        idx = np.flatnonzero((g.src == victim) | (g.dst == victim))
        return [], [triple(g, i) for i in idx]

    def unknown_and_duplicates(g):
        # deletes: names the graph lacks, and the first edge reversed
        # (known names on no edge, unless the graph holds that edge too)
        rev = ((g.src == g.dst[0]) & (g.dst == g.src[0])
               & (g.pred == g.pred[0]))
        known = (g.labels[0], "no/such-predicate", g.labels[1]) \
            if rev.any() else (g.labels[g.dst[0]], g.predicates[g.pred[0]],
                               g.labels[g.src[0]])
        return ([triple(g, i) for i in range(3)],
                [("no/such", "no/such", "no/such"), known])

    return [("new-label", new_label, 0.05, ("rebuild", "new-label")),
            ("node-kind", node_kind, 0.05, ("rebuild", "node-kind")),
            ("churn", lambda g: delta_triples(g, 0), 0.0,
             ("rebuild", "churn")),
            ("label-dropped", label_dropped, 0.05,
             ("rebuild", "label-dropped")),
            ("unknown-and-duplicates", unknown_and_duplicates, 0.05,
             ("incremental", None))]


def graph_triples(g) -> list:
    """The graph's (subject, predicate, object) strings in edge order."""
    return list(zip(g.labels[g.src].tolist(), g.predicates[g.pred].tolist(),
                    g.labels[g.dst].tolist()))


def rebuild_delta(ds, queries) -> None:
    """Every path of apply_delta on the full NI variant at the governed
    phase's scale, one delta after another through one server
    (rebuild_deltas): a new label, a literal as a subject (node kind),
    churn above churn_threshold and a dropped label, each a full rebuild
    that carries no device tensor, then an incremental delta whose
    deletes name triples the graph lacks and whose inserts repeat
    triples it holds.  Each is a delta_step, so every result equals a
    fresh card engine's; each new Dataset takes the mode and reason the
    step aimed at.  Its graph is held to a triple list kept in plain
    Python beside the server (every copy of each deleted triple goes, the
    inserts are appended): its triples in edge order, its labels, its
    predicates and its node kinds (a label is a literal iff it is forced
    or never a subject); and its digest equals Dataset.from_triples' on
    that list."""
    import torch
    from repro_torch.core import LITERAL, RESOURCE, Dataset
    from repro_torch.serve import QueryServer

    t_phase = time.perf_counter()
    srv = QueryServer(ds, "rdf_h", calibrate=False, device=DEVICE)
    for f in srv.submit_many(queries, wait=True):
        f.result()
    forced = set(ds.literal_forced or ())
    want = graph_triples(ds.graph)
    steps = []
    for name, make, churn, (mode, reason) in rebuild_deltas(ds.graph):
        prev = srv.dataset
        inserts, deletes = make(prev.graph)
        t0 = time.perf_counter()
        drop = {tuple(map(str, t)) for t in deletes}
        want = [t for t in want if t not in drop] + \
            [tuple(map(str, t)) for t in inserts]
        subjects = {t[0] for t in want}
        labels = sorted(subjects | {t[2] for t in want})
        kinds = [LITERAL if x in forced or x not in subjects else RESOURCE
                 for x in labels]
        # a Dataset's digest is its graph's: the NI index and the stats
        # are adopted as given, not built, since the digest reads neither
        digest = Dataset.from_triples(want, literal_objects=forced or None,
                                      ni=prev.ni, stats=prev.stats).digest
        t_oracle = time.perf_counter() - t0
        step = delta_step(srv, queries, inserts, deletes, name,
                          churn_threshold=churn)
        info, new = step["info"], srv.dataset
        if info["mode"] != mode or info.get("reason") != reason:
            fail(f"delta_rebuild {name}: took {info}, not {mode} {reason}")
        if mode == "rebuild" and step["carried"]:
            fail(f"delta_rebuild {name}: a rebuild carried "
                 f"{step['carried']}")
        g = new.graph
        if new.num_edges != len(want) or graph_triples(g) != want:
            fail(f"delta_rebuild {name}: its {new.num_edges} edges are not "
                 f"the plain delta's {len(want)} triples, in order")
        if g.labels.tolist() != labels or g.predicates.tolist() != \
                sorted({t[1] for t in want}) or g.node_kind.tolist() != kinds:
            fail(f"delta_rebuild {name}: labels, predicates or node kinds "
                 "differ from the plain delta's")
        if new.digest != digest or new.version != prev.version + 1:
            fail(f"delta_rebuild {name}: digest {new.digest} v{new.version}"
                 f", from_triples {digest} after v{prev.version}")
        step.update(inserts=len(inserts), deletes=len(deletes),
                    edges=new.num_edges, digest=new.digest,
                    oracle_s=t_oracle)
        emit({"phase": "delta_rebuild_step", **step})
        steps.append(name)
    del srv
    torch.cuda.empty_cache()
    emit({"phase": "delta_rebuild", "scale": GOV_SCALE,
          "triples": ds.num_edges, "steps": steps,
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------- #
# examples: the port's drivers on the card at their default scales
# ---------------------------------------------------------------------- #
EXAMPLE_KERNELS = ("merge_probe", "expand_segments", "interval_count")


def examples_phase() -> dict:
    """python -m repro_torch.examples.quickstart and serve_queries
    --governed --chaos --delta --snapshot PATH, run in this process on the
    card at their default scales, and train_lm for 30 steps with
    checkpoints, then again with --resume; any exception fails the
    phase."""
    import contextlib
    import io
    import tempfile
    from repro_torch.examples import quickstart, serve_queries, train_lm

    def train_and_resume(tmp):
        """train_lm's 30 steps with a checkpoint every 10, then again with
        --resume from step 20: the final losses agree within 1e-3
        (relative: the card's atomic sums need not repeat bit for bit)."""
        argv = ["--device", DEVICE, "--steps", "30", "--ckpt-every", "10",
                "--ckpt-dir", os.path.join(tmp, "ckpt")]
        full = train_lm.main(argv)
        resumed = train_lm.main(argv + ["--resume"])
        err = abs(resumed["final_loss"] - full["final_loss"])
        if not (resumed["resumed_from"] == 20 and math.isfinite(err)
                and err <= 1e-3 * abs(full["final_loss"])):
            fail(f"examples train_lm: resumed {resumed}, full {full}")
        return {"full": full, "resumed": resumed, "final_loss_abs_diff": err}

    t_phase = time.perf_counter()
    reset_launches()
    out = {"phase": "examples"}
    for name, fn in (("quickstart", lambda tmp: quickstart.main(
                         ["--device", DEVICE])),
                     ("serve_queries", lambda tmp: serve_queries.main(
                         ["--device", DEVICE, "--governed", "--chaos",
                          "--delta", "--snapshot",
                          os.path.join(tmp, "serve.snap")])),
                     ("train_lm", train_and_resume)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(buf):
            summary = fn(tmp)
        out[name] = {"summary": summary, "lines": len(
            buf.getvalue().splitlines()), "seconds": time.perf_counter() - t0}
    out["launches"] = read_launches("examples", EXAMPLE_KERNELS)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out["launches"]


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


# ---------------------------------------------------------------------- #
# lm: the LM scaffold's serving path (repro_torch.models) on the card
# ---------------------------------------------------------------------- #
LM_MODEL = "qwen2-0.5b"                 # (a)-(c): full width and depth
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 2048, 32
LM_LONG, LM_LONG_STEPS = 32768, 8       # (b): PREFILL_32K's length, batch 1
LM_CPU_BATCH, LM_CPU_PROMPT = 2, 128    # (c)
# (d): full width, depth cut to 2 blocks
LM_DEPTH2 = ("stablelm-1.6b", "starcoder2-15b", "minitron-8b",
             "granite-moe-1b-a400m", "paligemma-3b", "hymba-1.5b",
             "rwkv6-7b")
LM_D_BATCH, LM_D_PROMPT, LM_D_STEPS, LM_D_CPU_PROMPT = 2, 512, 4, 64
# hymba's ring (2,048 + 128 meta slots) wraps behind 2 x 2,400 prompts
LM_D_PROMPTS = {"hymba-1.5b": 2400}
# the card's peaks (NVIDIA data sheet): dense bf16 on the tensor cores
BF16_OPS_PER_S = 989e12
# fixed limits of a bf16 config, each relative to max(1, max|logits|) of
# the prefill it is held to (lm_decode_checks): a decode step against the
# bf16 prefill, and the bf16 prefill against an fp32 prefill of the same
# tokens
LM_BF16_DECODE_LIMIT = 4e-2
LM_BF16_FP32_LIMIT = 5e-2


def lm_max_err(got, ref) -> tuple:
    """(max|got - ref|, max|ref|) in fp32."""
    g, r = got.float().cpu(), ref.float().cpu()
    if g.shape != r.shape:
        fail(f"lm: shape {tuple(g.shape)}, expected {tuple(r.shape)}")
    if not r.numel():
        return 0.0, 0.0
    return float((g - r).abs().max()), float(r.abs().max())


def lm_tree_cpu(tree):
    return {k: lm_tree_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def lm_prompt_ops(cfg, b: int, s: int) -> float:
    """Operations of a dense prefill of b x s tokens: the matrix products
    of every weight outside the embedding, the attention's causal
    rectangle (masked, not skipped: every KV chunk of 1,024), and the last
    token's logits."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_params
    nonembed = count_params(tf.model_defs(cfg)["blocks"])
    skv = s if s <= 1024 else -(-s // 1024) * 1024
    attn = 4 * b * cfg.num_heads * s * skv * cfg.hd * cfg.num_layers
    return 2 * nonembed * b * s + attn + 2 * b * cfg.vocab_size * cfg.d_model


def lm_cache_len(cfg, b: int, s: int, steps: int) -> int:
    """decode_cache_len for s prompt tokens and `steps` decode steps; a
    VLM's patch tokens take cache slots too (the cache of a full
    attention holds prefix + s + steps positions, plus DECODE_PAD)."""
    from repro_torch.configs import InputShape
    from repro_torch.models import api
    return api.decode_cache_len(cfg, InputShape(
        "d", cfg.num_prefix_tokens + s + steps, b, "decode"))


def lm_serve(cfg, params, batch, steps: int, cache_len: int,
             check: bool = True) -> dict:
    """Prefill `batch`, then `steps` greedy decode steps, on the card.
    With check, decode is held to prefill after the first and the last
    step (lm_decode_checks).  Returns times, errors and the decode step's
    split."""
    import numpy as np
    import torch
    from repro_torch.models import api
    prefill = api.make_prefill_fn(cfg, cache_len=cache_len)
    decode = api.make_decode_fn(cfg)
    b = next(iter(batch.values())).shape[0]
    positions = b * (sum(v.shape[1] for k, v in batch.items()
                         if k in ("tokens", "frames", "patches"))
                     + cfg.num_meta_tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        fail(f"lm {cfg.name}: prefill logits not finite")
    out = {"prompt": [b, positions // b], "prefill_s": t_prefill,
           "prefill_tokens_per_s": positions / t_prefill}
    if not steps:
        return out
    fed, first = [], None
    t0 = time.perf_counter()
    for i in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)
        fed.append(tok)
        logits, cache = decode(params, cache, tok)
        if i == 0:
            first = logits
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    # the first step alone (it meets each shape first); the rest together
    step_s = (time.perf_counter() - t0) / max(steps - 1, 1)
    if not bool(torch.isfinite(logits).all()):
        fail(f"lm {cfg.name}: decode logits not finite")
    out.update({"decode_steps": steps, "first_step_ms": t_first * 1e3,
                "decode_ms_per_step": step_s * 1e3,
                "decode_tokens_per_s": b / step_s})
    # one step's split: the per-call cast of the weights to cfg.dtype and
    # the device's busy time under torch.profiler
    cast_ms = cuda_ms(lambda: api.cast_params(cfg, params), iters=5,
                      warmup=1)
    dev_ms = profiled_ms(lambda: decode(params, cache, tok), 3)
    out.update({"cast_ms": cast_ms,
                "cast_share_of_step": cast_ms / (step_s * 1e3),
                "step_device_ms": None if dev_ms is None else dev_ms / 3,
                "step_device_busy_share": None if dev_ms is None
                else dev_ms / 3 / (step_s * 1e3)})
    if check:
        out["decode_vs_prefill"] = lm_decode_checks(
            cfg, params, batch, fed, {1: first, steps: logits}, cache_len)
    return out


def lm_decode_checks(cfg, params, batch, fed, got: dict,
                     cache_len: int) -> dict:
    """Decode held to prefill: the logits of step n (got: {n: logits})
    against a prefill of the prompt and the n tokens fed so far.

    In fp32 the criterion is the reference's, max|Δ| < 2e-2·max(max|ref|,
    1) (tests/test_models.py, whose reduced configs compute in fp32).  A
    bf16 config is held to fixed limits instead, each relative to
    max(max|ref|, 1): each step to LM_BF16_DECODE_LIMIT from the bf16
    prefill (the reference's criterion reported beside it) and that
    prefill to LM_BF16_FP32_LIMIT from an fp32 prefill of the same tokens;
    and its steps are run again in fp32, with the same weights and the same
    fed tokens, each step of `got` held to the reference's criterion."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import api
    toks = np.asarray(batch["tokens"])
    fed_np = torch.stack(fed, 1).cpu().numpy()
    c32 = dataclasses.replace(cfg, dtype="float32")
    prefill = api.make_prefill_fn(cfg, cache_len=cache_len)
    prefill32 = api.make_prefill_fn(c32, cache_len=cache_len)
    out, ref32 = {}, {}
    for n, logits in got.items():
        b_n = dict(batch, tokens=np.concatenate([toks, fed_np[:, :n]], 1))
        ref, _ = prefill(params, b_n)
        err, scale = lm_max_err(logits, ref)
        crit = 2e-2 * max(scale, 1.0)
        rec = {"max_abs_err": err, "ref_max_abs": scale,
               "reference_criterion": crit,
               "reference_criterion_held": err < crit}
        limit = crit
        if cfg.dtype != "float32":
            limit = LM_BF16_DECODE_LIMIT * max(scale, 1.0)
            ref32[n], _ = prefill32(params, b_n)
            noise, scale32 = lm_max_err(ref, ref32[n])
            noise_limit = LM_BF16_FP32_LIMIT * max(scale32, 1.0)
            rec.update(limit=limit, bf16_vs_fp32_prefill_max_abs=noise,
                       bf16_vs_fp32_prefill_limit=noise_limit)
            if not noise < noise_limit:
                fail(f"lm {cfg.name} bf16 prefill of step {n}'s tokens "
                     f"against fp32: max|Δ| {noise} not under {noise_limit}")
        if not err < limit:
            fail(f"lm {cfg.name} decode step {n} against prefill: "
                 f"max|Δ| {err} not under {limit}")
        out[f"step_{n}"] = rec
    if cfg.dtype != "float32":
        _, cache = prefill32(params, batch)
        decode32 = api.make_decode_fn(c32)
        for i in range(max(got)):
            logits32, cache = decode32(params, cache, fed[i])
            if i + 1 not in got:
                continue
            err, scale = lm_max_err(logits32, ref32[i + 1])
            crit = 2e-2 * max(scale, 1.0)
            if not err < crit:
                fail(f"lm {cfg.name} fp32 decode step {i + 1} against "
                     f"prefill: max|Δ| {err} not under {crit}")
            out[f"fp32_step_{i + 1}"] = {"max_abs_err": err,
                                         "ref_max_abs": scale,
                                         "reference_criterion": crit}
    return out


def lm_matmul_check(cfg, b: int, s: int, cache_len: int) -> dict:
    """nn_ops.matmul_f32 on the card at the products of (a)'s prefill
    (flash attention's QK and PV over a KV chunk of 1,024), decode step
    (QK and PV over the cache) and logits (the transposed unembedding):
    bf16 operands with an fp32 result (out_dtype), the only branch of the
    LM path that runs on the card alone, against the product of the
    operands widened to fp32 (exact for bf16) with TF32 off.  Within
    1e-5·max(1, max|ref|), the distance of two fp32 summation orders; a
    result rounded to bf16 is ~4e-3 off."""
    import torch
    from repro_torch.models import nn_ops
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    bh, g, hd = b * cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.hd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)
    shapes = {"flash_qk": ((bh, g * s, hd), (bh, hd, 1024)),
              "flash_pv": ((bh, g * s, 1024), (bh, 1024, hd)),
              "decode_qk": ((bh, g, hd), (bh, hd, cache_len)),
              "decode_pv": ((bh, g, cache_len), (bh, cache_len, hd)),
              "logits": ((b, cfg.d_model), (cfg.vocab_size, cfg.d_model))}
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name, (sa, sb) in shapes.items():
            x, w = randn(*sa), randn(*sb)
            if name == "logits":        # x[:, -1] @ un.t(), un [V, d]
                w = w.t()
            got = nn_ops.matmul_f32(x, w)
            if got.dtype != torch.float32:
                fail(f"lm matmul_f32 {name}: result is {got.dtype}")
            err, scale = lm_max_err(got, torch.matmul(x.float(), w.float()))
            if not err <= 1e-5 * max(1.0, scale):
                fail(f"lm matmul_f32 {name}: max|Δ| {err} over "
                     f"1e-5·{scale}")
            out[name] = {"a": list(x.shape), "b": list(w.shape),
                         "max_abs_err": err, "ref_max_abs": scale}
            del x, w, got
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    return out


def lm_card_vs_cpu(cfg, params, b: int, s: int, steps: int = 2) -> dict:
    """cfg in fp32 (dtype "float32"), TF32 off: prefill b x s and `steps`
    decode steps on the card and on the CPU with the same weights; the
    logits and every cache leaf agree within 1e-3·max(1, max|ref|)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.models import api, convert
    from repro_torch.models.param import tree_leaves
    cfg = dataclasses.replace(cfg, dtype="float32")
    batch = api.concrete_batch(cfg, InputShape("c", s, b, "prefill"), seed=7)
    cl = lm_cache_len(cfg, b, s, steps)
    prefill = api.make_prefill_fn(cfg, cache_len=cl)
    decode = api.make_decode_fn(cfg)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    snaps = {}
    t0 = time.perf_counter()
    try:
        for where, p in (("card", params), ("cpu", lm_tree_cpu(params))):
            logits, cache = prefill(p, batch)
            snap = [convert.cache_to_numpy({"logits": logits,
                                            "cache": cache})]
            for i in range(steps if cfg.decoder else 0):
                tok = torch.full((b,), 11 + i, dtype=torch.int32,
                                 device=logits.device)
                logits, cache = decode(p, cache, tok)
                snap.append(convert.cache_to_numpy({"logits": logits,
                                                    "cache": cache}))
            snaps[where] = snap
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    worst, n_leaves = {}, 0
    for i, (card, cpu) in enumerate(zip(snaps["card"], snaps["cpu"])):
        got = dict(tree_leaves(card))
        for path, want in tree_leaves(cpu):
            g = got[path]
            if g.shape != want.shape:
                fail(f"lm {cfg.name} card vs CPU {path}: shape")
            if not want.size:
                continue
            n_leaves += 1
            err = float(np.max(np.abs(g.astype(np.float64) - want)))
            scale = max(1.0, float(np.max(np.abs(want))))
            if not err <= 1e-3 * scale:
                fail(f"lm {cfg.name} card vs CPU step {i} {path}: max|Δ| "
                     f"{err} over 1e-3·{scale}")
            key = "logits" if path == ("logits",) else "cache"
            worst[key] = max(worst.get(key, 0.0), err / scale)
    return {"prompt": [b, s], "steps": steps if cfg.decoder else 0,
            "leaves_held": n_leaves, "max_rel_err": worst,
            "seconds": time.perf_counter() - t0}


def lm_op_times() -> dict:
    """Seconds of single plain-PyTorch ops at the phase's shapes (host
    clock around a synchronised call, after one warm call):
    flash_attention of one qwen2-0.5b layer at 32,768 tokens (its causal
    rectangle masked, not skipped: 3.85 TFLOP) and ssm_scan of one
    hymba-1.5b layer over 2 x (128 meta + 2,400) tokens, the per-token
    loop."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import nn_ops, ssm
    from repro_torch.models.param import init_params
    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)

    def seconds(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    q = ARCHS[LM_MODEL]
    qkv = (randn(1, q.num_heads, LM_LONG, q.hd),
           randn(1, q.num_kv_heads, LM_LONG, q.hd),
           randn(1, q.num_kv_heads, LM_LONG, q.hd))
    attn_s = seconds(lambda: nn_ops.flash_attention(*qkv, causal=True))
    ops = 4 * q.num_heads * LM_LONG * LM_LONG * q.hd
    del qkv
    h = ARCHS["hymba-1.5b"]
    p = {k: v.to(torch.bfloat16) for k, v in init_params(
        ssm.ssm_defs(h), gen, device=DEVICE).items()}
    s_len = h.num_meta_tokens + LM_D_PROMPTS["hymba-1.5b"]
    x = randn(LM_D_BATCH, s_len, h.d_model)
    h0 = torch.zeros((LM_D_BATCH, h.ssm_heads, h.d_model // h.ssm_heads,
                      h.ssm_state), device=DEVICE)
    ssm_s = seconds(lambda: ssm.ssm_scan(h, p, x, h0))
    return {"phase": "lm", "case": "op_times",
            "flash_attention_32k_layer_s": attn_s,
            "flash_attention_32k_layer_bound_ms": ops / BF16_OPS_PER_S * 1e3,
            "ssm_scan_layer_s": ssm_s, "ssm_scan_tokens": LM_D_BATCH * s_len,
            "ssm_scan_us_per_token_step": ssm_s / s_len * 1e6}


def lm_config_run(name: str, cfg, b: int, s: int, steps: int,
                  cpu_b: int, cpu_s: int, bounds=None, **fields):
    """One config: init on the card from seed 0 (the tree held to
    model_defs), a short warm-up, lm_serve of b x s and `steps` steps,
    and lm_card_vs_cpu at cpu_b x cpu_s; prints its line, with `fields`
    and bounds(n_params, cache_len), and returns the weights."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_params, tree_leaves
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_model(cfg, seed=0, device=DEVICE)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    if n_params != count_params(tf.model_defs(cfg)):
        fail(f"lm {name}: the initialised tree does not match model_defs")
    # a short prefill and steps first, so no timed call meets a cold handle
    warm = 2 if cfg.decoder else 0
    lm_serve(cfg, params, api.concrete_batch(
        cfg, InputShape("w", 16, 1, "prefill"), seed=9), warm,
        lm_cache_len(cfg, 1, 16, warm), False)
    batch = api.concrete_batch(cfg, InputShape("p", s, b, "prefill"), seed=1)
    cl = lm_cache_len(cfg, b, s, steps)
    out = {"phase": "lm", "config": name, **fields, "family": cfg.family,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "params": n_params, "cache_len": cl}
    out.update(lm_serve(cfg, params, batch, steps if cfg.decoder else 0, cl))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if bounds is not None:
        out.update(bounds(n_params, cl))
    out["card_vs_cpu"] = lm_card_vs_cpu(cfg, params, cpu_b, cpu_s)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return params


def lm_phase() -> None:
    """The LM scaffold's serving path on the card: (a) qwen2-0.5b at full
    width and depth, 8 prompts of 2,048 tokens and 32 greedy decode steps,
    with (c) the card against the CPU port in fp32 and matmul_f32 at its
    shapes; (b) one prompt of 32,768 tokens; (d) the other decoding
    configs at full width, 2 blocks deep; (e) hubert-xlarge (encoder:
    prefill only) at full width, 2 blocks deep, and
    llama4-maverick-400b-a17b at reduced_config.  No hand kernel is on
    this path: the phase launches none."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS, InputShape, reduced_config
    from repro_torch.models import api
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    reset_launches()
    cfg = ARCHS[LM_MODEL]

    def bounds(n_params, cl):
        weight_bytes = n_params * 2                        # bf16 copies
        cache_bytes = 2 * cfg.num_layers * LM_BATCH * cfg.num_kv_heads \
            * cl * cfg.hd * 2
        return {"prefill_bound_ms": lm_prompt_ops(cfg, LM_BATCH, LM_PROMPT)
                / BF16_OPS_PER_S * 1e3,
                "decode_bound_ms": (weight_bytes + cache_bytes)
                / MEM_BYTES_PER_S * 1e3,
                "decode_bound_with_cast_ms": (n_params * 8 + cache_bytes)
                / MEM_BYTES_PER_S * 1e3}

    # (a) 8 x 2,048 and 32 greedy steps, decode held to prefill, and (c)
    # the card against the CPU port, fp32, at 2 x 128
    params = lm_config_run(LM_MODEL, cfg, LM_BATCH, LM_PROMPT, LM_STEPS,
                           LM_CPU_BATCH, LM_CPU_PROMPT, bounds, case="a")
    emit({"phase": "lm", "config": LM_MODEL, "case": "matmul_f32",
          **lm_matmul_check(cfg, LM_BATCH, LM_PROMPT, lm_cache_len(
              cfg, LM_BATCH, LM_PROMPT, LM_STEPS))})

    # (b) one prompt at PREFILL_32K's length: time to first token
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = api.concrete_batch(
        cfg, InputShape("b", LM_LONG, 1, "prefill"), seed=2)
    serve = lm_serve(cfg, params, batch, LM_LONG_STEPS,
                     LM_LONG + api.DECODE_PAD, check=False)
    b_out = {"phase": "lm", "config": LM_MODEL, "case": "b",
             "cache_len": LM_LONG + api.DECODE_PAD, **serve,
             "time_to_first_token_s": serve["prefill_s"],
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "prefill_bound_ms": lm_prompt_ops(cfg, 1, LM_LONG)
             / BF16_OPS_PER_S * 1e3}
    emit(b_out)
    del batch, params
    torch.cuda.empty_cache()
    emit(lm_op_times())

    # (d) the other decoding configs, full width, 2 blocks deep; MoE at
    # capacity_factor 16 as tests/test_models.py runs it, so that no slot
    # of the prefill is dropped where the step keeps it
    for name in LM_DEPTH2:
        dcfg = ARCHS[name]
        dcfg = dataclasses.replace(
            dcfg, num_layers=2 * tf.layers_per_block(dcfg),
            **({"capacity_factor": 16.0} if dcfg.num_experts else {}))
        lm_config_run(name, dcfg, LM_D_BATCH,
                      LM_D_PROMPTS.get(name, LM_D_PROMPT), LM_D_STEPS,
                      1, LM_D_CPU_PROMPT)
    # (e) the encoder (no decode shapes) and llama4 at reduced_config: one
    # of its routed layers alone holds 16.1 B parameters at full width
    lm_config_run("hubert-xlarge", dataclasses.replace(
        ARCHS["hubert-xlarge"], num_layers=2), LM_D_BATCH, LM_D_PROMPT, 0,
        1, LM_D_CPU_PROMPT)
    lm_config_run(
        "llama4-maverick-400b-a17b",
        reduced_config(ARCHS["llama4-maverick-400b-a17b"],
                       capacity_factor=16.0),
        LM_D_BATCH, LM_D_PROMPT, LM_D_STEPS, 1, LM_D_CPU_PROMPT)
    launches = launch_counts()
    if any(launches.values()):
        fail(f"lm: the LM path launched hand kernels {launches}")
    emit({"phase": "lm_summary", "configs": [LM_MODEL, *LM_DEPTH2,
                                             "hubert-xlarge",
                                             "llama4-maverick-400b-a17b"],
          "hand_kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------- #
# train: the LM scaffold's training path (repro_torch.models, optim,
# checkpoint, data) on the card
# ---------------------------------------------------------------------- #
TRAIN_MODEL = "qwen2-0.5b"              # (a)-(c), (e): full width and depth
# (a): train_4k's sequence; its global batch of 256 cut to 16 for time
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MICRO = 16, 4096, 3, 4
TRAIN_FULL_BATCH = 256
TRAIN_MEM_BATCH, TRAIN_MEM_SEQ, TRAIN_MEM_STEPS = 2, 512, 8     # (b)
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 128                          # (c)
TRAIN_D_BATCH, TRAIN_D_SEQ = 2, 512                              # (d)
# (c)'s limits: the card's fp32 loss, grad_norm and every gradient leaf
# against the CPU's (different summation orders), each relative to the
# CPU's value (a leaf: to its max|ref|); matmul_f32's bf16 gradients
# against widened fp32 autograd: one bf16 ulp at max|ref|
TRAIN_LOSS_LIMIT, TRAIN_NORM_LIMIT, TRAIN_GRAD_LIMIT = 1e-5, 1e-4, 1e-4
TRAIN_BF16_ULP = 2.0 ** -8


def train_flops(cfg, b: int, s: int) -> dict:
    """Operations of one train step over b x s tokens with per-block and
    per-chunk remat: the forward F (every block weight's product, the
    attention's causal rectangle masked, not skipped, over KV chunks of
    1,024, and the loss head's logits), again in the recompute, and twice
    in the backward pass: step_flop, 4F.  The recompute skips each
    block's last product (the FFN's w2): torch.utils.checkpoint stops
    recomputing once every tensor the backward pass needs is back, and
    that product's output is needed by none, so the step runs
    step_flop_remat, 4F less those products (dryrun_card_flops counts
    them on the card).  The work the step needs is 3F' (no recompute; F'
    with attention over the causal triangle's s(s+1)/2 query-key pairs
    only).  Model FLOPs are 6·N·D (N every parameter, D the tokens)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_params
    t = b * s
    blocks = count_params(tf.model_defs(cfg)["blocks"])
    skv = s if s <= 1024 else -(-s // 1024) * 1024
    attn = 4 * b * cfg.num_heads * s * skv * cfg.hd * cfg.num_layers
    head = 2 * t * cfg.vocab_size * cfg.d_model
    causal = 4 * b * cfg.num_heads * (s * (s + 1) // 2) * cfg.hd \
        * cfg.num_layers
    fwd = 2 * blocks * t + attn + head
    n = count_params(tf.model_defs(cfg))
    skipped = 2 * t * cfg.d_ff * cfg.d_model * cfg.num_layers
    return {"forward_flop": fwd, "attention_flop": attn,
            "attention_causal_flop": causal, "head_flop": head,
            "recompute_skipped_flop": skipped, "step_flop": 4 * fwd,
            "step_flop_remat": 4 * fwd - skipped,
            "needed_step_flop": 3 * (2 * blocks * t + causal + head),
            "model_flop": 6 * n * t}


def train_tree_clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def train_bits(t):
    """A tensor's bit patterns, for equality bit for bit."""
    import torch
    views = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(views[t.dtype]) if t.dtype in views else t


def train_tree_equal(got, want) -> bool:
    """Every leaf equal bit for bit."""
    import torch
    from repro_torch.tree import tree_leaves
    g = dict(tree_leaves(got))
    return all(torch.equal(train_bits(g[p]), train_bits(w))
               for p, w in tree_leaves(want))


def train_tree_diff(got, want) -> float:
    """max over leaves of max|got - want| / max(1, max|want|)."""
    from repro_torch.tree import tree_leaves
    g = dict(tree_leaves(got))
    worst = 0.0
    for path, w in tree_leaves(want):
        if w.numel():
            err, scale = lm_max_err(g[path], w)
            worst = max(worst, err / max(1.0, scale))
    return worst


def train_batch(cfg, b: int, s: int, seed: int = 1):
    from repro_torch.configs import InputShape
    from repro_torch.models import api
    return api.concrete_batch(cfg, InputShape("t", s, b, "train"), seed=seed)


def train_top_kernels(step, n: int = 8) -> dict:
    """One call of step under torch.profiler, tracing the card only (a
    step launches some 10^5 kernels; host events would multiply the
    trace): its device time (ms) and the n kernels that took the most of
    it, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev = device_times(prof)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ms": sum(dev.values()), "kernels": len(dev),
            "top": [[k[:90], v] for k, v in top]}


def train_select_blocks(tree, n: int) -> list:
    """The n blocks of a stacked tree by indexing every leaf once a block
    (v[i]: each select's backward is a zero-filled gradient of the whole
    stacked leaf), the way the trunk walked its blocks before
    transformer.unstack."""
    def at(t, i):
        return {k: at(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}
    return [at(tree, i) for i in range(n)]


def train_split_step(step_fn, params, opt, batch, step) -> tuple:
    """One call of step_fn with its device time split by part, read from
    the step itself: CUDA events on the step's stream where a part begins
    and ends.  Attention (every flash_attention call) and the loss head
    (chunked_cross_entropy) are opened and closed by identity autograd
    Functions, which mark them in the forward pass, in the recompute
    (marks met after the microbatch's backward began) and in the backward
    pass (the closing mark's backward runs first, the opening one's last;
    the loss head's per-chunk recompute falls inside its backward);
    clipping and AdamW are marked around their calls.  Returns (split,
    params, opt): ms per part and pass, the step's ms between its first
    and last event, and the rest."""
    import torch
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    marks, state = [], {"pass": "forward"}

    def record(part, edge, pass_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((part, pass_, edge, ev))

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, part, edge, *xs):
            ctx.part, ctx.edge = part, edge
            record(part, edge, state["pass"])
            return tuple(x.view_as(x) for x in xs)

        @staticmethod
        def backward(ctx, *gs):
            state["pass"] = "recompute"
            record(ctx.part, "begin" if ctx.edge == "end" else "end",
                   "backward")
            return (None, None, *gs)

    def marked(part, fn):
        def call(*xs, **kw):
            ys = fn(*Mark.apply(part, "begin", *xs), **kw)
            return Mark.apply(part, "end", ys)[0]
        return call

    def forward_first(fn):
        def call(*a, **kw):
            state["pass"] = "forward"
            return fn(*a, **kw)
        return call

    def optimizer(fn, edge):
        def call(*a, **kw):
            if edge == "begin":
                record("optimizer", "begin", "step")
            out = fn(*a, **kw)
            if edge == "end":
                record("optimizer", "end", "step")
            return out
        return call

    saved = {(tf, "flash_attention"): tf.flash_attention,
             (tf, "chunked_cross_entropy"): tf.chunked_cross_entropy,
             (tf, "loss_fn"): tf.loss_fn,
             (api, "clip_by_global_norm"): api.clip_by_global_norm,
             (api, "adamw_update"): api.adamw_update}
    tf.flash_attention = marked("attention", tf.flash_attention)
    tf.chunked_cross_entropy = marked("loss_head", tf.chunked_cross_entropy)
    tf.loss_fn = forward_first(tf.loss_fn)
    api.clip_by_global_norm = optimizer(api.clip_by_global_norm, "begin")
    api.adamw_update = optimizer(api.adamw_update, "end")
    try:
        torch.cuda.synchronize()
        record("step", "begin", "step")
        params, opt, m = step_fn(params, opt, batch, step)
        record("step", "end", "step")
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    ms, spans, open_ = {}, {}, {}
    for part, pass_, edge, ev in marks:
        key = (part, pass_)
        if edge == "begin":
            if key in open_:
                fail(f"train split: {key} opened twice")
            open_[key] = ev
        else:
            key_ms = open_.pop(key).elapsed_time(ev)
            ms[key] = ms.get(key, 0.0) + key_ms
            spans[key] = spans.get(key, 0) + 1
    if open_:
        fail(f"train split: spans left open {sorted(open_)}")
    step_ms = ms.pop(("step", "step"))
    parts = {}
    for (part, pass_), v in ms.items():
        parts.setdefault(part, {})[pass_] = v
        parts[part][f"{pass_}_spans"] = spans[(part, pass_)]
    for part, d in parts.items():
        d["ms"] = sum(v for k, v in d.items() if not k.endswith("_spans"))
        d["share"] = d["ms"] / step_ms
    rest = step_ms - sum(d["ms"] for d in parts.values())
    rec = {k: float(v) for k, v in m.items()}
    if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
        fail(f"train split step: loss or grad_norm not finite ({rec})")
    return ({"step_ms": step_ms, "parts": parts, "rest_ms": rest,
             "rest_share": rest / step_ms, "metrics": rec}, params, opt)


def train_op_times(cfg, mb: int, s: int) -> dict:
    """Seconds of the step's parts at (a)'s microbatch of mb x s tokens
    (host clock around synchronised calls, after one warm call): one
    layer's flash_attention forward and forward + backward (bf16), the
    loss head (chunked_cross_entropy, forward + backward with its
    recompute) and the optimizer (clip_by_global_norm and adamw_update
    over the whole model)."""
    import torch
    from repro_torch.models import api, nn_ops
    from repro_torch.optim import adamw_init, adamw_update, \
        clip_by_global_norm
    from repro_torch.tree import tree_map
    gen = torch.Generator(device=DEVICE).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16).requires_grad_()

    def seconds(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    q = randn(mb, cfg.num_heads, s, cfg.hd)
    k = randn(mb, cfg.num_kv_heads, s, cfg.hd)
    v = randn(mb, cfg.num_kv_heads, s, cfg.hd)
    gy = torch.randn(q.shape, generator=gen, device=DEVICE,
                     dtype=torch.bfloat16)
    with torch.no_grad():
        fwd_s = seconds(lambda: nn_ops.flash_attention(q, k, v))
    both_s = seconds(lambda: torch.autograd.grad(
        nn_ops.flash_attention(q, k, v), (q, k, v), gy))
    del q, k, v, gy
    x = randn(mb, s, cfg.d_model)
    un = randn(cfg.vocab_size, cfg.d_model)
    labels = torch.randint(0, cfg.vocab_size, (mb, s), generator=gen,
                           device=DEVICE)
    head_s = seconds(lambda: torch.autograd.grad(
        nn_ops.chunked_cross_entropy(x, un, labels,
                                     chunk=cfg.loss_chunk), (x, un)))
    del x, un
    params = api.init_model(cfg, seed=0, device=DEVICE)
    opt = adamw_init(params)
    grads = tree_map(lambda p: torch.full_like(p, 1e-3), params)
    opt_s = seconds(lambda: adamw_update(
        clip_by_global_norm(grads, 1.0)[0], opt, params, 1e-4))
    return {"attention_layer_fwd_s": fwd_s,
            "attention_layer_fwd_bwd_s": both_s,
            "loss_head_fwd_bwd_s": head_s, "optimizer_s": opt_s,
            "microbatch": [mb, s]}


def train_qwen_steps(cfg, params, opt) -> dict:
    """(a): TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens from
    TokenPipeline, microbatch TRAIN_MICRO, bf16 gradients, remat; the first
    a warm-up.  Then one more such step split by part on the device
    (train_split_step).  Then, on one microbatch's rows as a step of its
    own (microbatch 1): a step with the blocks indexed one by one
    (train_select_blocks) in place of unbind, between two unbind steps,
    and one step under torch.profiler (that microbatch step's device busy
    share against the unbind steps' mean wall time)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    tcfg = TrainConfig(grad_dtype="bfloat16", microbatch=TRAIN_MICRO,
                       remat=True, warmup=2, total_steps=100)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    out = {"batch": [TRAIN_BATCH, TRAIN_SEQ],
           "cut": f"global batch {TRAIN_FULL_BATCH} of train_4k cut to "
                  f"{TRAIN_BATCH} for the run's time",
           "microbatch": TRAIN_MICRO, "grad_dtype": "bfloat16",
           "steps": [], "step_s": []}
    i = 0

    def one_step(step_fn, rows=None):
        nonlocal params, opt, i
        b = pipe.global_batch_at(i)
        if rows:
            b = {k: v[:rows] for k, v in b.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b, i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {k: float(v) for k, v in m.items()}
        if not (math.isfinite(rec["loss"])
                and math.isfinite(rec["grad_norm"])):
            fail(f"train {cfg.name} step {i}: loss or grad_norm not finite "
                 f"({rec})")
        i += 1
        return dt, rec

    step_fn = api.make_train_step(cfg, tcfg)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        dt, rec = one_step(step_fn)
        out["steps"].append(rec)
        out["step_s"].append(dt)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    timed = out["step_s"][1:]
    step_s = sum(timed) / len(timed)
    fl = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out.update({"seconds_per_step": step_s, "tokens_per_s": tokens / step_s,
                **fl, "step_bound_s": fl["step_flop"] / BF16_OPS_PER_S,
                "model_flop_bound_s": fl["model_flop"] / BF16_OPS_PER_S,
                "needed_step_bound_s":
                    fl["needed_step_flop"] / BF16_OPS_PER_S,
                "attention_bound_s":
                    4 * fl["attention_flop"] / BF16_OPS_PER_S,
                "attention_causal_bound_s":
                    3 * fl["attention_causal_flop"] / BF16_OPS_PER_S,
                "model_flops_share_of_peak":
                    fl["model_flop"] / BF16_OPS_PER_S / step_s,
                "step_flops_share_of_peak":
                    fl["step_flop"] / BF16_OPS_PER_S / step_s})
    t0 = time.perf_counter()
    split, params, opt = train_split_step(step_fn, params, opt,
                                          pipe.global_batch_at(i), i)
    i += 1
    out["split_step"] = {**split, "wall_s": time.perf_counter() - t0}
    # one microbatch's rows as a step: the blocks indexed one by one (one
    # select per block and leaf) between two unbind steps, then a profiled
    # step
    rows = TRAIN_BATCH // TRAIN_MICRO
    step_mb = api.make_train_step(cfg, dataclasses.replace(tcfg,
                                                           microbatch=1))
    unstack = tf.unstack
    ways = {"batch": [rows, TRAIN_SEQ], "select": [], "unbind": []}
    for way in ("unbind", "select", "unbind"):
        tf.unstack = unstack if way == "unbind" else train_select_blocks
        try:
            torch.cuda.reset_peak_memory_stats()
            dt, _ = one_step(step_mb, rows)
        finally:
            tf.unstack = unstack
        ways[way].append({"step_s": dt, "peak_gb":
                          torch.cuda.max_memory_allocated() / 1e9})
    out["select_vs_unbind"] = ways
    mb_s = sum(w["step_s"] for w in ways["unbind"]) / len(ways["unbind"])
    t0 = time.perf_counter()
    prof = train_top_kernels(lambda: one_step(step_mb, rows))
    out["profiled_step"] = {"batch": [rows, TRAIN_SEQ], "microbatch": 1,
                            **prof, "wall_s": time.perf_counter() - t0,
                            "unprofiled_s": mb_s,
                            "busy_share": prof["device_ms"] / 1e3 / mb_s}
    return out, params, opt


def train_memorise(cfg, params) -> dict:
    """(b): TRAIN_MEM_STEPS steps on one fixed TRAIN_MEM_BATCH x
    TRAIN_MEM_SEQ batch (lr 1e-3, warm-up 1): the loss must fall."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    step_fn = api.make_train_step(cfg, TrainConfig(
        lr=1e-3, warmup=1, total_steps=30, grad_dtype="bfloat16"))
    batch = train_batch(cfg, TRAIN_MEM_BATCH, TRAIN_MEM_SEQ)
    opt = adamw_init(params)
    losses = []
    for i in range(TRAIN_MEM_STEPS):
        params, opt, m = step_fn(params, opt, batch, i)
        losses.append(float(m["loss"]))
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f"train {cfg.name}: memorisation loss did not fall {losses}")
    return {"batch": [TRAIN_MEM_BATCH, TRAIN_MEM_SEQ], "losses": losses}


def train_matmul_backward(cfg, mb: int, s: int) -> dict:
    """nn_ops.matmul_f32's backward on the card (bf16 operands, an fp32
    cotangent) at (a)'s products: flash attention's QK and PV over a KV
    chunk of 1,024 and the loss head's logits of one chunk, against
    autograd of the product of the widened operands (TF32 off): each
    gradient in bf16, within TRAIN_BF16_ULP·max|ref| (one bf16 ulp where
    the two fp32 sums round apart)."""
    import torch
    from repro_torch.models import nn_ops
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    bh, g, hd = mb * cfg.num_kv_heads, \
        cfg.num_heads // cfg.num_kv_heads, cfg.hd
    chunk = min(cfg.loss_chunk, s)
    shapes = {"flash_qk": ((bh, g * s, hd), (bh, hd, 1024)),
              "flash_pv": ((bh, g * s, 1024), (bh, 1024, hd)),
              "loss_head": ((mb * chunk, cfg.d_model),
                            (cfg.vocab_size, cfg.d_model))}
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name, (sa, sb) in shapes.items():
            a = torch.randn(sa, generator=gen, device=DEVICE,
                            dtype=torch.bfloat16).requires_grad_()
            b = torch.randn(sb, generator=gen, device=DEVICE,
                            dtype=torch.bfloat16).requires_grad_()
            bt = b.t() if name == "loss_head" else b   # x @ un.t()
            y = nn_ops.matmul_f32(a, bt)
            gy = torch.randn(y.shape, generator=gen, device=DEVICE)
            got = torch.autograd.grad(y, (a, b), gy)
            want = torch.autograd.grad(
                torch.matmul(a.float(), bt.float()), (a, b), gy)
            rec = {"a": list(sa), "b": list(sb)}
            for side, gg, ww in zip("ab", got, want):
                if gg.dtype != torch.bfloat16:
                    fail(f"train matmul_f32 {name}: d{side} is {gg.dtype}")
                err, scale = lm_max_err(gg, ww)
                if not err <= TRAIN_BF16_ULP * scale:
                    fail(f"train matmul_f32 {name} d{side}: max|Δ| {err} "
                         f"over {TRAIN_BF16_ULP}·{scale}")
                rec[f"d{side}_max_abs_err"] = err
                rec[f"d{side}_ref_max_abs"] = scale
                rec[f"d{side}_bitwise_equal"] = bool(torch.equal(
                    train_bits(gg), train_bits(ww)))
            out[name] = rec
            del a, b, bt, y, gy, got, want
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    return out


def train_card_vs_cpu(cfg, params) -> dict:
    """(c): cfg in fp32, TF32 off: the loss and every gradient of
    make_loss_fn over TRAIN_CPU_BATCH x TRAIN_CPU_SEQ tokens on the card
    and on the CPU with the same weights; the loss within
    TRAIN_LOSS_LIMIT, grad_norm within TRAIN_NORM_LIMIT (relative) and
    every gradient leaf within TRAIN_GRAD_LIMIT·max|ref leaf|."""
    import dataclasses
    import torch
    from repro_torch.models import api
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_from_leaves, tree_leaves
    cfg = dataclasses.replace(cfg, dtype="float32")
    batch = train_batch(cfg, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, seed=7)
    loss_fn = api.make_loss_fn(cfg)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    t0 = time.perf_counter()
    try:
        for where, p in (("card", params), ("cpu", lm_tree_cpu(params))):
            wrt = {k: v.detach().requires_grad_()
                   for k, v in tree_leaves(p)}
            loss, _ = loss_fn(tree_from_leaves(wrt), batch)
            grads = dict(zip(wrt, torch.autograd.grad(
                loss, list(wrt.values()))))
            runs[where] = (float(loss.detach()), float(global_norm(grads)),
                           {k: g.cpu() for k, g in grads.items()})
            del wrt, grads
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (l_card, n_card, g_card), (l_cpu, n_cpu, g_cpu) = runs["card"], \
        runs["cpu"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    norm_err = abs(n_card - n_cpu) / n_cpu
    if not (loss_err <= TRAIN_LOSS_LIMIT and norm_err <= TRAIN_NORM_LIMIT):
        fail(f"train {cfg.name} card vs CPU: loss {l_card} / {l_cpu}, "
             f"grad_norm {n_card} / {n_cpu}")
    worst = 0.0
    for path, want in g_cpu.items():
        got = g_card[path]
        if not bool(torch.isfinite(got).all()):
            fail(f"train {cfg.name} card gradient {path} not finite")
        err, scale = lm_max_err(got, want)
        if not err <= TRAIN_GRAD_LIMIT * scale:
            fail(f"train {cfg.name} card vs CPU gradient {path}: max|Δ| "
                 f"{err} over {TRAIN_GRAD_LIMIT}·{scale}")
        worst = max(worst, err / scale)
    return {"batch": [TRAIN_CPU_BATCH, TRAIN_CPU_SEQ], "loss": [l_card,
            l_cpu], "grad_norm": [n_card, n_cpu], "loss_rel_err": loss_err,
            "grad_norm_rel_err": norm_err, "leaves_held": len(g_cpu),
            "grad_max_rel_err": worst, "seconds": time.perf_counter() - t0}


def train_checkpoint(cfg, params, opt, tmp: str) -> dict:
    """(e): save (a)'s params and optimizer state asynchronously, take a
    step (AdamW writes in place), restore into a template on the card:
    every leaf equals the saved one bit for bit.  Then one step (b's
    batch) from the restored state against the same step from the
    in-memory state, run twice: with deterministic algorithms the two
    in-memory runs agree bit for bit, and then so must the restored one;
    otherwise it must be within 4x their distance."""
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves
    step_fn = api.make_train_step(cfg, TrainConfig(
        lr=1e-3, warmup=1, total_steps=30, grad_dtype="bfloat16"))
    batch = train_batch(cfg, TRAIN_MEM_BATCH, TRAIN_MEM_SEQ, seed=3)
    state = {"params": params, "opt": opt}
    snap = train_tree_clone(state)
    ck = Checkpointer(tmp)
    t0 = time.perf_counter()
    ck.save(7, state, meta={"step": 7})
    save_call_s = time.perf_counter() - t0
    params, opt, _ = step_fn(params, opt, batch, 7)      # in place
    torch.cuda.synchronize()
    ck.wait()
    written_s = time.perf_counter() - t0
    del params, opt, state
    t0 = time.perf_counter()
    restored, meta = ck.restore(template=snap, device=DEVICE)
    restore_s = time.perf_counter() - t0
    want = dict(tree_leaves(snap))
    n_bytes = 0
    for path, t in tree_leaves(restored):
        w = want[path]
        if t.dtype != w.dtype or t.device != w.device or not torch.equal(
                train_bits(t), train_bits(w)):
            fail(f"train checkpoint {path}: restored leaf differs")
        n_bytes += t.numel() * t.element_size()
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for state in (train_tree_clone(snap), snap, restored):
            p, o, m = step_fn(state["params"], state["opt"], batch, 8)
            runs.append(({"params": p, "opt": o},
                         {k: float(v) for k, v in m.items()}))
            del p, o, state
    finally:
        torch.use_deterministic_algorithms(det)
    (a, ma), (b, mb), (r, mr) = runs
    twice_equal = train_tree_equal(b, a) and ma == mb
    restored_equal = train_tree_equal(r, a) and ma == mr
    noise, dist = train_tree_diff(b, a), train_tree_diff(r, a)
    if not (restored_equal if twice_equal else dist <= 4 * noise):
        fail(f"train checkpoint: the restored state's step is {dist} from "
             f"the in-memory one's (two in-memory runs: {noise}, bit for "
             f"bit {twice_equal})")
    return {"meta": meta, "leaves": len(want), "gb": n_bytes / 1e9,
            "save_call_s": save_call_s, "written_s": written_s,
            "restore_s": restore_s, "restored_bit_for_bit": True,
            "step_in_memory_twice_bit_for_bit": twice_equal,
            "step_restored_bit_for_bit": restored_equal,
            "step_in_memory_twice_max_rel": noise,
            "step_restored_max_rel": dist, "metrics": [ma, mb, mr]}


def train_config_step(name: str, cfg) -> dict:
    """(d): one step of cfg (microbatch 2, fp32 gradients through the
    cast) over TRAIN_D_BATCH x TRAIN_D_SEQ tokens: finite loss and
    parameters that moved."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_model(cfg, seed=0, device=DEVICE)
    before = train_tree_clone(params)
    step_fn = api.make_train_step(cfg, TrainConfig(
        microbatch=2, grad_dtype="float32", warmup=2, total_steps=10))
    batch = train_batch(cfg, TRAIN_D_BATCH, TRAIN_D_SEQ)
    t1 = time.perf_counter()
    params, _, m = step_fn(params, adamw_init(params), batch, 2)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    rec = {k: float(v) for k, v in m.items()}
    old = dict(tree_leaves(before))
    moved = sum(float((p - old[k]).abs().sum())
                for k, p in tree_leaves(params))
    finite = all(bool(torch.isfinite(p).all()) for _, p in
                 tree_leaves(params))
    if not (math.isfinite(rec["loss"]) and moved > 0 and finite):
        fail(f"train {name}: loss {rec['loss']}, moved {moved}, "
             f"finite params {finite}")
    return {"phase": "train", "case": "d", "config": name,
            "family": cfg.family, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "params": sum(p.numel() for _, p in tree_leaves(params)),
            "batch": [TRAIN_D_BATCH, TRAIN_D_SEQ], "metrics": rec,
            "moved_abs_sum": moved, "step_s": step_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t0}


def train_phase() -> None:
    """The LM scaffold's training path on the card: (a) qwen2-0.5b at full
    width and depth, bf16 over fp32 masters, 4 steps of 16 x 4,096 tokens;
    (b) memorisation of one batch; (c) fp32 card against the CPU port and
    matmul_f32's backward; (d) the other configs, one step each; (e) the
    Checkpointer on the card.  No hand kernel is on this path: the phase
    launches none."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_params
    from repro_torch.optim import adamw_init

    t_phase = time.perf_counter()
    reset_launches()
    cfg = ARCHS[TRAIN_MODEL]
    torch.cuda.empty_cache()
    params = api.init_model(cfg, seed=0, device=DEVICE)
    opt = adamw_init(params)
    n_params = count_params(tf.model_defs(cfg))
    t0 = time.perf_counter()
    a, params, opt = train_qwen_steps(cfg, params, opt)
    emit({"phase": "train", "case": "a", "config": TRAIN_MODEL,
          "params": n_params, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, **a,
          "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        e = train_checkpoint(cfg, params, opt, tmp)
    del params, opt
    emit({"phase": "train", "case": "e", "config": TRAIN_MODEL, **e,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = api.init_model(cfg, seed=0, device=DEVICE)
    b = train_memorise(cfg, params)
    c = train_card_vs_cpu(cfg, params)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "train", "case": "b_c", "config": TRAIN_MODEL,
          "memorise": b, "card_vs_cpu_fp32": c,
          "matmul_f32_backward": train_matmul_backward(
              cfg, TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ),
          "op_times": train_op_times(cfg, TRAIN_BATCH // TRAIN_MICRO,
                                     TRAIN_SEQ),
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    for name in LM_DEPTH2 + ("hubert-xlarge",):
        dcfg = ARCHS[name]
        dcfg = dataclasses.replace(
            dcfg, num_layers=2 * tf.layers_per_block(dcfg),
            **({"capacity_factor": 16.0} if dcfg.num_experts else {}))
        emit(train_config_step(name, dcfg))
    emit(train_config_step("llama4-maverick-400b-a17b", reduced_config(
        ARCHS["llama4-maverick-400b-a17b"], capacity_factor=16.0)))
    launches = launch_counts()
    if any(launches.values()):
        fail(f"train: the training path launched hand kernels {launches}")
    emit({"phase": "train_summary", "hand_kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------- #
# mesh: the LM scaffold's mesh path (DeviceMesh, DTensor steps, elastic
# recovery) on the card, over an NCCL world of one rank
# ---------------------------------------------------------------------- #
MESH_MODEL = "qwen2-0.5b"                # full width and depth
MESH_PREFILL, MESH_DECODE_STEPS = (8, 2048), 4
# the meshed step against the unmeshed one on a (1, 1) mesh: the same
# kernels but for the loss head's logsumexp (max, exp, sum, log: the
# vocab-sharded form) and the lookups; bf16 activations and gradients
MESH_LOSS_LIMIT = 1e-4          # relative to the loss
MESH_NORM_LIMIT = 1e-3          # relative to grad_norm
# AdamW's moments after two steps of bf16 gradients, relative to max|ref
# leaf|: 4 bf16 ulps (2^-7 relative each).  A leaf whose gradient sums
# several bf16 contributions (the tied embedding: its lookups' and the
# loss head's) sums them in another order on the two paths.
MESH_MOMENT_LIMIT = 4 * 2.0 ** -7
# the step's update p - p0 against the unmeshed one, per leaf,
# |p_m - p_u| / |p_u - p0| in L2: 0 where they agree, 1 where the meshed
# update is lost.  AdamW's first step moves an element by about
# lr·sign(g), and each element whose bf16 g is near 0 and takes the other
# sign adds to it (tests/test_torch_mesh_train.py: the reference's own
# sharded bf16 step reads 0.19 against its single-device step)
MESH_UPDATE_LIMIT = 0.5
MESH_LOGIT_LIMIT = 1e-2         # prefill / decode: relative to max(1, |ref|)
MESH_REPLAY_LIMIT = 1e-4        # the elastic replay's loss (the reference's)


def mesh_tree_err(got, want) -> float:
    """max over leaves of max|got - want| (got may hold DTensors)."""
    from repro_torch.tree import tree_leaves
    g = dict(tree_leaves(got))
    worst = 0.0
    for path, w in tree_leaves(want):
        x = g[path]
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        if w.numel():
            worst = max(worst, float((x.float() - w.float()).abs().max()))
    return worst


def mesh_rel_err(got, want) -> tuple:
    """(max over leaves of max|got - want| / max|want|, the leaf's path);
    0-size and all-zero leaves skipped."""
    from repro_torch.tree import tree_leaves
    g = dict(tree_leaves(got))
    worst = (0.0, None)
    for path, w in tree_leaves(want):
        x = g[path]
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        scale = float(w.float().abs().max()) if w.numel() else 0.0
        if scale:
            err = float((x.float() - w.float()).abs().max()) / scale
            worst = max(worst, (err, "/".join(path)), key=lambda e: e[0])
    return worst


def mesh_update_err(got, want, p0) -> tuple:
    """(max over leaves of |got - want| / |want - p0| in L2, the leaf's
    path): how far got's update from p0 lies from want's."""
    from repro_torch.tree import tree_leaves
    g, z = dict(tree_leaves(got)), dict(tree_leaves(p0))
    worst = (0.0, None)
    for path, w in tree_leaves(want):
        x = g[path]
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        step = float((w.float() - z[path].float()).norm())
        if step:
            err = float((x.float() - w.float()).norm()) / step
            worst = max(worst, (err, "/".join(path)), key=lambda e: e[0])
    return worst


def mesh_step(step_fn, params, opt, batch, i):
    """One step, timed on the host clock between synchronizes: (params,
    opt, metrics as floats, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step_fn(params, opt, batch, i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec = {k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
           for k, v in m.items()}
    if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
        fail(f"mesh: step {i} loss or grad_norm not finite ({rec})")
    return params, opt, rec, dt


def mesh_train(cfg, mesh, tcfg, tmp: str) -> dict:
    """The meshed train step against the unmeshed one from the same
    state and batch (every leaf), a second meshed step timed with its
    peak memory, and the elastic recovery: a checkpoint of the meshed
    state, a step on one microbatch's rows, then run_with_retries over
    that step whose first attempt raises, on_failure restoring the
    checkpoint with restore(shardings=), and the replayed loss against
    the original.  Steps are numbered from 1 (the cosine schedule's lr
    is 0 at step 0)."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import InputShape
    from repro_torch.data import TokenPipeline
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import reshard, run_with_retries
    from repro_torch.tree import tree_map
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    params = api.init_model(cfg, seed=0, device=DEVICE)
    opt = adamw_init(params)
    p_specs = api.model_pspecs(cfg, mesh)
    o_specs = api.opt_pspecs(cfg, mesh)
    p_m = reshard(train_tree_clone(params), mesh, p_specs)
    o_m = reshard(train_tree_clone(opt), mesh, o_specs)
    rows = TRAIN_BATCH // TRAIN_MICRO

    def batch_at(i, meshed, n=TRAIN_BATCH):
        b = {k: torch.as_tensor(v[:n], device=DEVICE)
             for k, v in pipe.global_batch_at(i).items()}
        if not meshed:
            return b
        shape = InputShape("t", TRAIN_SEQ, n, "train")
        return reshard(b, mesh, api.batch_pspecs(cfg, shape, mesh))
    step_u = api.make_train_step(cfg, tcfg)
    step_m = api.make_train_step(cfg, tcfg, mesh)
    out = {"batch": [TRAIN_BATCH, TRAIN_SEQ], "microbatch": tcfg.microbatch,
           "grad_dtype": tcfg.grad_dtype}
    p0 = train_tree_clone(params)
    params, opt, m_u, out["unmeshed_step_s"] = mesh_step(
        step_u, params, opt, batch_at(1, False), 1)
    p_m, o_m, m_m, out["meshed_first_step_s"] = mesh_step(
        step_m, p_m, o_m, batch_at(1, True), 1)
    out.update({
        "unmeshed": m_u, "meshed": m_m,
        "loss_rel_err": abs(m_m["loss"] - m_u["loss"]) / abs(m_u["loss"]),
        "grad_norm_rel_err": abs(m_m["grad_norm"] - m_u["grad_norm"])
        / m_u["grad_norm"],
        "param_max_abs_err": mesh_tree_err(p_m, params),
        "param_limit": 4 * m_u["lr"],
        "update_rel_err": mesh_update_err(p_m, params, p0),
        "m_rel_err": mesh_rel_err(o_m["m"], opt["m"]),
        "v_rel_err": mesh_rel_err(o_m["v"], opt["v"])})
    if out["loss_rel_err"] > MESH_LOSS_LIMIT \
            or out["grad_norm_rel_err"] > MESH_NORM_LIMIT \
            or out["param_max_abs_err"] > out["param_limit"] \
            or out["update_rel_err"][0] > MESH_UPDATE_LIMIT \
            or out["m_rel_err"][0] > MESH_MOMENT_LIMIT \
            or out["v_rel_err"][0] > MESH_MOMENT_LIMIT:
        fail(f"mesh: the meshed train step differs from the unmeshed "
             f"one ({out})")
    del params, opt, p0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p_m, o_m, m_2, out["meshed_step_s"] = mesh_step(
        step_m, p_m, o_m, batch_at(2, True), 2)
    out["meshed_step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # elastic, on one microbatch's rows as a step of its own
    step_r = api.make_train_step(
        cfg, dataclasses.replace(tcfg, microbatch=1), mesh)
    ck = Checkpointer(tmp)
    ck.save(3, {"params": p_m, "opt": o_m}, meta={"step": 3}, async_=False)
    p_m, o_m, m_3, _ = mesh_step(step_r, p_m, o_m, batch_at(3, True, rows),
                                 3)
    template = {"params": p_m, "opt": o_m}
    shardings = {"params": tree_map(lambda s: (mesh, s), p_specs),
                 "opt": tree_map(lambda s: (mesh, s), o_specs)}
    state = {"params": p_m, "opt": o_m}
    attempts = {"n": 0, "restored": 0}

    def attempt():
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("simulated loss of the step's devices")
        return mesh_step(step_r, state["params"], state["opt"],
                         batch_at(3, True, rows), 3)

    def on_failure(_):
        restored, meta = ck.restore(template=template, shardings=shardings)
        state.update(restored)
        attempts["restored"] = meta["step"]
    t0 = time.perf_counter()
    _, _, m_r, _ = run_with_retries(attempt, on_failure=on_failure)
    placed = state["params"]["final_norm"]
    out["elastic"] = {"batch": [rows, TRAIN_SEQ], "attempts": attempts["n"],
                      "restored_step": attempts["restored"],
                      "orig_loss": m_3["loss"], "replay_loss": m_r["loss"],
                      "restored_placements": str(placed.placements),
                      "seconds": time.perf_counter() - t0}
    if attempts["n"] != 2 or \
            abs(m_r["loss"] - m_3["loss"]) > MESH_REPLAY_LIMIT:
        fail(f"mesh: the elastic replay differs ({out['elastic']})")
    return out


def mesh_serve(cfg, mesh) -> dict:
    """Prefill of MESH_PREFILL and MESH_DECODE_STEPS greedy decode steps
    through the meshed functions against the unmeshed ones on the same
    weights, each timed: each prefill after a warm-up call, decode's
    per-step time over the steps after the first."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.models import api
    from repro_torch.runtime import reshard
    b, s = MESH_PREFILL
    shape = InputShape("p", s, b, "prefill")
    cache_len = s + MESH_DECODE_STEPS
    params = api.init_model(cfg, seed=0, device=DEVICE)
    p_m = reshard(params, mesh, api.model_pspecs(cfg, mesh))
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             api.concrete_batch(cfg, shape, seed=3).items()}
    b_m = reshard(batch, mesh, api.batch_pspecs(cfg, shape, mesh))
    out = {"prefill": [b, s], "decode_steps": MESH_DECODE_STEPS,
           "errs": []}

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def err(got, want):
        g = got.full_tensor() if hasattr(got, "full_tensor") else got
        return float((g - want).abs().max()) / max(
            1.0, float(want.abs().max()))
    with torch.no_grad():
        pre_u = api.make_prefill_fn(cfg, cache_len=cache_len)
        pre_m = api.make_prefill_fn(cfg, mesh, cache_len=cache_len)
        timed(pre_u, params, batch)             # warm-ups
        timed(pre_m, p_m, b_m)
        (l_u, c_u), out["unmeshed_prefill_s"] = timed(pre_u, params, batch)
        (l_m, c_m), out["meshed_prefill_s"] = timed(pre_m, p_m, b_m)
        out["errs"].append(err(l_m, l_u))
        dec_u, dec_m = api.make_decode_fn(cfg), api.make_decode_fn(cfg, mesh)
        tok = l_u.argmax(-1)
        t_u, t_m = [], []
        for _ in range(MESH_DECODE_STEPS):
            (l_u, c_u), dt = timed(dec_u, params, c_u, tok)
            t_u.append(dt * 1e3)
            (l_m, c_m), dt = timed(dec_m, p_m, c_m, tok)
            t_m.append(dt * 1e3)
            out["errs"].append(err(l_m, l_u))
            tok = l_u.argmax(-1)
    # the first step of each warms up; the rest are the per-step time
    out["unmeshed_decode_first_ms"], out["meshed_decode_first_ms"] = \
        t_u[0], t_m[0]
    out["unmeshed_decode_ms_per_step"] = sum(t_u[1:]) / len(t_u[1:])
    out["meshed_decode_ms_per_step"] = sum(t_m[1:]) / len(t_m[1:])
    out["max_err"] = max(out["errs"])
    if out["max_err"] > MESH_LOGIT_LIMIT:
        fail(f"mesh: meshed prefill/decode differ from unmeshed ({out})")
    return out


def mesh_phase() -> dict:
    """The LM scaffold's mesh path on the card: qwen2-0.5b at full width
    and depth on make_local_mesh() over an NCCL world of one rank.  A
    prefill and decode steps against the unmeshed ones (decode is
    host-bound), the train phase's step (16 x 4,096, microbatch 4, bf16
    gradients, remat) through make_train_step(cfg, tcfg, mesh) against
    the unmeshed step, and elastic recovery from a checkpoint.  Returns
    what the dryrun phase compares with: the meshed step's seconds and
    peak memory."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    t_phase = time.perf_counter()
    reset_launches()
    cfg = ARCHS[MESH_MODEL]
    tcfg = TrainConfig(grad_dtype="bfloat16", microbatch=TRAIN_MICRO,
                       remat=True, warmup=2, total_steps=100)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(device=DEVICE)
            t0 = time.perf_counter()
            serve = mesh_serve(cfg, mesh)
            emit({"phase": "mesh", "case": "serve", "config": MESH_MODEL,
                  "host": "alone", **serve,
                  "seconds": time.perf_counter() - t0})
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            train = mesh_train(cfg, mesh, tcfg, tmp)
            emit({"phase": "mesh", "case": "train", "config": MESH_MODEL,
                  "mesh": list(mesh.shape), "host": "alone", **train,
                  "seconds": time.perf_counter() - t0})
        finally:
            dist.destroy_process_group()
    launches = launch_counts()
    if any(launches.values()):
        fail(f"mesh: the mesh path launched hand kernels {launches}")
    torch.cuda.empty_cache()
    emit({"phase": "mesh_summary", "backend": "nccl", "world_size": 1,
          "seconds": time.perf_counter() - t_phase})
    return {"step_s": train["meshed_step_s"],
            "peak_gb": train["meshed_step_peak_gb"]}


# ---------------------------------------------------------------------- #
# dryrun: repro_torch.launch.dryrun on the host, and one shard of its
# RDF-h check cell on the card
# ---------------------------------------------------------------------- #
DRYRUN_FLOP_LIMIT = 0.02         # counted FLOPs against train_flops
DRYRUN_PROD_CELLS = (("qwen2-0.5b", "train_4k"),
                     ("llama4-maverick-400b-a17b", "train_4k"))
DRYRUN_RDFH_CELL = ("rdfh-check-phase", "n4M_cap256")
DRYRUN_CELL_TIMEOUT = 600        # seconds a background cell may take
RDFH_SHARD_ROWS, RDFH_CAP, RDFH_J = (1 << 22) // 16, 256, 8


# the profiled step: b x s, and qwen2-0.5b cut to 4 blocks (each block
# runs the same products; a whole step's 10^5 events take ~18 s to read)
DRYRUN_CARD_FLOPS_SHAPE, DRYRUN_CARD_FLOPS_LAYERS = (1, TRAIN_SEQ), 4


def dryrun_card_flops(cfg, b: int, s: int) -> dict:
    """One unmeshed train step of b x s tokens (one microbatch, bf16
    gradients, remat) on the card under torch.profiler: the FLOPs
    (2·m·k·n each) of the aten::mm and aten::bmm calls that launched a
    kernel, from their recorded input shapes, against train_flops'
    step_flop_remat (the recompute skips each block's w2 product) and
    step_flop (4F).  A call that launched none is counted apart: the
    recompute's last product is such a call, stopped by
    torch.utils.checkpoint once the tensors it saves are back, before
    its kernel runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    tcfg = TrainConfig(grad_dtype="bfloat16", microbatch=1, remat=True,
                       warmup=2, total_steps=100)
    params = api.init_model(cfg, seed=0, device=DEVICE)
    opt = adamw_init(params)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in train_batch(cfg, b, s).items()}
    step = api.make_train_step(cfg, tcfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(params, opt, batch, 1)
        torch.cuda.synchronize()

    def launched(ev) -> bool:
        return bool(ev.kernels) or any(launched(c)
                                       for c in ev.cpu_children)
    flops, calls, stopped = 0, {"aten::mm": 0, "aten::bmm": 0}, 0
    stopped_flops = 0
    for ev in prof.events():
        if ev.name not in calls:
            continue
        a, w = ev.input_shapes[:2]
        f = 2 * math.prod(a) * w[-1]
        if launched(ev):
            calls[ev.name] += 1
            flops += f
        else:
            stopped += 1
            stopped_flops += f
    del params, opt, batch, prof
    torch.cuda.empty_cache()
    fl = train_flops(cfg, b, s)
    return {"batch": [b, s], "profiled_flops": flops, "calls": calls,
            "calls_without_kernel": stopped,
            "flops_without_kernel": stopped_flops,
            "step_flop_remat": fl["step_flop_remat"],
            "step_flop": fl["step_flop"],
            "rel_err_remat": abs(flops - fl["step_flop_remat"])
            / fl["step_flop_remat"],
            "rel_err_4f": abs(flops - fl["step_flop"]) / fl["step_flop"]}


def dryrun_local(measured: dict) -> dict:
    """qwen2-0.5b train_4k on a (1, 1) mesh, at the step the mesh phase
    ran (16 x 4,096, microbatch 4, bf16 gradients): the counted FLOPs
    against train_flops' step_flop_remat, and that formula against the
    products a step profiled on the card ran (dryrun_card_flops); the
    predicted peak against the measured one, the roofline time against
    the measured step."""
    import dataclasses
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.launch import dryrun, roofline
    cfg = ARCHS[MESH_MODEL]
    shape = InputShape("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    st = dict(dryrun.cell_settings(MESH_MODEL), microbatch=TRAIN_MICRO,
              grad_dtype="bfloat16")
    with dryrun.fake_world(1):
        mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
        fn, args = dryrun.lower_cell(MESH_MODEL, None, mesh, cfg=cfg,
                                     shape=shape, settings=st)
        sec, memory, a = dryrun.trace(fn, args, True)
    want = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)["step_flop_remat"]
    rec = dryrun.record({"mesh": "single", "model_flops": 0.0}, sec,
                        memory, a)
    card = dryrun_card_flops(
        dataclasses.replace(cfg, num_layers=DRYRUN_CARD_FLOPS_LAYERS),
        *DRYRUN_CARD_FLOPS_SHAPE)
    t = roofline.terms(rec)
    out = {"cell": f"{MESH_MODEL} train_4k cut to {TRAIN_BATCH} x "
                   f"{TRAIN_SEQ}, mesh (1, 1)", "trace_s": sec,
           "flops": a["flops"], "train_flops_step_flop_remat": want,
           "flops_rel_err": abs(a["flops"] - want) / want,
           "predicted_peak_gb": memory["peak_estimate_bytes"] / 1e9,
           "measured_peak_gb": measured["peak_gb"],
           "roofline_s": max(t["compute_s"], t["mem_min_s"], t["coll_s"]),
           "roofline_terms": {k: t[k] for k in ("compute_s", "mem_min_s",
                                                "mem_max_s", "coll_s")},
           "measured_step_s": measured["step_s"],
           "collectives": a["collectives"], "ops": a["ops"],
           "card_profiled": card}
    if out["flops_rel_err"] > DRYRUN_FLOP_LIMIT:
        fail(f"dryrun: counted FLOPs {a['flops']:.4g} against train_flops "
             f"{want:.4g} ({out['flops_rel_err']:.3%})")
    if card["rel_err_remat"] > DRYRUN_FLOP_LIMIT:
        fail(f"dryrun: the card's profiled step FLOPs differ from "
             f"train_flops' step_flop_remat ({card})")
    return out


def dryrun_rdfh_shard(rows: list, cell: dict) -> tuple:
    """One device's shard of the RDF-h check cell on the card: 262,144 x
    256 ids (rows ascending, -1 padding at the tail) and 8 intervals
    through ops.interval_count (csrc/interval_count.cu), held to its plain
    version exactly, as the kernel row interval_count_rdfh_shard."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import roofline
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    n, cap, j = RDFH_SHARD_ROWS, RDFH_CAP, RDFH_J
    ids = torch.randint(0, 1 << 22, (n, cap), generator=gen, device=DEVICE,
                        dtype=torch.int32).sort(dim=1).values
    lens = torch.randint(0, cap + 1, (n, 1), generator=gen, device=DEVICE)
    ids = torch.where(torch.arange(cap, device=DEVICE) < lens, ids, -1)
    lo = torch.randint(0, 1 << 21, (j,), generator=gen, device=DEVICE,
                       dtype=torch.int32)
    hi = lo + torch.randint(1, 1 << 21, (j,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    reset_launches()
    got = ops.interval_count(ids, lo, hi)
    torch.cuda.synchronize()
    launched = dict(ops.cuda_kernels()["interval_count"].entry_launches)
    if launched.get("interval_count", 0) == 0:
        fail("dryrun: the RDF-h shard launched no interval_count entry")
    want = ref.interval_count_ref(ids, lo, hi)
    row = record_row(
        rows, "interval_count_rdfh_shard", "interval_count.cu",
        "src/repro/kernels/interval_count.py:58",
        lambda: ops.interval_count(ids, lo, hi),
        lambda: ref.interval_count_ref(ids, lo, hi), None,
        4 * n * cap + 4 * n * j + 8 * j,
        2 * j * n * math.ceil(math.log2(cap + 1)), (got,), (want,),
        counter="interval_count_rdfh")
    row["shape"] = {"rows": n, "cap": cap, "intervals": j}
    t = roofline.terms({**cell, "model_flops": 0.0})
    out = {"rows": n, "cap": cap, "intervals": j,
           "ids_mb": ids.numel() * 4 / 1e6, "launches": launched,
           "kernel_ms": row["ms"], "bound_ms": row["bound_ms"],
           "plain_ms": row["plain_ms"],
           "dryrun_memory_term_ms": [t["mem_min_s"] * 1e3,
                                     t["mem_max_s"] * 1e3],
           "dryrun_peak_gib": t["peak_gib"]}
    del ids, got, want
    torch.cuda.empty_cache()
    return out, launched["interval_count"]


def dryrun_start(tmp: str) -> list:
    """The production cells and the RDF-h cell, each traced by
    `python -m repro_torch.launch.dryrun` in a process of its own on the
    host at the lowest priority, started before the train phase so that
    they trace while the card runs its steps (they use the host alone;
    the mesh phase's host-bound prefill and decode come after them)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape in DRYRUN_PROD_CELLS + (DRYRUN_RDFH_CELL,):
        out = os.path.join(tmp, f"{arch}_{shape}.json")
        procs.append(((arch, shape), out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=env, preexec_fn=lambda: os.nice(19))))
    return procs


def dryrun_collect(procs) -> dict:
    """{(arch, shape): record} of dryrun_start's cells, each ok, or fail."""
    recs = {}
    for cell, out, proc in procs:
        try:
            _, err = proc.communicate(timeout=DRYRUN_CELL_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"dryrun: {cell} ran past {DRYRUN_CELL_TIMEOUT} s")
        if proc.returncode or not os.path.exists(out):
            fail(f"dryrun: {cell} exited with {proc.returncode}: "
                 f"{err[-2000:]}")
        rec = json.loads(open(out).read())["|".join(cell + ("single",))]
        if rec["status"] != "ok":
            fail(f"dryrun: {cell} {rec['error']}\n{rec['traceback']}")
        recs[cell] = rec
    return recs


def dryrun_phase(rows: list, measured: dict, recs: dict) -> int:
    """The port's dry-run (repro_torch.launch.dryrun) on the host: (1)
    qwen2-0.5b at the mesh phase's step on a (1, 1) mesh against the card
    (FLOPs within 2 % of train_flops); (2) qwen2-0.5b and
    llama4-maverick-400b-a17b train_4k on the (16, 16) production mesh
    at full width, each cell ok (`recs`: dryrun_collect's records of
    dryrun_start's processes);
    (3) the RDF-h check cell on that mesh, and one device's shard of it
    run on the card (the kernel row interval_count_rdfh_shard).  Returns
    that run's interval_count launches."""
    from repro_torch.launch import roofline
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    local = dryrun_local(measured)
    emit({"phase": "dryrun", "part": "local", **local,
          "seconds": time.perf_counter() - t0})
    for arch, shape in DRYRUN_PROD_CELLS:
        rec = recs[(arch, shape)]
        t = roofline.terms(rec)
        emit({"phase": "dryrun", "part": "production", "arch": arch,
              "shape": shape, "mesh": rec["mesh_shape"],
              "settings": rec["settings"], "status": rec["status"],
              "peak_gib": rec["memory"]["peak_estimate_bytes"] / 2**30,
              "flops": rec["analysis"]["flops"],
              "collectives": rec["collectives"],
              "collectives_by_op": rec["analysis"]["collectives_by_op"],
              "roofline": {k: t[k] for k in ("compute_s", "mem_min_s",
                                             "mem_max_s", "coll_s",
                                             "dominant", "useful_ratio")},
              "ops": rec["analysis"]["ops"], "trace_s": rec["lower_s"]})
    t0 = time.perf_counter()
    cell = recs[DRYRUN_RDFH_CELL]
    shard, n_launch = dryrun_rdfh_shard(rows, cell)
    emit({"phase": "dryrun", "part": "rdfh", "cell_status": cell["status"],
          "cell_peak_gib": cell["memory"]["peak_estimate_bytes"] / 2**30,
          "cell_hbm_bytes": cell["analysis"]["hbm_bytes"],
          "cell_collectives": cell["collectives"], **shard,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "dryrun_summary",
          "seconds": time.perf_counter() - t_phase})
    return n_launch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=13.0,
                    help="lubm_like scale of the main path (13: ~1M triples)")
    ap.add_argument("--parity-scale", type=float, default=0.3)
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import torch
        import repro_torch.core  # noqa: F401 (the port is importable)
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA GPU")

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.core import Dataset
    from repro_torch.data import lubm_like

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

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    rows = timed("kernels", kernel_phase, ds, np.random.default_rng(0))
    main_launches, main_runs, conn, common, served = timed(
        "main", main_phase, ds, N_QUERIES)
    rows += timed("main_shape_rows", main_shape_rows, common)
    del common
    timed("serve", serve_phase, ds, served)
    timed("delta", delta_phase, ds, served)
    query0 = served["queries"][0]
    del served
    bloom_launches, bloom_runs = timed("bloom", bloom_phase, ds)
    conn_launches = timed("conn", conn_phase, ds, conn)
    dist_entry = timed("distributed", distributed_phase, ds, query0, rows)
    # each kernel's launches come from the phase that runs its path, and
    # per cold and per warm execution where the path has both; the
    # interval_count entry of interval_count.cu (the engine's check runs
    # its interval_check entry) from the distributed path
    launches = {**{k: main_launches[k] for k in MAIN_KERNELS},
                **{k: bloom_launches[k] for k in BLOOM_KERNELS},
                **{k: conn_launches[k] for k in CONN_KERNELS},
                "interval_count_entry": dist_entry["interval_count"]}
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
    torch.cuda.empty_cache()
    gov_ds, gov_queries = timed("governed", governed_phase)
    timed("delta_rebuild", rebuild_delta, gov_ds, gov_queries)
    del gov_ds, gov_queries
    timed("parity", parity_phase, args.parity_scale)
    timed("examples", examples_phase)
    timed("lm", lm_phase)
    with tempfile.TemporaryDirectory() as tmp:
        procs = dryrun_start(tmp)
        try:
            timed("train", train_phase)
            # the mesh phase runs with the host to itself
            cells = timed("dryrun_wait", dryrun_collect, procs)
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    measured = timed("mesh", mesh_phase)
    rdfh_launches = timed("dryrun", dryrun_phase, rows, measured, cells)
    for row in rows:
        if row.get("counter") == "interval_count_rdfh":
            row.pop("counter")
            row["launches"] = rdfh_launches
    emit({"phase": "seconds", "seconds": seconds,
          "total": time.perf_counter() - t_start})

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
