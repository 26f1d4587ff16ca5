"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes at full width, and record per-device memory, FLOPs,
bytes and collectives.

The reference lowers and compiles each cell with XLA on 512 forced host
devices.  Here each cell runs once, eagerly, in a fake world: a
torch.distributed process group of backend "fake" (FakeStore) with 256
or 512 ranks of which this process is rank 0, the production DeviceMesh
over it, and every parameter, optimizer state, batch and cache a meta
DTensor placed by the pspec trees — shapes without memory, so llama4 at
full width traces on a host.  The step's local ops and collectives are
counted by op_analysis.OpCounter (per device).

memory.peak_estimate_bytes is the reference's argument + output + temp -
alias, read as: the local shards of the arguments (exact from their
placements) plus the largest sum of the storages that the step's ops
allocated and that were alive at once (outputs included; in-place
updates of donated arguments allocate nothing, which is the alias term).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --both-meshes
  python -m repro_torch.launch.dryrun --arch rdfh-check-phase --shape n4M_cap256
--all traces every supported cell and the RDF-h check cell, each in a
process of its own (JOBS at a time, each stopped after CELL_TIMEOUT_S).
Results are written incrementally to --out (JSON), keyed by cell id.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCHS, SHAPES, get_config, supported_shapes
from ..configs.base import TrainConfig, InputShape
from ..models import api
from ..models.param import PS
from ..runtime.elastic import reshard
from .mesh import make_production_mesh
from . import op_analysis


# Per-arch training settings chosen for single-pod memory feasibility
# (the reference's).
TRAIN_SETTINGS: dict[str, dict] = {
    "llama4-maverick-400b-a17b": dict(zero3=True, microbatch=8,
                                      opt_state_dtype="bfloat16",
                                      grad_dtype="bfloat16",
                                      param_dtype="bfloat16"),
    "starcoder2-15b": dict(zero3=True, microbatch=8),
    "granite-moe-1b-a400m": dict(grad_dtype="bfloat16"),
    "minitron-8b": dict(zero3=True, microbatch=4),
    "rwkv6-7b": dict(zero3=True, microbatch=4,
                     cfg_overrides={"rwkv_chunk": 64}),
    "paligemma-3b": dict(microbatch=2),
    "hubert-xlarge": dict(microbatch=2),
    "hymba-1.5b": dict(microbatch=2),
    "stablelm-1.6b": dict(microbatch=2),
}

CHIPS = {"single": 256, "multi": 512}
# the paper's check phase, a cell of --all beside the architectures'
RDFH_CELL = ("rdfh-check-phase", "n4M_cap256")
# --all traces each cell in a process of its own, JOBS at a time, and
# stops a trace that runs past CELL_TIMEOUT_S seconds
JOBS, CELL_TIMEOUT_S = 8, 1800


def cell_settings(arch: str) -> dict:
    s = dict(zero3=False, microbatch=1, opt_state_dtype="float32",
             grad_dtype="float32", param_dtype=None)
    s.update(TRAIN_SETTINGS.get(arch, {}))
    return s


def cell_config(arch: str):
    cfg = get_config(arch)
    st = cell_settings(arch)
    if st.get("param_dtype"):
        cfg = dataclasses.replace(cfg, param_dtype=st["param_dtype"])
    if st.get("cfg_overrides"):
        cfg = dataclasses.replace(cfg, **st["cfg_overrides"])
    return cfg


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of `world` ranks (this process is
    rank 0): collectives return at once, and on meta tensors move
    nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------- #
def lower_cell(arch: str, shape_name: str, mesh, *, cfg=None, shape=None,
               settings=None):
    """(step function, its arguments as meta DTensors on `mesh`) of one
    cell: the reference's lower_cell, traced in place of jit-lowered.
    cfg / shape / settings override the cell's (a smaller size of the
    same step)."""
    cfg = cfg or cell_config(arch)
    shape = shape or SHAPES[shape_name]
    st = settings or cell_settings(arch)
    p_specs = api.model_pspecs(cfg, mesh, zero3=st["zero3"])
    params = reshard(api.abstract_model(cfg), mesh, p_specs)
    if shape.kind == "train":
        tcfg = TrainConfig(microbatch=st["microbatch"], zero3=st["zero3"],
                           opt_state_dtype=st["opt_state_dtype"],
                           grad_dtype=st["grad_dtype"])
        fn = api.make_train_step(cfg, tcfg, mesh)
        opt = reshard(api.opt_abstract(cfg, tcfg), mesh,
                      api.opt_pspecs(cfg, mesh, zero3=st["zero3"]))
        batch = reshard(api.batch_abstract(cfg, shape), mesh,
                        api.batch_pspecs(cfg, shape, mesh))
        args = (params, opt, batch, 0)
    elif shape.kind == "prefill":
        cache_len = shape.seq_len + api.DECODE_PAD \
            if cfg.attn_type != "sliding" else api.decode_cache_len(cfg, shape)
        fn = api.make_prefill_fn(cfg, mesh, cache_len=cache_len)
        batch = reshard(api.batch_abstract(cfg, shape), mesh,
                        api.batch_pspecs(cfg, shape, mesh))
        args = (params, batch)
    else:  # decode
        fn = api.make_decode_fn(cfg, mesh)
        cache = reshard(api.cache_abstract(cfg, shape), mesh,
                        api.cache_pspecs(cfg, mesh, shape.global_batch,
                                         api.decode_cache_len(cfg, shape)))
        tokens = reshard(api.batch_abstract(cfg, shape), mesh,
                         api.batch_pspecs(cfg, shape, mesh))["tokens"]
        args = (params, cache, tokens)
    return fn, args


def model_flops(arch: str, shape: InputShape) -> float:
    """Analytic 'useful' FLOPs for the MODEL_FLOPS/counted-FLOPs ratio."""
    cfg = get_config(arch)
    n = cfg.num_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def trace(fn, args, train: bool) -> tuple:
    """Run fn(*args) once under an OpCounter, recording gradients for a
    train step only: (seconds, memory record, analysis)."""
    t0 = time.perf_counter()
    with torch.enable_grad() if train else torch.no_grad():
        _, a = op_analysis.analyze(fn, *args)
    arg_bytes = op_analysis.local_bytes(args)
    memory = {"argument_size_in_bytes": arg_bytes,
              "temp_size_in_bytes": a["peak_intermediate_bytes"],
              "peak_estimate_bytes": arg_bytes + a["peak_intermediate_bytes"]}
    return time.perf_counter() - t0, memory, a


def record(rec: dict, seconds: float, memory: dict, a: dict) -> dict:
    """The reference's record keys: lower_s is the trace's seconds,
    compile_s 0 (nothing is compiled), cost the counted FLOPs and
    bytes, collectives the per-kind counts with their total."""
    rec.update({
        "lower_s": round(seconds, 2), "compile_s": 0.0, "memory": memory,
        "cost": {"flops": a["flops"], "bytes accessed": a["hbm_bytes"]},
        "collectives": {**a["collectives"],
                        "total_bytes": a["collective_bytes"]},
        "analysis": a, "hlo_bytes": None, "status": "ok"})
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    with fake_world(CHIPS[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device="cpu")
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "mesh_shape": list(mesh.shape),
               "settings": cell_settings(arch)}
        fn, args = lower_cell(arch, shape_name, mesh)
        record(rec, *trace(fn, args, SHAPES[shape_name].kind == "train"))
    rec["model_flops"] = model_flops(arch, SHAPES[shape_name])
    return rec


# ---------------------------------------------------------------------- #
def all_cells(mesh_kinds=("single", "multi")):
    for arch, cfg in ARCHS.items():
        for shape in supported_shapes(cfg):
            for mk in mesh_kinds:
                yield arch, shape.name, mk


def _run_one(cell) -> dict:
    """One cell's record, or its error with the traceback's tail."""
    arch, shape, mk = cell
    try:
        if (arch, shape) == RDFH_CELL:
            return run_rdfh_cell(mk)
        return run_cell(arch, shape, mk)
    except Exception as e:                               # noqa: BLE001
        return {"arch": arch, "shape": shape, "mesh": mk, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _run_apart(cells):
    """Each cell in a process of its own (a fresh fake world), JOBS at a
    time; yields (cell, record).  A cell still running after
    CELL_TIMEOUT_S seconds is stopped and recorded as an error that says
    so."""
    import os
    import subprocess
    import sys
    import tempfile
    pending = list(cells)
    running = []
    with tempfile.TemporaryDirectory() as tmp:
        while pending or running:
            while pending and len(running) < JOBS:
                cell = pending.pop(0)
                out = os.path.join(tmp, f"{len(pending)}_{os.getpid()}.json")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", cell[0], "--shape", cell[1], "--mesh",
                     cell[2], "--out", out],
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True)
                running.append((cell, proc, out, time.monotonic()))
            time.sleep(0.5)
            for item in list(running):
                cell, proc, out, t0 = item
                late = time.monotonic() - t0 > CELL_TIMEOUT_S
                if proc.poll() is None and not late:
                    continue
                running.remove(item)
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                    rec = {"status": "error", "error":
                           f"stopped: the trace ran past {CELL_TIMEOUT_S} s"}
                elif os.path.exists(out):
                    rec = json.loads(Path(out).read_text())["|".join(cell)]
                else:
                    rec = {"status": "error", "error": "the cell's process "
                           f"exited with {proc.returncode}: "
                           + proc.stderr.read()[-1500:]}
                rec.setdefault("arch", cell[0])
                rec.setdefault("shape", cell[1])
                rec.setdefault("mesh", cell[2])
                yield cell, rec


def _report(key: str, rec: dict) -> None:
    if rec["status"] != "ok":
        print(f"[cell] {key}  ERROR: {rec['error'][:300]}", flush=True)
        return
    mem = rec["memory"]["peak_estimate_bytes"]
    print(f"[cell] {key}  ok: trace {rec['lower_s']}s"
          f" flops={rec['cost']['flops']:.3g}"
          f" peak/dev={mem / 2**30:.2f}GiB"
          f" coll={rec['collectives']['total_bytes'] / 2**20:.1f}MiB",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    if args.all:
        kinds = ("single", "multi") if args.both_meshes else (args.mesh,)
        cells = list(all_cells(kinds)) + [RDFH_CELL + (mk,) for mk in kinds]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.mesh)]
    todo = []
    for cell in cells:
        key = "|".join(cell)
        if args.skip_done and results.get(key, {}).get("status") == "ok":
            print(f"[skip] {key}")
        else:
            todo.append(cell)

    if args.all:
        runs = _run_apart(todo)
    else:
        runs = ((cell, _run_one(cell)) for cell in todo)
    for cell, rec in runs:
        key = "|".join(cell)
        _report(key, rec)
        results[key] = rec
        out_path.write_text(json.dumps(results, indent=1))
    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    print(f"done: {n_ok}/{len(results)} cells ok -> {out_path}")


# ---------------------------------------------------------------------- #
# Beyond the architecture cells: the paper's own check phase on the
# production mesh — node rows of the NI tensor sharded over 'data',
# intervals replicated, per-shard interval counting, global candidate
# count as a sum over the shards.
# ---------------------------------------------------------------------- #
def lower_rdfh_check(mesh, n_nodes: int = 1 << 22, cap: int = 256,
                     j: int = 8):
    """(check step, its arguments as meta DTensors): ids [n_nodes, cap]
    int32 with rows over 'data' (('pod', 'data') on the multi-pod mesh),
    lo / hi / need [j] replicated.  The step returns each row's ok and
    their count."""
    from torch.distributed.tensor import Replicate, Shard
    from ..kernels import ref as kref
    from ..models.nn_ops import per_shard

    rows = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    out_pl = [Replicate() if n == "model" else Shard(0)
              for n in mesh.mesh_dim_names]

    def check_step(ids, lo, hi, need):
        cnt = per_shard(kref.interval_count_ref, out_pl, ids, lo, hi)
        ok = (cnt >= need[None, :]).all(dim=1)
        total = ok.sum()                        # a partial sum per shard
        return ok, total.redistribute(mesh, [Replicate()] * mesh.ndim)

    meta = {"ids": torch.empty((n_nodes, cap), dtype=torch.int32,
                               device="meta")}
    meta.update({k: torch.empty((j,), dtype=torch.int32, device="meta")
                 for k in ("lo", "hi", "need")})
    placed = reshard(meta, mesh, {"ids": PS(rows), "lo": PS(), "hi": PS(),
                                  "need": PS()})
    return check_step, (placed["ids"], placed["lo"], placed["hi"],
                        placed["need"])


def run_rdfh_cell(mesh_kind: str) -> dict:
    with fake_world(CHIPS[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device="cpu")
        rec = {"arch": "rdfh-check-phase", "shape": "n4M_cap256",
               "mesh": mesh_kind, "mesh_shape": list(mesh.shape),
               "settings": {}}
        fn, args = lower_rdfh_check(mesh)
        record(rec, *trace(fn, args, False))
    rec["model_flops"] = 0.0
    return rec


if __name__ == "__main__":
    main()
