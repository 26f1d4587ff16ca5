"""One dry-run cell: the reference's compiled count beside the port's trace.

Lowers and compiles the reference's qwen2-0.5b train_4k cell
(repro.launch.dryrun.lower_cell) on a mesh of forced host devices built
with Auto axes (this JAX's default Explicit axes make the reference's
with_sharding_constraint raise), reads its per-device FLOPs, collectives
and memory with repro.launch.hlo_analysis, then traces the port's same
cell on a fake process group of as many ranks (repro_torch.launch.dryrun)
and prints both, with the port's collectives split by issuer:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/dryrun_reference_cell.py \
        [--mesh 16,16] [--reduced SEQ,BATCH,MICROBATCH]

The default is the full cell on (16, 16): 256 host devices, a compile of
the full-width step on the host (minutes and tens of GB).  --reduced runs
the same step at reduced_config with SEQ x BATCH tokens and MICROBATCH
microbatches instead (--mesh 4,2 --reduced 32,8,2, seconds: the cell
tests/test_torch_dryrun.py holds the port's collectives to).  The last
line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from torch.distributed.device_mesh import DeviceMesh

ARCH, SHAPE = "qwen2-0.5b", "train_4k"


def reference_cell(mesh_shape, reduced) -> dict:
    """The reference's lower, compile and analysis of the cell."""
    # first: importing it sets XLA_FLAGS for 512 host devices before jax
    from repro.launch import dryrun as jdry
    import jax
    from jax.sharding import AxisType
    from repro.configs import reduced_config
    from repro.configs.base import InputShape
    from repro.launch import hlo_analysis

    if reduced:
        seq, batch, mb = reduced
        full = jdry.get_config
        jdry.get_config = lambda a: reduced_config(full(a))
        jdry.SHAPES = dict(jdry.SHAPES)
        jdry.SHAPES[SHAPE] = InputShape(SHAPE, seq, batch, "train")
        settings = jdry.cell_settings
        jdry.cell_settings = lambda a: dict(settings(a), microbatch=mb)
    n = 1
    for d in mesh_shape:
        n *= d
    names = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    mesh = jax.make_mesh(tuple(mesh_shape), names,
                         axis_types=(AxisType.Auto,) * len(mesh_shape),
                         devices=jax.devices()[:n])
    t0 = time.perf_counter()
    with mesh:
        jitted, args = jdry.lower_cell(ARCH, SHAPE, mesh)
        lowered = jitted.lower(*args)
        t1 = time.perf_counter()
        compiled = lowered.compile()
    t2 = time.perf_counter()
    a = hlo_analysis.analyze(compiled.as_text())
    return {"lower_s": t1 - t0, "compile_s": t2 - t1,
            "memory": jdry.memory_stats(compiled),
            "flops": a["flops"], "collectives": a["collectives"],
            "collective_bytes": a["collective_bytes"],
            "model_flops": jdry.model_flops(ARCH, jdry.SHAPES[SHAPE]) if not reduced
            else None}


def port_cell(mesh_shape, reduced) -> dict:
    """The port's trace of the same cell on a fake process group."""
    import torch
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, op_analysis

    kw = {}
    if reduced:
        seq, batch, mb = reduced
        kw = dict(cfg=reduced_config(ARCHS[ARCH]),
                  shape=InputShape(SHAPE, seq, batch, "train"),
                  settings=dict(dryrun.cell_settings(ARCH), microbatch=mb))
    n = 1
    for d in mesh_shape:
        n *= d
    names = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    with dryrun.fake_world(n):
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(*mesh_shape),
                          mesh_dim_names=names)
        fn, args = dryrun.lower_cell(ARCH, SHAPE, mesh, **kw)
        sec, memory, a = dryrun.trace(fn, args, True)
        param_bytes = op_analysis.local_bytes(args[0])
    cfg = kw.get("cfg") or ARCHS[ARCH]
    return {"trace_s": sec, "memory": memory, "flops": a["flops"],
            "collectives": a["collectives"],
            "collective_bytes": a["collective_bytes"],
            "collectives_by_op": a["collectives_by_op"],
            # a device's parameter bytes, and the widths the collectives
            # scale with
            "param_bytes": param_bytes,
            "cfg": {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
                    "vocab_size": cfg.vocab_size,
                    "loss_chunk": cfg.loss_chunk,
                    "tie_embeddings": cfg.tie_embeddings}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="16,16")
    ap.add_argument("--reduced", default=None,
                    help="SEQ,BATCH,MICROBATCH at reduced_config")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    reduced = tuple(int(x) for x in args.reduced.split(",")) \
        if args.reduced else None
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    ref = reference_cell(mesh_shape, reduced)
    port = port_cell(mesh_shape, reduced)
    out = {"arch": ARCH, "shape": SHAPE, "mesh": list(mesh_shape),
           "reduced": reduced, "reference": ref, "port": port,
           "flops_ratio": port["flops"] / ref["flops"],
           "collective_bytes_ratio": port["collective_bytes"]
           / max(ref["collective_bytes"], 1.0)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
