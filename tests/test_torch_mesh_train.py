"""The port's sharded train, prefill and decode steps (DTensor on a torch
DeviceMesh) against the reference's sharded steps (GSPMD).

The port runs in one gloo world of 8 ranks on the CPU (a subprocess per
rank, a ``file://`` rendezvous); each case builds its own mesh over the
world.  The reference runs as ``tests/test_distributed.py`` runs it, in a
subprocess with 8 forced host devices, on meshes with ``Auto`` axes (this
JAX's ``jax.make_mesh`` makes ``Explicit`` axes, which the reference's
sharding constraints refuse).  Both start from the reference's weights
(``init_model(cfg, 0)``, carried as numpy) and the same numpy batch.

Cases: reduced stablelm on (4, 2) (heads over 'model'); reduced qwen2
with 6 heads on (2, 4) (6 % 4 != 0: the context-parallel branch);
reduced granite-moe on (4, 2) (4 data shards, each with its own
capacity, tokens dropped); reduced stablelm in bf16 on (4, 2) with
microbatch 2 and bf16 gradients, whose microbatches must each lie on all
4 data ranks.

Each runs one train step at step index 50 (the cosine schedule's lr is 0
at step 0, which would leave the parameters where they were).  Bounds:
the reference's own (tests/test_distributed.py: loss 1e-3, parameters
5e-3 absolute), grad_norm 1e-3 relative, and the gradients through
AdamW's first moment (0.1·g) per leaf relative to max|ref leaf|: 1e-4
in fp32, 4 bf16 ulps (2^-5) with bf16 gradients.  Readings seen: fp32
loss within 9.6e-7, grad_norm 2.1e-7 relative, parameters 8.3e-6,
moments 8.8e-7; bf16 loss 4.4e-5, grad_norm 1.9e-4, parameters 3.0e-4
(2·lr: AdamW's first step moves an element by lr·sign(g), and g near 0
takes either sign), moments 1.29e-2.  The update p - p0 against the
reference's, per leaf (UPDATE_LIMIT: 1e-2 fp32, 0.5 bf16; a lost update
reads 1): read 3.0e-4 fp32, 0.111 bf16 (the reference's own sharded step
against its single-device step: 1.0e-4 fp32, 0.190 bf16).  MoE drop
fractions must be equal.
The meshed prefill and decode are held to the unmeshed port on the same
weights: logits within 1e-4 (fp32; read 2.7e-7).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parent.parent / "src")

# name, overrides, mesh (data, model), microbatch, grad dtype, batch
CASES = [
    ("stablelm-1.6b", {}, (4, 2), 1, "float32", 4),
    ("qwen2-0.5b", {"num_heads": 6}, (2, 4), 1, "float32", 4),
    ("granite-moe-1b-a400m", {"capacity_factor": 1.0}, (4, 2), 1,
     "float32", 4),
    ("stablelm-1.6b", {"dtype": "bfloat16"}, (4, 2), 2, "bfloat16", 8),
]
SEQ = 32
STEP = 50        # the step's index: the cosine schedule's lr is 0 at 0
# AdamW's first moment after one step is 0.1·g: the gradients, held per
# leaf relative to max|ref leaf|: fp32 to 1e-4 (tests/test_torch_lm_train
# .py's bound), bf16 gradients to 4 bf16 ulps (2^-7 each)
M_LIMIT = {"float32": 1e-4, "bfloat16": 4 * 2.0 ** -7}
# the step's update p - p0 against the reference's, per leaf, as
# |(p - p0) - (p_ref - p0)| / |p_ref - p0| in L2: 0 where the updates
# agree, 1 where the update is lost.  AdamW's first step moves an element
# by about lr·sign(g), so each element whose g is near 0 and takes the
# other sign adds to it: with bf16 gradients the reference's own sharded
# step reads 0.19 against its single-device step
UPDATE_LIMIT = {"float32": 1e-2, "bfloat16": 0.5}

REF_PROG = textwrap.dedent("""
    import json, sys, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS, AxisType
    from repro.configs import ARCHS, reduced_config
    from repro.configs.base import InputShape, TrainConfig
    from repro.models import api
    from repro.optim import adamw_init
    cases, seq, out = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    STEP = int(sys.argv[4])
    res = []
    for i, (name, over, mshape, mb, gdt, b) in enumerate(cases):
        cfg = reduced_config(ARCHS[name], **over)
        tcfg = TrainConfig(microbatch=mb, grad_dtype=gdt)
        shape = InputShape("s", seq, b, "train")
        params = api.init_model(cfg, 0)
        batch = api.concrete_batch(cfg, shape, seed=2)
        opt = adamw_init(params)
        flat = {"/".join(str(k.key) for k in p): np.asarray(x)
                for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
        np.savez(f"{out}/params{i}.npz", **flat)
        p1, _, m1 = jax.jit(api.make_train_step(cfg, tcfg, None))(
            params, opt, batch, STEP)
        mesh = jax.make_mesh(tuple(mshape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda x: isinstance(x, PS))
        with mesh:
            step = jax.jit(api.make_train_step(cfg, tcfg, mesh),
                           in_shardings=(ns(api.model_pspecs(cfg, mesh)),
                                         ns(api.opt_pspecs(cfg, mesh)),
                                         ns(api.batch_pspecs(cfg, shape,
                                                             mesh)),
                                         NamedSharding(mesh, PS())))
            p2, o2, m2 = step(params, opt, batch, STEP)
        for name, tree in (("ref_after", p2), ("ref_m", o2["m"]),
                           ("ref_single", p1)):
            flat2 = {"/".join(str(k.key) for k in p): np.asarray(
                         x.astype(jnp.float32))
                     for p, x in jax.tree_util.tree_flatten_with_path(
                         tree)[0]}
            np.savez(f"{out}/{name}{i}.npz", **flat2)
        res.append({"single": {k: float(v) for k, v in m1.items()},
                    "sharded": {k: float(v) for k, v in m2.items()}})
    print(json.dumps(res))
""")

PORT_PROG = textwrap.dedent("""
    import json, sys, numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    rank, world, init, out, cases, seq, ref, STEP = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        json.loads(sys.argv[5]), int(sys.argv[6]), sys.argv[7],
        int(sys.argv[8]))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import reshard
    from repro_torch.tree import tree_from_leaves, tree_leaves, tree_map

    def load(path):
        z = np.load(path)
        return tree_from_leaves({tuple(k.split("/")): torch.from_numpy(
            z[k].copy()) for k in z.files})

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def diff(a, b):
        fa = dict(tree_leaves(a))
        return max(float((full(fa[p]).float() - full(x).float()).abs()
                         .max()) for p, x in tree_leaves(b) if x.numel())

    def rel_diff(a, b):   # max over leaves of max|a - b| / max|b|
        fa = dict(tree_leaves(a))
        return max(float((full(fa[p]).float() - x).abs().max())
                   / float(x.abs().max())
                   for p, x in tree_leaves(b) if x.numel() and x.abs().max())

    def update_err(a, b, p0):
        # max over leaves of |(a - p0) - (b - p0)| / |b - p0| (L2 norms):
        # near 0 where a's update is b's, 1 where a's update is lost
        fa, f0 = dict(tree_leaves(a)), dict(tree_leaves(p0))
        out = 0.0
        for p, x in tree_leaves(b):
            step = float((full(x).float() - f0[p].float()).norm())
            if step:
                out = max(out, float((full(fa[p]).float()
                                      - full(x).float()).norm()) / step)
        return out
    res = []
    for i, (name, over, mshape, mb, gdt, b) in enumerate(cases):
        cfg = reduced_config(ARCHS[name], **over)
        tcfg = TrainConfig(microbatch=mb, grad_dtype=gdt)
        shape = InputShape("s", seq, b, "train")
        params = load(f"{ref}/params{i}.npz")
        p0 = load(f"{ref}/params{i}.npz")
        batch = api.concrete_batch(cfg, shape, seed=2)
        mesh = make_local_mesh(model=mshape[1], device="cpu")
        p1 = tree_map(torch.clone, params)
        p1, _, m1 = api.make_train_step(cfg, tcfg)(
            p1, adamw_init(p1), batch, STEP)
        p2 = reshard(params, mesh, api.model_pspecs(cfg, mesh))
        o2 = reshard(adamw_init(params), mesh, api.opt_pspecs(cfg, mesh))
        b2 = reshard({k: torch.as_tensor(v) for k, v in batch.items()},
                     mesh, api.batch_pspecs(cfg, shape, mesh))
        rec = {}
        if mb > 1:
            shd = api.make_sharder(cfg, mesh)
            mbs = api._split_rows(b2, mb, shd)
            rec["microbatch_placements"] = [
                [repr(p) for p in m["tokens"].placements] for m in mbs]
            rec["microbatch_local_rows"] = [
                m["tokens"].to_local().shape[0] for m in mbs]
        p2, o2, m2 = api.make_train_step(cfg, tcfg, mesh)(p2, o2, b2, STEP)
        rec.update({
            "single": {k: float(v) for k, v in m1.items()},
            "sharded": {k: float(full(v)) for k, v in m2.items()},
            "vs_ref": diff(p2, load(f"{ref}/ref_after{i}.npz")),
            "m_vs_ref": rel_diff(o2["m"], load(f"{ref}/ref_m{i}.npz")),
            "vs_single": diff(p2, p1),
            "update_vs_ref": update_err(
                p2, load(f"{ref}/ref_after{i}.npz"), p0),
            "update_vs_single": update_err(p2, p1, p0),
            "ref_update_vs_single": update_err(
                load(f"{ref}/ref_after{i}.npz"),
                load(f"{ref}/ref_single{i}.npz"), p0),
            "param_placements": str(p2["blocks"]["attn" if "attn" in
                                    p2["blocks"] else "attn0"]["wq"]
                                    .placements)})
        if i < 2:       # prefill and 2 decode steps, meshed vs unmeshed
            ps = InputShape("p", seq, 4, "prefill")
            pb = api.concrete_batch(cfg, ps, seed=3)
            cl = seq + 8
            with torch.no_grad():
                l1, c1 = api.make_prefill_fn(cfg, cache_len=cl)(params, pb)
                pd = reshard(params, mesh, api.model_pspecs(cfg, mesh))
                bd = reshard({k: torch.as_tensor(v) for k, v in pb.items()},
                             mesh, api.batch_pspecs(cfg, ps, mesh))
                l2, c2 = api.make_prefill_fn(cfg, mesh, cache_len=cl)(pd, bd)
                errs = [float((full(l2) - l1).abs().max())]
                dec1 = api.make_decode_fn(cfg)
                dec2 = api.make_decode_fn(cfg, mesh)
                tok = l1.argmax(-1)
                for _ in range(2):
                    l1, c1 = dec1(params, c1, tok)
                    l2, c2 = dec2(pd, c2, tok)
                    errs.append(float((full(l2) - l1).abs().max()))
                    tok = l1.argmax(-1)
                rec["serve_errs"] = errs
                rec["cache_placements"] = str(
                    c2["blocks"]["k"].placements)
        res.append(rec)
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
""")


def _env(**extra):
    env = dict(os.environ)
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    cases = json.dumps(CASES)
    ref = subprocess.run(
        [sys.executable, "-c", REF_PROG, cases, str(SEQ), str(tmp),
         str(STEP)],
        capture_output=True, text=True, timeout=600,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT_PROG, str(r), "8", init,
         str(tmp / "port.json"), cases, str(SEQ), str(tmp), str(STEP)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in range(8)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    got = json.loads((tmp / "port.json").read_text())
    return want, got


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{c[2][0]}x{c[2][1]}-mb{c[3]}"
                              for c in CASES])
def test_sharded_train_step_matches_reference(case, runs):
    want, got = runs
    w, g = want[case], got[case]
    assert abs(g["sharded"]["loss"] - w["sharded"]["loss"]) < 1e-3, (w, g)
    assert abs(g["sharded"]["grad_norm"] - w["sharded"]["grad_norm"]) \
        < 1e-3 * w["sharded"]["grad_norm"], (w, g)
    assert g["vs_ref"] < 5e-3, g
    assert g["m_vs_ref"] < M_LIMIT[CASES[case][4]], g
    assert g["update_vs_ref"] < UPDATE_LIMIT[CASES[case][4]], g
    if "moe_drop" not in w["sharded"]:
        # the meshed step against the port's own single-device step
        assert abs(g["sharded"]["loss"] - g["single"]["loss"]) < 1e-3, g
        assert g["vs_single"] < 5e-3, g
        assert g["update_vs_single"] < UPDATE_LIMIT[CASES[case][4]], g
        return
    assert w["sharded"]["moe_drop"] > 0, w              # drops happen
    for run in ("sharded", "single"):
        assert g[run]["moe_drop"] == pytest.approx(
            w[run]["moe_drop"], abs=1e-7), (run, w, g)
    # 4 data shards, each with its own capacity, drop other tokens than
    # one shard over every token: the losses differ, in both designs
    assert g["sharded"]["moe_drop"] != g["single"]["moe_drop"]


def test_heads_or_sequence_over_model(runs):
    """stablelm's 4 heads shard over a model axis of 2; qwen2's 6 heads
    do not over 4, so its q weights stay whole there (context
    parallel)."""
    _, got = runs
    assert got[0]["param_placements"] == "(Replicate(), Shard(dim=2))"
    assert got[1]["param_placements"] == "(Replicate(), Replicate())"


def test_microbatches_spread_over_data_ranks(runs):
    """Microbatch 2 of 8 rows: each microbatch's 4 rows lie one on each
    of the 4 data ranks, not on the 2 ranks a contiguous slice of the
    data-sharded batch would hold."""
    _, got = runs
    g = got[3]
    assert g["microbatch_placements"] == \
        [["Shard(dim=0)", "Replicate()"]] * 2
    assert g["microbatch_local_rows"] == [1, 1]


@pytest.mark.parametrize("case", [0, 1], ids=["tp", "context-parallel"])
def test_meshed_prefill_and_decode_match_unmeshed(case, runs):
    _, got = runs
    g = got[case]
    assert max(g["serve_errs"]) < 1e-4, g
    # the prefill cache is sharded over the sequence by 'model'
    assert "Shard(dim=3)" in g["cache_placements"], g
