"""Elastic recovery in the port (runtime.elastic, Checkpointer.restore with
shardings=) in gloo worlds on the CPU, twins of the reference's
tests/test_distributed.py::test_elastic_shrink_and_reshard and
tests/test_elastic_e2e.py.

* shrink and reshard: a world of 8 ranks on a (2, 2, 2) ('pod', 'data',
  'model') mesh; shrink_mesh drops the pod axis (pod 0's ranks, a (2, 2)
  mesh) and reshard places an [8, 4] array on it at PS('data', 'model'):
  the survivors hold it whole.  The same world holds the row-to-rank
  layout of param.placements against the reference's: every rank's block
  of an [8, 4] array at PS(('pod', 'data'), 'model') and at
  PS('model', ('pod', 'data')) is the block that the device at the same
  mesh coordinates holds in the reference (8 forced host devices).
* end to end: reduced qwen2 trains on the (2, 2, 2) mesh of a world of 8
  and checkpoints before step 2 into one directory shared by the ranks
  (rank 0 writes it, the others see it once save returns); a new world of 4 ranks, the survivors,
  builds the shrunk (2, 2) mesh, restores the checkpoint with
  restore(shardings=) and replays step 2 through run_with_retries (its
  first attempt raises): the replayed loss equals the original within
  1e-4 (the reference's bound).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parent.parent / "src")

HEAD = textwrap.dedent("""
    import json, os, sys, numpy as np, torch
    import torch.distributed as dist
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.param import PS
    from repro_torch.runtime import shrink_mesh, reshard, run_with_retries
""")

SHRINK_PROG = HEAD + textwrap.dedent("""
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    blocks = {}
    for key, spec in (("rows", PS(("pod", "data"), "model")),
                      ("cols", PS("model", ("pod", "data")))):
        t = reshard({"x": x}, mesh, {"x": spec})["x"]
        blocks[key] = t.to_local().tolist()
    small = shrink_mesh(mesh, "pod")
    rec = {"coord": mesh.get_coordinate(), "blocks": blocks,
           "names": list(small.mesh_dim_names),
           "ranks": small.mesh.tolist()}
    if rank in small.mesh.flatten().tolist():
        t = reshard({"x": x}, small, {"x": PS("data", "model")})["x"]
        rec["whole"] = bool((t.full_tensor().numpy() == x).all())
        rec["local"] = list(t.to_local().shape)
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)
""")

REF_LAYOUT = textwrap.dedent("""
    import json, numpy as np, jax
    from jax.sharding import NamedSharding, PartitionSpec as PS
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2, 2),
                             ("pod", "data", "model"))
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    out = {}
    for key, spec in (("rows", PS(("pod", "data"), "model")),
                      ("cols", PS("model", ("pod", "data")))):
        a = jax.device_put(x, NamedSharding(mesh, spec))
        coord = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
                 for d in mesh.devices.flat}
        out[key] = {json.dumps(coord[s.device.id]): np.asarray(s.data).tolist()
                    for s in a.addressable_shards}
    print(json.dumps(out))
""")

E2E_COMMON = textwrap.dedent("""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map
    ckdir = sys.argv[5]
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=20)
    pipe = TokenPipeline(cfg.vocab_size, 32, 8, seed=4)
    shape = InputShape("e", 32, 8, "train")

    def batch(i, mesh):
        b = pipe.global_batch_at(i)
        b = {"tokens": torch.as_tensor(b["tokens"]),
             "labels": torch.as_tensor(b["labels"])}
        return reshard(b, mesh, api.batch_pspecs(cfg, shape, mesh))

    def loss_of(m):
        return float(m["loss"].full_tensor())
""")

PHASE1 = HEAD + E2E_COMMON + textwrap.dedent("""
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    params = reshard(api.init_model(cfg, 0, device="cpu"), mesh,
                     api.model_pspecs(cfg, mesh))
    opt = adamw_init(params)          # moments with the params' placements
    assert opt["m"]["embed"].placements == params["embed"].placements
    step = api.make_train_step(cfg, tcfg, mesh)
    ck = Checkpointer(ckdir)          # one directory shared by the ranks
    losses = []
    for i in range(3):
        if i == 2:   # checkpoint BEFORE the step we will replay
            ck.save(2, {"params": params, "opt": opt}, meta={"step": 2},
                    async_=False)
            seen = sorted(os.listdir(ckdir))   # on disk once save returns
        params, opt, m = step(params, opt, batch(i, mesh), i)
        losses.append(loss_of(m))
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"losses": losses, "seen": seen}, f)
""")

PHASE2 = HEAD + E2E_COMMON + textwrap.dedent("""
    from types import SimpleNamespace
    # the lost world's mesh, as the launcher knows it
    lost = SimpleNamespace(mesh=torch.arange(8).reshape(2, 2, 2),
                           mesh_dim_names=("pod", "data", "model"),
                           device_type="cpu")
    small = shrink_mesh(lost, "pod")
    ck = Checkpointer(ckdir)
    template = {"params": api.abstract_model(cfg),
                "opt": api.opt_abstract(cfg, tcfg)}
    specs = {"params": api.model_pspecs(cfg, small),
             "opt": api.opt_pspecs(cfg, small)}
    shardings = tree_map(lambda s: (small, s), specs)
    step = api.make_train_step(cfg, tcfg, small)
    state, tries = {}, []

    def restore(attempt):
        tree, meta = ck.restore(template=template, shardings=shardings)
        state.update(tree, step=meta["step"])

    def attempt():
        tries.append(1)
        if len(tries) == 1:
            raise RuntimeError("the pod's devices are gone")
        return step(state["params"], state["opt"],
                    batch(state["step"], small), state["step"])
    _, _, m = run_with_retries(attempt, on_failure=restore)
    placed = state["params"]["blocks"]["mlp"]["w1"]
    rec = {"replay_loss": loss_of(m), "attempts": len(tries),
           "new_mesh": list(small.shape),
           "placements": repr(tuple(placed.placements)),
           "local": list(placed.to_local().shape)}
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)
""")


def _env(**extra):
    env = dict(os.environ)
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **extra)
    return env


def run_world(prog: str, world: int, tmp: Path, *extra) -> list:
    """prog on every rank of a gloo world; each rank's JSON output."""
    init = f"file://{tmp / f'rendezvous{world}'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", prog, str(r), str(world), init,
         str(tmp / f"w{world}_rank{r}.json"), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return [json.loads((tmp / f"w{world}_rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def shrink_world(tmp_path_factory):
    return run_world(SHRINK_PROG, 8, tmp_path_factory.mktemp("shrink"))


def test_elastic_shrink_and_reshard(shrink_world):
    for rank, rec in enumerate(shrink_world):
        assert rec["names"] == ["data", "model"]
        assert rec["ranks"] == [[0, 1], [2, 3]]         # pod 0's ranks
        if rank < 4:
            assert rec["whole"] and rec["local"] == [4, 2]
        else:
            assert "whole" not in rec


def test_placements_lay_rows_out_as_the_reference(shrink_world):
    out = subprocess.run(
        [sys.executable, "-c", REF_LAYOUT], capture_output=True, text=True,
        timeout=300,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for rec in shrink_world:
        key = json.dumps(rec["coord"])
        for layout in ("rows", "cols"):
            assert rec["blocks"][layout] == want[layout][key], (layout, key)


def test_elastic_restart_after_pod_loss(tmp_path):
    ck = tmp_path / "ck"
    first = run_world(PHASE1, 8, tmp_path, str(ck))
    losses = first[0]["losses"]
    assert all(r["losses"] == losses for r in first)
    assert all(l == l and abs(l) < 1e3 for l in losses)     # finite
    # rank 0 wrote the one checkpoint; every rank saw it when save returned
    assert all(r["seen"] == ["step_0000000002"] for r in first)
    second = run_world(PHASE2, 4, tmp_path, str(ck))
    for r in second:
        assert r["attempts"] == 2
        assert r["new_mesh"] == [2, 2]
        # restored sharded: w1 [L, d, ff] with ff over 'model'
        assert r["placements"] == "(Replicate(), Shard(dim=2))"
        # same global batch + restored state -> identical replayed loss
        assert abs(r["replay_loss"] - losses[2]) < 1e-4, (r, losses)
