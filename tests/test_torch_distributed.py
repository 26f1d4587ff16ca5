"""``repro_torch.core.distributed`` against ``repro.core.distributed``.

The port's ``shard_check`` and ``gather_candidates`` run in gloo worlds of
1, 2 and 4 processes on the CPU (one subprocess per rank, a ``file://``
rendezvous, no ports); the reference runs as ``tests/test_distributed.py``
runs it, in a subprocess with 8 forced host devices and a mesh whose
``data`` axis has the world's size.  Every rank's arrays must equal the
reference's exactly: values, order and dtype.  The cases cover a node
count that no world size divides, and a ``cap`` below a shard's count of
candidates, where each shard's truncation shows.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = str(Path(__file__).resolve().parent.parent / "src")
WORLDS = (1, 2, 4)      # 1: a group of one still runs the collectives

# the inputs, made from numpy seeds on both sides; n = 101 nodes and
# masks of 67 and 50 rows divide by neither world size
CASES = textwrap.dedent("""
    import numpy as np
    def check_cases(core):
        g = core_data.random_graph(n_nodes=101, n_edges=330, seed=5)
        ni = core.build_ni_index(g, d_max=2)
        out = []
        for d, lo, hi, need in ((1, [0, 40], [30, 90], [1, 1]),
                                (2, [10], [101], [2]),
                                (-1, [0, 50, 70], [50, 60, 101], [1, 0, 1])):
            e = ni.entries[d]
            out.append((e.ids, np.asarray(lo, np.int32),
                        np.asarray(hi, np.int32), np.asarray(need, np.int32),
                        e.overflow))
        return out
    def mask_cases():
        rng = np.random.default_rng(0)
        m67 = rng.random(67) < 0.3
        m50 = rng.random(50) < 0.8
        # cap above every shard's count, and caps that truncate shards
        return [(m67, 32), (m67, 3), (m50, 5), (m50, 1)]
""")

REF_PROG = CASES + textwrap.dedent("""
    import json, jax
    from jax.sharding import Mesh
    import repro.core as core
    import repro.data as core_data
    from repro.core.distributed import shard_check, gather_candidates
    res = {}
    for world in WORLDS:
        devs = np.asarray(jax.devices()[:world])
        mesh2 = Mesh(devs.reshape(world, 1), ("data", "model"))
        mesh1 = Mesh(devs, ("data",))
        res[world] = {
            "check": [shard_check(mesh2, *c).tolist()
                      for c in check_cases(core)],
            "check_dtype": str(shard_check(mesh2, *check_cases(core)[0]).dtype),
            "gather": [gather_candidates(mesh1, m, cap).tolist()
                       for m, cap in mask_cases()],
            "gather_dtype": str(gather_candidates(mesh1, *mask_cases()[0]).dtype)}
    print(json.dumps(res))
""")

PORT_PROG = CASES + textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    import repro_torch.core as core
    import repro_torch.data as core_data
    from repro_torch.core.distributed import shard_check, gather_candidates
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    kw = dict(device="cpu")
    check = [shard_check(*c, **kw) for c in check_cases(core)]
    gather = [gather_candidates(m, cap, **kw) for m, cap in mask_cases()]
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"check": [c.tolist() for c in check],
                   "check_dtype": str(check[0].dtype),
                   "gather": [g.tolist() for g in gather],
                   "gather_dtype": str(gather[0].dtype)}, f)
""")


def _env(**extra):
    env = dict(os.environ)
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.fixture(scope="module")
def reference():
    prog = f"WORLDS = {WORLDS!r}\n" + REF_PROG
    out = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=600,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {int(k): v for k, v in res.items()}


def run_world(world: int, tmp: Path) -> list[dict]:
    """PORT_PROG on every rank of a gloo world; each rank's output."""
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT_PROG, str(r), str(world), init,
         str(tmp / f"rank{r}.json")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env())
        for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_world_matches_reference(world, reference, tmp_path):
    want = reference[world]
    ranks = run_world(world, tmp_path)
    for got in ranks:
        assert got["check"] == want["check"]
        assert got["gather"] == want["gather"]
        assert (got["check_dtype"], got["gather_dtype"]) == \
            (want["check_dtype"], want["gather_dtype"])
    # the cases truncate per shard: cap 3 keeps a few ids of every shard,
    # not the first ids overall
    full, cut = want["gather"][0], want["gather"][1]
    assert len(cut) < len(full)
    assert (cut == full[:len(cut)]) == (world == 1)


def test_world_of_one_without_a_group_matches_single_device():
    """No process group: a world of one, no collective, the reference's
    answer on one device."""
    import repro.core as J
    import repro_torch.core as T
    import repro_torch.data as TD
    from repro.core.distributed import gather_candidates as jgather
    from repro.core.distributed import shard_check as jcheck
    from repro.data import random_graph
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    gj = random_graph(n_nodes=101, n_edges=330, seed=5)
    gt = TD.random_graph(n_nodes=101, n_edges=330, seed=5)
    ej = J.build_ni_index(gj, d_max=1).entries[1]
    et = T.build_ni_index(gt, d_max=1).entries[1]
    lo, hi = np.asarray([0, 40], np.int32), np.asarray([30, 90], np.int32)
    need = np.asarray([1, 1], np.int32)
    want = jcheck(mesh, ej.ids, lo, hi, need, ej.overflow)
    got = T.shard_check(et.ids, lo, hi, need, et.overflow, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    mask = np.random.default_rng(3).random(40) < 0.5
    g_want = jgather(mesh, mask, 7)
    g_got = T.gather_candidates(mask, 7, device="cpu")
    np.testing.assert_array_equal(g_got, g_want)
    assert g_got.dtype == g_want.dtype


def test_pad_rows_matches_reference():
    from repro.core.distributed import pad_rows as jpad
    from repro_torch.core.distributed import pad_rows as tpad
    a = np.arange(14, dtype=np.int32).reshape(7, 2)
    for ndev in (1, 2, 3, 4, 7, 8):
        np.testing.assert_array_equal(tpad(a, ndev, -1), jpad(a, ndev, -1))


def test_default_device_is_the_card():
    """device=None means the card: without CUDA it raises rather than
    running on the CPU."""
    import torch
    import repro_torch.core as T
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.gather_candidates(np.ones(4, bool), 2)
