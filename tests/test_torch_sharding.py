"""The port's sharding rules against the reference's: the partition specs
of parameters, optimizer state, batches and decode caches, and the
abstract (shape and dtype) trees of the dry-run, for every ARCHS entry,
with and without ZeRO-3, on the production meshes (16, 16) and
(2, 16, 16) and the test meshes (4, 2) and (8, 1).

The reference's functions read only `mesh.axis_names` and
`mesh.devices.shape`, the port's only `mesh.mesh_dim_names` and
`mesh.shape`, so stand-ins with those attributes take the place of
meshes of 256 or 512 devices in this process.  Specs are compared entry
by entry (jax.sharding.PartitionSpec against the port's PS), exactly.
Also here: `param.placements`, the one function that turns a spec into
DTensor placements (the row-to-rank layout it gives is held to the
reference's on a (2, 2, 2) gloo world in tests/test_torch_elastic.py).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as JARCHS
from repro.configs.base import TrainConfig as JTrain
from repro.models import api as japi
from repro_torch.configs import ARCHS, supported_shapes
from repro_torch.configs.base import TrainConfig
from repro_torch.models import api as tapi
from repro_torch.models.param import PS, placements
from repro_torch.tree import tree_leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
NAMES = sorted(ARCHS)


def meshes(kind):
    shape, names = MESHES[kind]
    ref = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    port = SimpleNamespace(mesh_dim_names=names, shape=shape)
    return ref, port


def flat_ref(tree):
    """{path: entries} of a tree of jax PartitionSpecs (dicts only)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[path] = tuple(node)
    walk(tree, ())
    return out


def flat_port(tree):
    return {p: tuple(s) for p, s in tree_leaves(tree)}


def dtname(dt) -> str:
    return str(dt).replace("torch.", "")


def flat_abstract_ref(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[path] = (tuple(node.shape), jnp.dtype(node.dtype).name)
    walk(tree, ())
    return out


def flat_abstract_port(tree):
    out = {}
    for p, t in tree_leaves(tree):
        assert t.is_meta, p             # shapes only: no memory
        out[p] = (tuple(t.shape), dtname(t.dtype))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_pspecs_match_reference(name, mesh):
    jm, tm = meshes(mesh)
    jcfg, tcfg = JARCHS[name], ARCHS[name]
    for zero3 in (False, True):
        want = flat_ref(japi.model_pspecs(jcfg, jm, zero3))
        assert flat_port(tapi.model_pspecs(tcfg, tm, zero3)) == want
        want = flat_ref(japi.opt_pspecs(jcfg, jm, zero3))
        assert flat_port(tapi.opt_pspecs(tcfg, tm, zero3)) == want
        for shape in supported_shapes(tcfg):
            want = flat_ref(japi.batch_pspecs(jcfg, shape, jm, zero3))
            assert flat_port(tapi.batch_pspecs(tcfg, shape, tm, zero3)) \
                == want, shape.name
            if shape.kind == "decode":
                cl = japi.decode_cache_len(jcfg, shape)
                assert cl == tapi.decode_cache_len(tcfg, shape)
                want = flat_ref(japi.cache_pspecs(
                    jcfg, jm, shape.global_batch, cl, zero3))
                assert flat_port(tapi.cache_pspecs(
                    tcfg, tm, shape.global_batch, cl, zero3)) == want


@pytest.mark.parametrize("name", NAMES)
def test_abstract_trees_match_reference(name):
    jcfg, tcfg = JARCHS[name], ARCHS[name]
    assert flat_abstract_port(tapi.abstract_model(tcfg)) == \
        flat_abstract_ref(japi.abstract_model(jcfg))
    for state in ("float32", "bfloat16"):
        want = japi.opt_abstract(jcfg, JTrain(opt_state_dtype=state))
        got = tapi.opt_abstract(tcfg, TrainConfig(opt_state_dtype=state))
        assert flat_abstract_port(got) == flat_abstract_ref(want)
    for shape in supported_shapes(tcfg):
        assert flat_abstract_port(tapi.batch_abstract(tcfg, shape)) == \
            flat_abstract_ref(japi.batch_abstract(jcfg, shape)), shape.name
        if shape.kind == "decode":
            assert flat_abstract_port(tapi.cache_abstract(tcfg, shape)) == \
                flat_abstract_ref(japi.cache_abstract(jcfg, shape))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharder_helpers_match_reference(mesh):
    """tp_size, dp_axes and the Sharder's flags."""
    jm, tm = meshes(mesh)
    for name in NAMES:
        jcfg, tcfg = JARCHS[name], ARCHS[name]
        assert tapi.tp_size(tm) == japi.tp_size(jm)
        assert tapi.dp_axes(tm) == japi.dp_axes(jm)
        js, ts = japi.make_sharder(jcfg, jm), tapi.make_sharder(tcfg, tm)
        assert (ts.dp, ts.tp_heads, ts.tp_kv) == \
            (js.dp, js.tp_heads, js.tp_kv)


def test_placements_of_specs():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 16, 16))
    r = Replicate()
    assert placements(PS(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements(PS(None, "data"), mesh) == [r, Shard(1), r]
    assert placements(PS(), mesh) == [r, r, r]
    # DTensor splits a dim over several mesh dims in the mesh's order
    with pytest.raises(ValueError):
        placements(PS(("data", "pod")), mesh)


def test_sharder_drops_axes_it_cannot_use():
    """Sharder.spec: the reference's rule (nn_ops.py:34-57): an axis
    that does not divide its dim, or that an earlier dim already uses,
    becomes None."""
    from repro.models.nn_ops import Sharder as JSharder
    from repro_torch.models.nn_ops import Sharder
    jm, tm = meshes("4x2")
    ts = Sharder(mesh=tm, dp="data", tp_heads=True, tp_kv=False)
    js = JSharder(mesh=jm, dp="data", tp_heads=True, tp_kv=False)
    for shape, axes in (((8, 6, 4), ("data", "model", None)),
                        ((6, 8), ("data", "model")),
                        ((8, 8), ("model", "model")),
                        ((8, 8), (("data", "model"), "data"))):
        want = tuple(js._ok(d, a) for d, a in zip(shape, axes))
        got = ts.spec(shape, *axes)
        # the reference's c() cleans repeats after _ok; spec does both
        used, clean = set(), []
        for a in want:
            flat = a if isinstance(a, tuple) else (a,) if a else ()
            clean.append(None if any(f in used for f in flat) else a)
            if not any(f in used for f in flat):
                used.update(flat)
        assert tuple(got) == tuple(clean), (shape, axes)


def test_no_shard_returns_its_input():
    from repro_torch.models.nn_ops import NO_SHARD
    x = torch.ones(4, 4)
    assert NO_SHARD.c(x, "data", "model") is x
