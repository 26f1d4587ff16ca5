"""LM configs, input batches and model init of repro_torch against the
reference (repro.configs, repro.models.api): every config's fields and
derived numbers, the batches bit for bit, and the port's own init_model
for its tree, shapes, dtypes and init kinds (JAX and torch draw different
numbers, so parity tests carry the reference's weights instead)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.models.param import PD as JPD
import repro_torch.configs as TC
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.models.param import PD, count_params, tree_leaves

NAMES = sorted(JC.ARCHS)
SHAPES = [JC.InputShape("t", 16, 2, "train"),
          JC.InputShape("p", 16, 2, "prefill"),
          JC.InputShape("d", 16, 2, "decode")]


def test_arch_names_and_order_match():
    assert list(TC.ARCHS) == list(JC.ARCHS)
    assert list(TC.SHAPES) == list(JC.SHAPES)
    for a, b in zip(TC.ALL_SHAPES, JC.ALL_SHAPES):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(TC.TrainConfig()) == \
        dataclasses.asdict(JC.TrainConfig())
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    t, j = TC.get_config(name), JC.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_params() == j.num_params()
    assert t.num_active_params() == j.num_active_params()
    assert t.config_hash() == j.config_hash()
    assert (t.hd, t.d_ff_e, t.attention_free, t.sub_quadratic, t.decoder) \
        == (j.hd, j.d_ff_e, j.attention_free, j.sub_quadratic, j.decoder)
    assert [s.name for s in TC.supported_shapes(t)] == \
        [s.name for s in JC.supported_shapes(j)]
    rt, rj = TC.reduced_config(t), JC.reduced_config(j)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert rt.config_hash() == rj.config_hash()
    assert rt.num_params() == rj.num_params()
    over = dict(capacity_factor=16.0, dtype="bfloat16")
    assert TC.reduced_config(t, **over).config_hash() == \
        JC.reduced_config(j, **over).config_hash()


@pytest.mark.parametrize("name", NAMES)
def test_concrete_batch_bit_equal(name):
    t, j = TC.reduced_config(TC.ARCHS[name]), JC.reduced_config(JC.ARCHS[name])
    for shape in SHAPES:
        bt = tapi.concrete_batch(t, shape, seed=5)
        bj = japi.concrete_batch(j, shape, seed=5)
        assert list(bt) == list(bj)
        for k in bj:
            assert bt[k].dtype == bj[k].dtype and bt[k].shape == bj[k].shape
            assert np.array_equal(bt[k], bj[k])
    for shape in (JC.DECODE_32K, JC.LONG_500K):
        assert tapi.decode_cache_len(t, shape) == \
            japi.decode_cache_len(j, shape)


def _jax_defs(tree):
    return {p: pd for p, pd in tree_leaves(
        tree, lambda x: isinstance(x, JPD))}


@pytest.mark.parametrize("name", NAMES)
def test_init_model_tree_shapes_dtypes_and_kinds(name):
    cfg = TC.reduced_config(TC.ARCHS[name])
    params = tapi.init_model(cfg, seed=0, device="cpu")
    defs = {p: pd for p, pd in tree_leaves(
        ttf.model_defs(cfg), lambda x: isinstance(x, PD))}
    ref_defs = _jax_defs(jtf.model_defs(JC.reduced_config(JC.ARCHS[name])))
    assert set(defs) == set(ref_defs)
    abstract = dict(tree_leaves(
        japi.abstract_model(JC.reduced_config(JC.ARCHS[name]))))
    leaves = dict(tree_leaves(params))
    assert set(leaves) == set(defs)
    for path, pd in defs.items():
        t = leaves[path]
        assert (pd.shape, pd.axes, pd.init, pd.scale) == \
            (ref_defs[path].shape, ref_defs[path].axes, ref_defs[path].init,
             ref_defs[path].scale), path
        assert tuple(t.shape) == tuple(abstract[path].shape), path
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        if pd.init == "ones":
            assert torch.all(t == 1), path
        elif pd.init == "zeros":
            assert torch.all(t == 0), path
        else:
            assert torch.isfinite(t).all() and t.std() > 0, path
            if t.numel() >= 4096:
                assert abs(float(t.std()) / pd.scale - 1) < 0.1, path
    assert count_params(ttf.model_defs(cfg)) == sum(
        t.numel() for t in leaves.values())


def test_init_model_seeded_and_param_dtype():
    cfg = TC.reduced_config(TC.ARCHS["qwen2-0.5b"])
    a = dict(tree_leaves(tapi.init_model(cfg, seed=3, device="cpu")))
    b = dict(tree_leaves(tapi.init_model(cfg, seed=3, device="cpu")))
    c = dict(tree_leaves(tapi.init_model(cfg, seed=4, device="cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[("embed",)], c[("embed",)])
    bf = tapi.init_model(dataclasses.replace(cfg, param_dtype="bfloat16"),
                         device="cpu")
    assert all(t.dtype == torch.bfloat16 for _, t in tree_leaves(bf))


def test_cuda_is_the_default_device():
    """init_model, params_from_reference and cache_from_numpy put tensors on
    the card unless device="cpu" is passed; without CUDA they raise."""
    cfg = TC.reduced_config(TC.ARCHS["qwen2-0.5b"])
    tree = convert.cache_to_numpy(tapi.init_model(cfg, device="cpu"))
    calls = (lambda: tapi.init_model(cfg),
             lambda: convert.params_from_reference(cfg, tree),
             lambda: convert.cache_from_numpy(tree))
    if torch.cuda.is_available():
        for call in calls:
            assert all(t.is_cuda for _, t in tree_leaves(call()))
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_params_from_reference_checks_paths_and_shapes():
    cfg = TC.reduced_config(TC.ARCHS["qwen2-0.5b"])
    jcfg = JC.reduced_config(JC.ARCHS["qwen2-0.5b"])
    tree = jax.tree.map(np.asarray, japi.init_model(jcfg, 0))
    got = convert.params_from_reference(cfg, tree, device="cpu")
    for path, a in tree_leaves(tree):
        t = dict(tree_leaves(got))[path]
        assert np.array_equal(t.numpy(), a), path
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        convert.params_from_reference(cfg, missing, device="cpu")
    bad = dict(tree, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_reference(cfg, bad, device="cpu")
