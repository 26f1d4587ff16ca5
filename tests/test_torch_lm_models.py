"""The LM scaffold's serving path in repro_torch against the reference, for
every config of ARCHS at reduced_config (float32): the prefill logits,
every cache leaf, and one decode step's logits and cache, with the
reference's weights carried by params_from_reference and the same numpy
batch.  Tolerance: max|Δ| <= 1e-4·max(1, max|ref|) per leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import InputShape as JShape
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.models.param import PD as JPD
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.models.param import PD, tree_leaves

B, S = 2, 24


def assert_trees_close(got, ref, tol=1e-4):
    """got: the port's tree (tensors or numpy); ref: the reference's."""
    g = dict(tree_leaves(got))
    r = dict(tree_leaves(jax.tree.map(np.asarray, ref)))
    assert set(g) == set(r)
    for path, a in r.items():
        b = g[path]
        b = convert.cache_to_numpy({"x": b})["x"] if torch.is_tensor(b) \
            else b
        a = np.asarray(a, np.float32) if a.dtype != np.int32 else a
        assert b.shape == a.shape, path
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        elif a.size:
            err = float(np.max(np.abs(b - a)))
            assert err <= tol * max(1.0, float(np.max(np.abs(a)))), \
                (path, err)


def setup(name, **over):
    jcfg = jreduced(JARCHS[name], **over)
    tcfg = reduced_config(ARCHS[name], **over)
    params = japi.init_model(jcfg, 0)
    tp = convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tp


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_decode_match_reference(name):
    jcfg, tcfg, params, tp = setup(name)
    batch = japi.concrete_batch(jcfg, JShape("t", S, B, "prefill"), seed=3)
    cl = japi.decode_cache_len(jcfg, JShape("d", S + 8, B, "decode"))
    jl, jc = japi.make_prefill_fn(jcfg, cache_len=cl)(params, batch)
    tl, tc = tapi.make_prefill_fn(tcfg, cache_len=cl)(
        tp, tapi.concrete_batch(tcfg, InputShape("t", S, B, "prefill"),
                                seed=3))
    assert tl.dtype == torch.float32 and tl.shape == (B, tcfg.vocab_size)
    assert_trees_close({"logits": tl}, {"logits": jl})
    # decode writes its attention caches in place: snapshot the prefill's
    prefilled = convert.cache_to_numpy(tc)
    assert_trees_close(prefilled, jc)
    # cache_defs describes the cache prefill builds, as the reference's
    defs = dict(tree_leaves(ttf.cache_defs(tcfg, B, cl),
                            lambda x: isinstance(x, PD)))
    ref_defs = dict(tree_leaves(jtf.cache_defs(jcfg, B, cl),
                                lambda x: isinstance(x, JPD)))
    assert {p: (d.shape, d.axes) for p, d in defs.items()} == \
        {p: (d.shape, d.axes) for p, d in ref_defs.items()}
    for path, a in tree_leaves(prefilled):
        assert a.shape == defs[path].shape, path
    if not tcfg.decoder:
        return
    nxt = np.full(B, 7, np.int32)
    jl2, jc2 = japi.make_decode_fn(jcfg)(params, jc, jnp.asarray(nxt))
    # the port's decode from its own prefill cache, and from the
    # reference's cache carried by value
    for cache in (tc, convert.cache_from_numpy(
            jax.tree.map(np.asarray, jc), device="cpu")):
        tl2, tc2 = tapi.make_decode_fn(tcfg)(tp, cache, torch.as_tensor(nxt))
        assert_trees_close({"logits": tl2}, {"logits": jl2})
        assert_trees_close(tc2, jc2)
    # the snapshot is a copy: the steps' in-place writes left it alone
    assert_trees_close(prefilled, jc)


def test_decode_cache_len_leaves_out_vlm_patch_tokens():
    """decode_cache_len sizes a full cache for shape.seq_len text positions
    plus DECODE_PAD, without a VLM's patch tokens.  With paligemma's 256
    patches (the rest at reduced_config) and 24 text tokens, the 153-slot
    cache holds only the prompt's last 153 positions, and the step writes
    at min(pos, cache_len - 1), over the last of them.  Both packages do
    this alike: the port's step equals the reference's, and each is far
    from a prefill of the same tokens; a cache sized for patches + text +
    the step brings decode back to the prefill."""
    jcfg, tcfg, params, tp = setup("paligemma-3b", num_prefix_tokens=256)
    batch = japi.concrete_batch(jcfg, JShape("t", S, B, "prefill"), seed=3)
    shape = ("d", S + 1, B, "decode")
    cl = tapi.decode_cache_len(tcfg, InputShape(*shape))
    assert cl == japi.decode_cache_len(jcfg, JShape(*shape)) == S + 1 + 128
    assert cl < tcfg.num_prefix_tokens + S + 1
    nxt = np.full(B, 7, np.int32)
    b2 = dict(batch, tokens=np.concatenate([batch["tokens"], nxt[:, None]],
                                           1))
    ref, _ = japi.make_prefill_fn(jcfg)(params, b2)
    scale = max(1.0, float(jnp.max(jnp.abs(ref))))

    def step_err(cache_len):
        _, jc = japi.make_prefill_fn(jcfg, cache_len=cache_len)(params, batch)
        jl2, _ = japi.make_decode_fn(jcfg)(params, jc, jnp.asarray(nxt))
        _, tc = tapi.make_prefill_fn(tcfg, cache_len=cache_len)(tp, batch)
        tl2, _ = tapi.make_decode_fn(tcfg)(tp, tc, torch.as_tensor(nxt))
        assert_trees_close({"logits": tl2}, {"logits": jl2})
        return float(jnp.max(jnp.abs(jl2 - ref))) / scale

    assert step_err(cl) > 2e-2
    assert step_err(tapi.decode_cache_len(tcfg, InputShape(
        "d", tcfg.num_prefix_tokens + S + 1, B, "decode"))) < 2e-2
