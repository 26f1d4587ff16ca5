"""repro_torch.optim against the reference (repro.optim) on the same numpy
trees: adamw_init, adamw_update (fp32 and bf16 state, steps 1, 2 and 50 on
identical gradients), global_norm, clip_by_global_norm and
cosine_schedule (warm-up and cosine ends).

Tolerances: the schedule to 4e-7 relative (two float32 ulps: cos and pow
are each library's own approximation), equal bit for bit at 95 % of the
steps or more; global_norm 1e-6 relative (summation order); AdamW, after
each step, every fp32 leaf within 1e-6·max(1, max|ref|) and every bf16
leaf within one bf16 ulp of max|ref| (2^-8·max|ref|: a float32 difference
in the last bit can round a bf16 value the other way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as T
from repro_torch.tree import tree_leaves, tree_map


def numpy_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"embed": n(50, 16), "blocks": {"w": n(3, 16, 24), "b": n(3, 24)},
            "norm": n(16)}


def to_torch(tree, dtypes=None):
    """numpy tree -> tensors, fp32 unless `dtypes` (a tree of the same
    layout, partial) names a leaf's dtype."""
    dtypes = dtypes or {}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = to_torch(v, dtypes.get(k))
        else:
            out[k] = torch.from_numpy(np.array(v)).to(
                dtypes.get(k, torch.float32))
    return out


def to_jax(tree):
    """tensor tree -> jnp arrays of the same values and dtypes."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return tree_map(conv, tree)


def assert_close(got, want, what):
    """got: tensor tree; want: jax tree; tolerances of the module."""
    w = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    for path, t in tree_leaves(got):
        ref = w[path]
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), (what, path)
        a = t.float().numpy()
        r = np.asarray(ref, np.float32)
        scale = float(np.abs(r).max())
        tol = 2.0 ** -8 * scale if t.dtype == torch.bfloat16 \
            else 1e-6 * max(1.0, scale)
        err = float(np.abs(a - r).max())
        assert err <= tol, (what, path, err, tol)


# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (1, 30)])
def test_cosine_schedule_matches_reference(warmup, total):
    steps = list(range(0, total + 20))
    got = [float(T.cosine_schedule(s, lr=3e-4, warmup=warmup,
                                   total_steps=total)) for s in steps]
    want = [float(J.cosine_schedule(s, lr=3e-4, warmup=warmup,
                                    total_steps=total)) for s in steps]
    exact = sum(g == w for g, w in zip(got, want))
    assert exact >= 0.95 * len(steps)
    for s, g, w in zip(steps, got, want):
        assert abs(g - w) <= 4e-7 * abs(w), (s, g, w)
    # the warm-up starts at 0 (without one, the cosine at lr); past
    # total_steps the cosine rests at min_ratio·lr
    want0 = 0.0 if warmup else 3e-4
    assert abs(got[0] - want0) <= 4e-7 * want0
    assert abs(got[-1] - 3e-5) <= 4e-7 * 3e-5


def test_cosine_schedule_takes_a_tensor_step_and_stays_on_its_device():
    step = torch.tensor(5, dtype=torch.int32)
    lr = T.cosine_schedule(step, lr=1e-3, warmup=10, total_steps=20)
    assert lr.dtype == torch.float32 and lr.shape == () and not lr.is_cuda
    assert float(lr) == float(J.cosine_schedule(5, lr=1e-3, warmup=10,
                                                total_steps=20))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_norm_matches_reference(scale):
    tree = numpy_tree(1, scale)
    got = float(T.global_norm(to_torch(tree)))
    want = float(J.global_norm(tree))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
@pytest.mark.parametrize("bf16", [False, True])
def test_clip_by_global_norm_matches_reference(max_norm, bf16):
    """max_norm under the norm (scaled) and over it (unchanged), fp32 and
    bf16 gradients: the clipped leaves keep their dtype."""
    dtypes = {"embed": torch.bfloat16} if bf16 else {}
    grads = to_torch(numpy_tree(2), dtypes)
    clipped, gn = T.clip_by_global_norm(grads, max_norm)
    want, wn = J.clip_by_global_norm(to_jax(grads), max_norm)
    assert abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
    assert_close(clipped, want, "clip")
    if max_norm > float(wn):
        for path, t in tree_leaves(clipped):
            assert torch.equal(t, dict(tree_leaves(grads))[path])


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_init_matches_reference(state_dtype):
    params = to_torch(numpy_tree(0))
    dt = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}[state_dtype]
    got = T.adamw_init(params, dt[0])
    want = J.adamw_init(to_jax(params), dt[1])
    assert int(got["step"]) == int(want["step"]) == 0
    assert got["step"].dtype == torch.int32
    for key in ("m", "v"):
        assert_close(got[key], want[key], key)
        for _, t in tree_leaves(got[key]):
            assert t.dtype == dt[0] and not bool(t.any())


@pytest.mark.parametrize("steps", [1, 2, 50])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype, steps):
    """`steps` AdamW steps on identical gradients (new ones each step,
    some of them near zero), with the cosine learning rate: parameters
    (one leaf bf16), moments and step after every step."""
    dts = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}[state_dtype]
    params = to_torch(numpy_tree(0), {"norm": torch.bfloat16})
    jparams = to_jax(params)
    state, jstate = T.adamw_init(params, dts[0]), J.adamw_init(jparams,
                                                             dts[1])
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    for i in range(steps):
        grads = to_torch(numpy_tree(100 + i, scale=1e-3 * (1 + i % 3)),
                         {"embed": torch.bfloat16})
        grads["norm"][:4] = 0.0
        lr_t = T.cosine_schedule(i, lr=1e-2, warmup=5, total_steps=60)
        lr_j = J.cosine_schedule(i, lr=1e-2, warmup=5, total_steps=60)
        params, state = T.adamw_update(grads, state, params, lr_t, **kw)
        jparams, jstate = J.adamw_update(to_jax(grads), jstate, jparams,
                                         lr_j, **kw)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert_close(params, jparams, f"params step {i + 1}")
        assert_close(state["m"], jstate["m"], f"m step {i + 1}")
        assert_close(state["v"], jstate["v"], f"v step {i + 1}")


def test_adamw_update_writes_in_place():
    """The update writes into the tensors it is given and returns them."""
    params = to_torch(numpy_tree(0))
    before = {p: t.clone() for p, t in tree_leaves(params)}
    leaves = dict(tree_leaves(params))
    state = T.adamw_init(params)
    m0 = dict(tree_leaves(state["m"]))
    step0 = state["step"]
    p2, s2 = T.adamw_update(to_torch(numpy_tree(1)), state, params, 1e-2)
    assert p2 is params and s2 is state and s2["step"] is step0
    for path, t in tree_leaves(p2):
        assert t is leaves[path] and not torch.equal(t, before[path])
    for path, t in tree_leaves(s2["m"]):
        assert t is m0[path]
