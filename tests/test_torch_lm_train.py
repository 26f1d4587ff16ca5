"""The LM scaffold's training path in repro_torch against the reference, for
every config of ARCHS at reduced_config (float32), with the reference's
weights carried by params_from_reference and the same numpy batch
(concrete_batch(cfg, InputShape("smoke", 64, 2, "train"), seed=1)); the
reference runs JAX on the CPU.

Tolerances:
  * loss and loss metrics: |Δ| <= 1e-5·|ref| (1e-5 absolute near 0);
  * gradients, leaf by leaf (jax.grad of the reference's loss against
    torch autograd of the port's): max|Δ| <= 1e-4·max|ref leaf|;
  * a train step's loss and grad_norm 1e-5 relative, lr to 1e-7 relative;
    its parameters where the step is decided: AdamW's first step moves a
    parameter by about lr·sign(g), and a gradient element near zero can
    take either sign in two correct implementations, so the parameters
    are held (to 1e-6 absolute) only where |g_ref| exceeds 100 times the
    leaf's gradient noise, max|g_port - g_ref|.  The update rule itself
    is held on identical gradients in tests/test_torch_optim.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import InputShape as JShape, TrainConfig as JTrain
from repro.models import api as japi
from repro.models.nn_ops import chunked_cross_entropy as jce
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models.nn_ops import chunked_cross_entropy
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_from_leaves, tree_leaves

SMOKE = ("smoke", 64, 2, "train")
NAMES = sorted(ARCHS)


def setup(name, **over):
    jcfg = jreduced(JARCHS[name], **over)
    tcfg = reduced_config(ARCHS[name], **over)
    params = japi.init_model(jcfg, 0)
    tp = convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    batch = japi.concrete_batch(jcfg, JShape(*SMOKE), seed=1)
    return jcfg, tcfg, params, tp, batch


def rows(batch, i, n):
    """Row group i of n (a microbatch of the train step)."""
    per = next(iter(batch.values())).shape[0] // n
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_grad_fn(name):
    jcfg = jreduced(JARCHS[name])
    return jax.jit(jax.value_and_grad(japi.make_loss_fn(jcfg), has_aux=True))


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(name, group=None):
    """The reference's (loss, metrics, grads), numpy, for `name` over the
    whole batch or over row group `group` = (i, n)."""
    _, _, params, _, batch = setup(name)
    if group is not None:
        batch = rows(batch, *group)
    (loss, metrics), grads = reference_grad_fn(name)(params, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            dict(tree_leaves(jax.tree.map(np.asarray, grads))))


def port_loss_and_grads(tcfg, tp, batch, remat=True):
    wrt = {p: x.detach().requires_grad_() for p, x in tree_leaves(tp)}
    loss, metrics = tapi.make_loss_fn(tcfg, remat=remat)(
        tree_from_leaves(wrt), batch)
    grads = torch.autograd.grad(loss, list(wrt.values()))
    return loss, metrics, dict(zip(wrt, grads))


def close_scalar(got, want, rel=1e-5):
    got = float(got.detach()) if torch.is_tensor(got) else float(got)
    assert abs(got - want) <= rel * max(abs(want), 1.0), (got, want)


def port_batch(tcfg):
    return tapi.concrete_batch(tcfg, InputShape(*SMOKE), seed=1)


# ---------------------------------------------------------------------- #
def test_concrete_train_batch_matches_reference():
    for name in NAMES:
        jcfg, tcfg = jreduced(JARCHS[name]), reduced_config(ARCHS[name])
        want = japi.concrete_batch(jcfg, JShape(*SMOKE), seed=1)
        got = port_batch(tcfg)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("with_mask", [False, True])
def test_chunked_cross_entropy_matches_reference(with_mask):
    """The loss head alone, value and gradients (x and the embedding),
    over 4 chunks, with and without a mask."""
    rng = np.random.default_rng(2)
    b, s, d, v = 2, 32, 16, 50
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    emb = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.3 if with_mask else None

    def ref(x_, e_):
        return jce(x_, e_, labels, chunk=8,
                   mask=None if mask is None else jnp.asarray(mask))
    want, (gx, ge) = jax.value_and_grad(ref, argnums=(0, 1))(x, emb)
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    got = chunked_cross_entropy(
        tx, te, torch.from_numpy(labels), chunk=8,
        mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    got = float(got.detach())
    close_scalar(got, float(want))
    for g, r in ((tx.grad, gx), (te.grad, ge)):
        r = np.asarray(r)
        assert float(np.abs(g.numpy() - r).max()) <= 1e-4 * np.abs(r).max()
    # the full [B, S, V] form (tests/test_models.py::test_chunked_ce_...)
    logits = x @ emb.T
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True))
                 .sum(-1)) + logits.max(-1)
    nll = lse - np.take_along_axis(logits, labels[..., None], -1)[..., 0]
    m = np.ones((b, s)) if mask is None else mask
    np.testing.assert_allclose(got, (nll * m).sum() / m.sum(),
                               rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_reference(name):
    """make_loss_fn's loss and metrics (ce, moe_aux, moe_drop) against the
    reference's, 1e-5 relative."""
    _, tcfg, _, tp, batch = setup(name)
    want_loss, want_metrics, _ = reference_loss_and_grads(name)
    with torch.no_grad():
        loss, metrics = tapi.make_loss_fn(tcfg)(tp, batch)
    close_scalar(loss, want_loss)
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        close_scalar(metrics[k], v)


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_reference(name):
    """torch autograd of the port's loss against jax.grad of the
    reference's, every leaf within 1e-4·max|ref leaf|; every gradient is
    finite (the attention's masked -inf scores give no NaN)."""
    _, tcfg, _, tp, batch = setup(name)
    want_loss, _, want = reference_loss_and_grads(name)
    loss, _, got = port_loss_and_grads(tcfg, tp, batch)
    close_scalar(loss.detach(), want_loss)
    assert set(got) == set(want)
    for path, r in want.items():
        g = got[path].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, path
        assert np.isfinite(g).all(), path
        err = float(np.abs(g - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()), (path, err)


@pytest.mark.parametrize("name", NAMES)
def test_remat_on_and_off_give_equal_gradients(name):
    """Per-block and per-chunk recompute changes what is stored, not what
    is computed: the gradients with remat and without are equal, bit for
    bit on the CPU."""
    tcfg = reduced_config(ARCHS[name])
    tp = tapi.init_model(tcfg, 3, device="cpu")
    batch = port_batch(tcfg)
    l1, _, g1 = port_loss_and_grads(tcfg, tp, batch, remat=True)
    l0, _, g0 = port_loss_and_grads(tcfg, tp, batch, remat=False)
    assert torch.equal(l1, l0)
    for path in g0:
        assert torch.equal(g1[path], g0[path]), path


# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def reference_step(name, grad_dtype, microbatch=2):
    jcfg, _, params, _, batch = setup(name)
    tcfg = JTrain(microbatch=microbatch, total_steps=10, warmup=2,
                  grad_dtype=grad_dtype)
    p2, _, metrics = jax.jit(japi.make_train_step(jcfg, tcfg))(
        params, jadamw_init(params), batch, 2)
    return ({k: float(v) for k, v in metrics.items()},
            dict(tree_leaves(jax.tree.map(np.asarray, p2))))


STEP_NAMES = ["granite-moe-1b-a400m", "hubert-xlarge", "hymba-1.5b",
              "paligemma-3b", "qwen2-0.5b", "rwkv6-7b"]


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", STEP_NAMES)
def test_train_step_matches_reference(name, grad_dtype):
    """One make_train_step (microbatch 2, warm-up 2, at step 2) against
    the reference's: every metric 1e-5 relative (lr 1e-7), and the new
    parameters where the step is decided (module docstring).  One config
    of each family."""
    _, tcfg, _, tp, batch = setup(name)
    want_metrics, want_params = reference_step(name, grad_dtype)
    # the step's gradient: the mean of the two microbatches' (an MoE's
    # capacity and aux loss are per microbatch)
    want_grads, got_grads = {}, {}
    for i in range(2):
        _, _, w = reference_loss_and_grads(name, (i, 2))
        _, _, g = port_loss_and_grads(tcfg, tp, rows(batch, i, 2))
        for path in w:
            want_grads[path] = want_grads.get(path, 0) + w[path] / 2
            got_grads[path] = got_grads.get(path, 0) + g[path].numpy() / 2
    tc = TrainConfig(microbatch=2, total_steps=10, warmup=2,
                     grad_dtype=grad_dtype)
    p2, opt, metrics = tapi.make_train_step(tcfg, tc)(
        tp, adamw_init(tp), batch, 2)
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        close_scalar(metrics[k], v, rel=1e-7 if k == "lr" else 1e-5)
    assert int(opt["step"]) == 1
    got = dict(tree_leaves(p2))
    held = 0
    for path, want in want_params.items():
        g = got[path].numpy()
        noise = float(np.abs(got_grads[path] - want_grads[path]).max())
        sure = np.abs(want_grads[path]) > 100 * noise + 1e-12
        assert np.abs(g - want)[sure].max(initial=0.0) <= 1e-6, path
        held += int(sure.sum())
    assert held > 0.5 * sum(w.size for w in want_params.values())


def test_train_step_bf16_activations_match_reference():
    """qwen2 at reduced_config in bf16 over fp32 masters, microbatch 2:
    with grad_dtype "bfloat16" the gradients are taken wrt bf16 copies,
    otherwise through the cast; loss within 2e-2 and grad_norm within
    5e-2 of the reference's (each computes its bf16 ops in its own order
    and rounds them to bf16), lr to 1e-7."""
    name = "qwen2-0.5b"
    for grad_dtype in ("float32", "bfloat16"):
        jcfg, tcfg, params, tp, batch = setup(name, dtype="bfloat16")
        tc = dict(microbatch=2, total_steps=10, warmup=2,
                  grad_dtype=grad_dtype)
        _, _, want = jax.jit(japi.make_train_step(jcfg, JTrain(**tc)))(
            params, jadamw_init(params), batch, 2)
        p2, _, got = tapi.make_train_step(tcfg, TrainConfig(**tc))(
            tp, adamw_init(tp), batch, 2)
        close_scalar(got["loss"], float(want["loss"]), rel=2e-2)
        close_scalar(got["grad_norm"], float(want["grad_norm"]), rel=5e-2)
        close_scalar(got["lr"], float(want["lr"]), rel=1e-7)
        for _, leaf in tree_leaves(p2):
            assert leaf.dtype == torch.float32
            assert bool(torch.isfinite(leaf).all())


def test_bf16_gradients_are_bf16():
    """grad_dtype "bfloat16" differentiates wrt the bf16 copies: the
    microbatch gradients reaching the fp32 accumulators are bf16."""
    tcfg = reduced_config(ARCHS["qwen2-0.5b"], dtype="bfloat16")
    tp = tapi.init_model(tcfg, 0, device="cpu")
    seen = []
    real = torch.autograd.grad

    def grad(outputs, inputs, **kw):
        out = real(outputs, inputs, **kw)
        seen.extend(g.dtype for g in out)
        return out
    for grad_dtype, want in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
        seen.clear()
        torch.autograd.grad = grad
        try:
            tapi.make_train_step(tcfg, TrainConfig(
                microbatch=2, grad_dtype=grad_dtype))(
                tp, adamw_init(tp), port_batch(tcfg), 0)
        finally:
            torch.autograd.grad = real
        assert seen and set(seen) == {want}


# ---------------------------------------------------------------------- #
# twins of tests/test_models.py's training tests, run on the port
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_arch_smoke_train_step(name):
    cfg = reduced_config(ARCHS[name])
    params = tapi.init_model(cfg, 0, device="cpu")
    before = {p: t.clone() for p, t in tree_leaves(params)}
    tcfg = TrainConfig(microbatch=2, total_steps=10, warmup=2)
    step = tapi.make_train_step(cfg, tcfg)
    opt = adamw_init(params)
    params2, opt2, metrics = step(params, opt, port_batch(cfg), 2)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    # params actually moved (in place: params2 is params)
    delta = sum(float((t - before[p]).abs().sum())
                for p, t in tree_leaves(params2))
    assert delta > 0
    for _, leaf in tree_leaves(params2):
        assert bool(torch.isfinite(leaf).all())


@pytest.mark.parametrize("name", ["qwen2-0.5b", "rwkv6-7b", "hymba-1.5b",
                                  "granite-moe-1b-a400m"])
def test_arch_loss_decreases(name):
    cfg = reduced_config(ARCHS[name])
    params = tapi.init_model(cfg, 0, device="cpu")
    tcfg = TrainConfig(lr=3e-3, microbatch=1, total_steps=30, warmup=1)
    step = tapi.make_train_step(cfg, tcfg)
    batch = port_batch(cfg)                 # fixed batch: memorize
    opt = adamw_init(params)
    losses = []
    for i in range(8):
        params, opt, m = step(params, opt, batch, i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
