"""The LM scaffold's ops in repro_torch against the reference
(repro.models.{nn_ops,moe,rwkv6,ssm}) on the same numpy inputs, and twins
of the reference's equivalence tests (flash against naive attention, the
chunked RWKV-6 and SSM scans against their steps).  Parameters are the
reference's, carried by value.  Tolerance: max|Δ| <= 1e-4·max(1, max|ref|)
unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.models import moe as jmoe
from repro.models import nn_ops as jops
from repro.models import rwkv6 as jrwkv
from repro.models import ssm as jssm
from repro.models.param import init_params as jinit
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import moe as tmoe
from repro_torch.models import nn_ops as tops
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import ssm as tssm


def close(got, ref, tol=1e-4):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(ref)))), err


def T(a):
    return torch.from_numpy(np.array(a))


def ref_params(defs, seed=0):
    """The reference's init of a PD tree, as torch tensors and jnp arrays."""
    p = jinit(defs, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: T(np.asarray(a)), p), p


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------- #
def test_rms_norm_rotary_ffn():
    rng = np.random.default_rng(0)
    x, g = normal(rng, 3, 5, 32), normal(rng, 32)
    close(tops.rms_norm(T(x), T(g), 1e-5), jops.rms_norm(x, g, 1e-5))
    pos = rng.integers(0, 4000, (3, 5)).astype(np.int32)
    close(tops.rotary(T(x), T(pos), 1e4), jops.rotary(x, pos, 1e4))
    close(tops.rotary(T(x), T(pos), 1e5), jops.rotary(x, pos, 1e5))
    w1, w2, w3 = normal(rng, 32, 48), normal(rng, 48, 32), normal(rng, 32, 48)
    close(tops.ffn(T(x), T(w1), T(w2), T(w3)), jops.ffn(x, w1, w2, w3))
    close(tops.ffn(T(x), T(w1), T(w2)), jops.ffn(x, w1, w2))


def test_rms_norm_bf16_cast_order():
    """Cast to x's dtype, then multiply by gamma: bf16 in, bf16 out, equal
    to the reference bit for bit."""
    rng = np.random.default_rng(1)
    x, g = normal(rng, 4, 64), normal(rng, 64)
    got = tops.rms_norm(T(x).bfloat16(), T(g).bfloat16())
    ref = jops.rms_norm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(g, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


FLASH_CASES = {
    "causal": dict(b=2, hq=4, hkv=4, s=64, hd=16, kw=dict(causal=True),
                   chunk=16),
    "non_causal": dict(b=2, hq=4, hkv=4, s=48, hd=16, kw=dict(causal=False),
                       chunk=16),
    "gqa": dict(b=1, hq=6, hkv=2, s=40, hd=8, kw=dict(causal=True),
                chunk=8),
    "sliding_meta": dict(b=1, hq=4, hkv=2, s=70, hd=8,
                         kw=dict(causal=True, window=16, n_meta=4), chunk=16),
    "kv_not_chunk_multiple": dict(b=2, hq=2, hkv=1, s=50, hd=16,
                                  kw=dict(causal=True), chunk=32),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    c = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q = normal(rng, c["b"], c["hq"], c["s"], c["hd"])
    k = normal(rng, c["b"], c["hkv"], c["s"], c["hd"])
    v = normal(rng, c["b"], c["hkv"], c["s"], c["hd"])
    got = tops.flash_attention(T(q), T(k), T(v), kv_chunk=c["chunk"],
                               **c["kw"])
    ref = jops.flash_attention(q, k, v, kv_chunk=c["chunk"], **c["kw"])
    close(got, ref)


def test_flash_attention_matches_naive():
    """Twin of tests/test_models.py::test_flash_attention_matches_naive."""
    rng = np.random.default_rng(0)
    b, h, s, hd = 2, 4, 96, 16
    q = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    k = rng.normal(size=(b, 2, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, 2, s, hd)).astype(np.float32)
    out = tops.flash_attention(T(q), T(k), T(v), causal=True, kv_chunk=32)
    qg = q.reshape(b, 2, 2, s, hd)
    scores = np.einsum("bkgqd,bksd->bkgqs", qg, k) / np.sqrt(hd)
    mask = np.tril(np.ones((s, s), bool))
    scores = np.where(mask, scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bkgqs,bksd->bkgqd", p, v).reshape(b, h, s, hd)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-4)


def test_flash_attention_sliding_window_with_meta():
    """Twin of test_models.py::test_flash_attention_sliding_window_with_meta."""
    rng = np.random.default_rng(1)
    b, h, s, hd, w, m = 1, 2, 64, 8, 16, 4
    q = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    k = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    out = tops.flash_attention(T(q), T(k), T(v), causal=True, window=w,
                               n_meta=m, kv_chunk=16)
    qpos = np.arange(s)[:, None]
    kpos = np.arange(s)[None, :]
    ok = (qpos >= kpos) & (((qpos - kpos) < w) | (kpos < m))
    scores = np.einsum("bhqd,bhsd->bhqs", q, k) / np.sqrt(hd)
    scores = np.where(ok, scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqs,bhsd->bhqd", p, v)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_matches_reference(ring):
    rng = np.random.default_rng(7)
    b, hq, hkv, c, hd = 2, 4, 2, 24, 16
    q = normal(rng, b, hq, hd)
    kc, vc = normal(rng, b, hkv, c, hd), normal(rng, b, hkv, c, hd)
    if ring:      # 4 meta slots, a ring of 20 with its last 5 slots empty
        pos, kw = 30, dict(window=12, n_meta=4)
        slot_pos = np.concatenate([np.arange(4), np.arange(20, 35)[:15],
                                   np.full(5, -1)]).astype(np.int32)
    else:         # a full cache filled up to pos
        pos, kw = 17, {}
        slot_pos = np.where(np.arange(c) <= pos, np.arange(c),
                            -1).astype(np.int32)
    got = tops.decode_attention(T(q), T(kc), T(vc), T(slot_pos),
                                torch.tensor(pos, dtype=torch.int32), **kw)
    ref = jops.decode_attention(q, kc, vc, slot_pos, jnp.int32(pos), **kw)
    close(got, ref)


# ---------------------------------------------------------------------- #
def _moe_cfgs(cf):
    over = dict(capacity_factor=cf)
    return (reduced_config(ARCHS["granite-moe-1b-a400m"], **over),
            jreduced(JARCHS["granite-moe-1b-a400m"], **over))


@pytest.mark.parametrize("dispatch", ["local", "global_sort"])
@pytest.mark.parametrize("cf", [16.0, 0.3])
def test_moe_ffn_matches_reference(dispatch, cf):
    """y, moe_aux, moe_drop and the router's eid against each of the
    reference's dispatches (the port has the one: with one data shard they
    place every slot alike); cf 0.3 drops slots."""
    tcfg, jcfg = _moe_cfgs(cf)
    tp, jp = ref_params(jmoe.moe_param_defs(jcfg))
    rng = np.random.default_rng(11)
    x = normal(rng, 2, 40, tcfg.d_model)
    y, m = tmoe.moe_ffn(tcfg, tp, T(x))
    yr, mr = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x), dispatch=dispatch)
    close(y, yr)
    close(m["moe_aux"], mr["moe_aux"])
    assert float(m["moe_drop"]) == pytest.approx(float(mr["moe_drop"]),
                                                 abs=1e-7)
    assert (float(mr["moe_drop"]) > 0) == (cf < 1)
    _, _, eid = tmoe.route(tcfg, tp, T(x).reshape(-1, tcfg.d_model))
    probs = jax.nn.softmax((x.reshape(-1, jcfg.d_model) @ jp["router"])
                           .astype(jnp.float32), axis=-1)
    _, eid_r = jax.lax.top_k(probs, jcfg.experts_per_token)
    np.testing.assert_array_equal(eid.numpy(), np.asarray(eid_r))


# ---------------------------------------------------------------------- #
def _rwkv_setup():
    tcfg, jcfg = reduced_config(ARCHS["rwkv6-7b"]), jreduced(JARCHS["rwkv6-7b"])
    tp, jp = ref_params(jrwkv.time_mix_defs(jcfg))
    return tcfg, jcfg, tp, jp


def test_rwkv_chunked_equals_stepwise():
    """Twin of test_models.py::test_rwkv_chunked_equals_stepwise (the
    port's chunked form against its own steps), with the port's own
    weights."""
    cfg = reduced_config(ARCHS["rwkv6-7b"])
    from repro_torch.models.param import init_params
    p = init_params(trwkv.time_mix_defs(cfg), torch.Generator().manual_seed(0))
    b, s, d = 2, 24, cfg.d_model
    h, hd = trwkv.rwkv_heads(cfg), cfg.rwkv_head_dim
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(1)) \
        * 0.5
    st0 = (torch.zeros((b, h, hd, hd)), torch.zeros((b, d)))
    y_chunk, (S_c, _) = trwkv.time_mix_chunked(cfg, p, x, st0, chunk=8)
    st, ys = st0, []
    for t in range(s):
        y, st = trwkv.time_mix_step(cfg, p, x[:, t], st)
        ys.append(y)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(S_c.numpy(), st[0].numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("s,chunk", [(24, 8), (21, 8)])
def test_rwkv_time_mix_matches_reference(s, chunk):
    """Chunked (21 pads the last chunk), the step, and channel mix."""
    tcfg, jcfg, tp, jp = _rwkv_setup()
    rng = np.random.default_rng(s)
    b, d = 2, tcfg.d_model
    h, hd = trwkv.rwkv_heads(tcfg), tcfg.rwkv_head_dim
    x = normal(rng, b, s, d, scale=0.5)
    S0, prev = normal(rng, b, h, hd, hd, scale=0.1), normal(rng, b, d)
    y, (S, last) = trwkv.time_mix_chunked(tcfg, tp, T(x), (T(S0), T(prev)),
                                          chunk=chunk)
    yr, (Sr, lastr) = jrwkv.time_mix_chunked(jcfg, jp, x, (S0, prev),
                                             chunk=chunk)
    close(y, yr)
    close(S, Sr)
    close(last, lastr)
    y1, (S1, _) = trwkv.time_mix_step(tcfg, tp, T(x[:, 0]), (T(S0), T(prev)))
    y1r, (S1r, _) = jrwkv.time_mix_step(jcfg, jp, x[:, 0], (S0, prev))
    close(y1, y1r)
    close(S1, S1r)
    cp, cpj = ref_params(jrwkv.channel_mix_defs(jcfg), seed=1)
    yc, lc = trwkv.channel_mix(tcfg, cp, T(x), T(prev))
    ycr, lcr = jrwkv.channel_mix(jcfg, cpj, x, prev)
    close(yc, ycr)
    close(lc, lcr)
    close(trwkv.channel_mix_step(tcfg, cp, T(x[:, 0]), T(prev))[0],
          jrwkv.channel_mix_step(jcfg, cpj, x[:, 0], prev)[0])


# ---------------------------------------------------------------------- #
def test_ssm_scan_equals_stepwise():
    """Twin of test_models.py::test_ssm_scan_equals_stepwise, with the
    port's own weights."""
    cfg = reduced_config(ARCHS["hymba-1.5b"])
    from repro_torch.models.param import init_params
    p = init_params(tssm.ssm_defs(cfg), torch.Generator().manual_seed(0))
    b, s, d = 2, 20, cfg.d_model
    h, n = cfg.ssm_heads, cfg.ssm_state
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(1)) \
        * 0.5
    h0 = torch.zeros((b, h, d // h, n))
    y_scan, h_fin = tssm.ssm_scan(cfg, p, x, h0, chunk=8)
    hc, ys = h0, []
    for t in range(s):
        y, hc = tssm.ssm_step(cfg, p, x[:, t], hc)
        ys.append(y)
    np.testing.assert_allclose(y_scan.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h_fin.numpy(), hc.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_ssm_matches_reference():
    tcfg, jcfg = reduced_config(ARCHS["hymba-1.5b"]), \
        jreduced(JARCHS["hymba-1.5b"])
    # a non-trivial A: the reference's init has Alog = 0
    tp, jp = ref_params(jssm.ssm_defs(jcfg))
    rng = np.random.default_rng(3)
    alog = normal(rng, *jp["Alog"].shape, scale=0.5)
    tp["Alog"], jp["Alog"] = T(alog), jnp.asarray(alog)
    b, s, d = 2, 20, tcfg.d_model
    h, n = tcfg.ssm_heads, tcfg.ssm_state
    x = normal(rng, b, s, d, scale=0.5)
    h0 = normal(rng, b, h, d // h, n, scale=0.1)
    y, hf = tssm.ssm_scan(tcfg, tp, T(x), T(h0), chunk=8)
    yr, hfr = jssm.ssm_scan(jcfg, jp, x, h0, chunk=8)
    close(y, yr)
    close(hf, hfr)
    y1, h1 = tssm.ssm_step(tcfg, tp, T(x[:, 0]), T(h0))
    y1r, h1r = jssm.ssm_step(jcfg, jp, x[:, 0], h0)
    close(y1, y1r)
    close(h1, h1r)
