"""Decode against prefill in repro_torch: twins of the reference's
tests/test_models.py::test_decode_matches_prefill (the port's own weights,
the reference's criterion max|Δ| < 2e-2·max(max|ref|, 1)), plus
granite-moe-1b-a400m with capacity_factor=16 as the reference runs MoE
there, several decode steps, and qwen2-0.5b in bf16 against the reference
in bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import InputShape as JShape
from repro.models import api as japi
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.models import api
from repro_torch.models import convert
from repro_torch.models.param import tree_leaves


def within(got, ref, rel):
    got, ref = got.float(), ref.float()
    err = float(torch.max(torch.abs(got - ref)))
    assert err < rel * max(float(torch.max(torch.abs(ref))), 1.0), err


@pytest.mark.parametrize("name", ["qwen2-0.5b", "rwkv6-7b", "hymba-1.5b",
                                  "paligemma-3b", "granite-moe-1b-a400m"])
def test_decode_matches_prefill(name):
    cfg = reduced_config(ARCHS[name])
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = api.init_model(cfg, 0, device="cpu")
    B, S = 2, 24
    batch = api.concrete_batch(cfg, InputShape("t", S, B, "prefill"), seed=3)
    cache_len = api.decode_cache_len(cfg, InputShape("d", S + 8, B, "decode"))
    _, cache = api.make_prefill_fn(cfg, cache_len=cache_len)(params, batch)
    nxt = np.full(B, 7, np.int32)
    logits2, _ = api.make_decode_fn(cfg)(params, cache, torch.as_tensor(nxt))
    b2 = dict(batch)
    b2["tokens"] = np.concatenate([batch["tokens"], nxt[:, None]], 1)
    ref, _ = api.make_prefill_fn(cfg, cache_len=cache_len)(params, b2)
    within(logits2, ref, 2e-2)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "hymba-1.5b", "rwkv6-7b"])
def test_greedy_decode_steps_match_prefill(name):
    """Four greedy steps; the last step's logits against a prefill of the
    prompt and the four tokens (hymba's ring wraps: 4 meta slots and a
    window of 16 behind 24 tokens)."""
    cfg = reduced_config(ARCHS[name])
    params = api.init_model(cfg, 1, device="cpu")
    B, S, n = 2, 24, 4
    batch = api.concrete_batch(cfg, InputShape("t", S, B, "prefill"), seed=4)
    cache_len = api.decode_cache_len(cfg, InputShape("d", S + n, B, "decode"))
    logits, cache = api.make_prefill_fn(cfg, cache_len=cache_len)(params,
                                                                  batch)
    decode = api.make_decode_fn(cfg)
    fed = []
    for _ in range(n):
        tok = torch.argmax(logits, -1).to(torch.int32)
        fed.append(tok)
        logits, cache = decode(params, cache, tok)
    assert int(cache["pos"]) == S + n + cfg.num_meta_tokens
    b2 = dict(batch)
    b2["tokens"] = np.concatenate(
        [batch["tokens"], torch.stack(fed, 1).numpy()], 1)
    ref, _ = api.make_prefill_fn(cfg, cache_len=cache_len)(params, b2)
    within(logits, ref, 2e-2)


def test_bf16_prefill_and_decode_match_reference():
    """qwen2-0.5b with bf16 activations (fp32 master weights) against the
    reference in bf16, under the reference's 2e-2 criterion (bf16 rounds
    at 2^-8; the two stacks round in different places)."""
    over = dict(dtype="bfloat16")
    jcfg = jreduced(JARCHS["qwen2-0.5b"], **over)
    tcfg = reduced_config(ARCHS["qwen2-0.5b"], **over)
    params = japi.init_model(jcfg, 0)
    tp = convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    B, S = 2, 24
    batch = japi.concrete_batch(jcfg, JShape("t", S, B, "prefill"), seed=3)
    cl = japi.decode_cache_len(jcfg, JShape("d", S + 8, B, "decode"))
    jl, jc = japi.make_prefill_fn(jcfg, cache_len=cl)(params, batch)
    tl, tc = api.make_prefill_fn(tcfg, cache_len=cl)(tp, batch)
    T = lambda a: torch.from_numpy(np.array(a, np.float32))
    within(tl, T(jl), 2e-2)
    assert tc["blocks"]["k"].dtype == torch.bfloat16
    got = dict(tree_leaves(convert.cache_to_numpy(tc)))
    for path, a in tree_leaves(jax.tree.map(np.asarray, jc)):
        within(torch.from_numpy(np.asarray(got[path], np.float32)), T(a),
               2e-2)
    nxt = np.full(B, 7, np.int32)
    jl2, _ = japi.make_decode_fn(jcfg)(params, jc, jnp.asarray(nxt))
    tl2, _ = api.make_decode_fn(tcfg)(tp, tc, torch.as_tensor(nxt))
    within(tl2, T(jl2), 2e-2)
