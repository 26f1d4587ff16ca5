"""Decode against prefill in bf16, the reference and the port side by side.

Runs qwen2-0.5b at its full depth (24 layers) and per-layer width (d 896,
14/2 heads, d_ff 4,864) with the vocabulary cut to 8,192 (the embedding
and the logits are the only parts it sizes), in bf16 activations over fp32
master weights, on the CPU: the reference (repro, JAX) and the port
(repro_torch, device="cpu") on the same weights (the reference's, carried by
params_from_reference) and the same prompt of 2 x --prompt tokens.

For each stack it prints, relative to max|logits| of the prefill it is held
to:
  decode_vs_prefill  one decode step of token 7 against a prefill of the
                     prompt and that token (the reference's criterion,
                     tests/test_models.py, is 2e-2);
  bf16_vs_fp32       the bf16 prefill of prompt + token against the fp32
                     prefill of the same tokens;
and port_vs_reference, the port's bf16 prefill logits against the
reference's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_bf16_witness.py \
        [--prompt 2048]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import InputShape as JShape
from repro.models import api as japi
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape
from repro_torch.models import api, convert


def rel(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


VOCAB, BATCH = 8192, 2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args()
    name, over = "qwen2-0.5b", {"vocab_size": VOCAB}
    t0 = time.perf_counter()
    jcfg = dataclasses.replace(JARCHS[name], **over)
    tcfg = dataclasses.replace(ARCHS[name], **over)
    jparams = japi.init_model(jcfg, 0)
    tparams = convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    b, s = BATCH, args.prompt
    batch = japi.concrete_batch(jcfg, JShape("w", s, b, "prefill"), seed=3)
    cl = japi.decode_cache_len(jcfg, JShape("d", s + 8, b, "decode"))
    nxt = np.full(b, 7, np.int32)
    b2 = dict(batch, tokens=np.concatenate([batch["tokens"], nxt[:, None]],
                                           1))

    def ref_stack(dtype):
        c = dataclasses.replace(jcfg, dtype=dtype)
        pf = japi.make_prefill_fn(c, cache_len=cl)
        _, cache = pf(jparams, batch)
        step, _ = japi.make_decode_fn(c)(jparams, cache, jnp.asarray(nxt))
        full, _ = pf(jparams, b2)
        return np.asarray(step, np.float32), np.asarray(full, np.float32)

    def port_stack(dtype):
        c = dataclasses.replace(tcfg, dtype=dtype)
        pf = api.make_prefill_fn(c, cache_len=cl)
        with torch.no_grad():
            _, cache = pf(tparams, batch)
            step, _ = api.make_decode_fn(c)(tparams, cache,
                                            torch.as_tensor(nxt))
            full, _ = pf(tparams, b2)
        return step.float().numpy(), full.float().numpy()

    out = {"config": name, "layers": jcfg.num_layers,
           "d_model": jcfg.d_model, "vocab": VOCAB, "prompt": [b, s]}
    full = {}
    for name, run in (("reference", ref_stack), ("port", port_stack)):
        step16, full16 = run("bfloat16")
        step32, full32 = run("float32")
        full[name] = full16
        out[name] = {"decode_vs_prefill_bf16": rel(step16, full16),
                     "decode_vs_prefill_fp32": rel(step32, full32),
                     "bf16_vs_fp32_prefill": rel(full16, full32),
                     "max_abs_logits_bf16": float(np.max(np.abs(full16)))}
    out["port_vs_reference_bf16_prefill"] = rel(full["port"],
                                                full["reference"])
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
