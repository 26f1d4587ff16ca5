"""Public model API: serve step functions (prefill, decode), model init and
input batches — what a server or a smoke run touches.

Everything runs on one device: `init_model` puts the parameters on the
card unless `device="cpu"` is passed, and the step functions run on the
device of the parameters they are given.  Training (`make_train_step`,
`make_loss_fn`) and the dry-run tools (meshes, pspecs, `abstract_*`) are
not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, InputShape
from ..kernels.ops import resolve_device
from .param import PD, init_params
from . import transformer as tf

DECODE_PAD = 128     # extra slots after the prefilled cache

_FLOATS = (torch.float32, torch.bfloat16)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """The parameter tree of `cfg`, drawn from a torch.Generator seeded
    with `seed` on `device` (the card unless "cpu" is asked for; CUDA
    asked for and missing raises)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(tf.model_defs(cfg), gen, param_dtype(cfg), dev)


def cast_params(cfg: ModelConfig, params):
    """Every float leaf in the activation dtype, as the reference's step
    functions do at each call (a no-op when the dtypes agree)."""
    dt = tf.cfg_dtype(cfg)
    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        return x.to(dt) if x.dtype in _FLOATS else x
    return cast(params)


# ---------------------------------------------------------------------- #
# Batches
# ---------------------------------------------------------------------- #
def batch_defs(cfg: ModelConfig, shape: InputShape):
    """PD tree for one input batch of the given shape."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if shape.kind == "decode":
        return {"tokens": PD((b,), ("batch",))}
    out = {}
    if cfg.frontend == "audio":
        out["frames"] = PD((b, s, d), ("batch", None, None))
    else:
        out["tokens"] = PD((b, s), ("batch", None))
        if cfg.frontend == "vision":
            out["patches"] = PD((b, cfg.num_prefix_tokens, d),
                                ("batch", None, None))
    if shape.kind == "train":
        out["labels"] = PD((b, s), ("batch", None))
        if cfg.family == "encoder":
            out["mask"] = PD((b, s), ("batch", None))
    return out


def concrete_batch(cfg, shape, seed=0):
    """Real (host, numpy) batch for smoke tests and examples: the same
    numpy draws, in the same key order, as the reference's."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, pd in batch_defs(cfg, shape).items():
        if k in ("tokens", "labels"):
            out[k] = rng.integers(0, cfg.vocab_size, pd.shape,
                                  dtype=np.int32)
        elif k == "mask":
            out[k] = rng.random(pd.shape) < 0.1
        else:
            out[k] = rng.normal(0, 1, pd.shape).astype(np.float32)
    return out


def decode_cache_len(cfg, shape: InputShape) -> int:
    if cfg.attn_type == "sliding":
        return cfg.num_meta_tokens + cfg.window
    return shape.seq_len + DECODE_PAD


# ---------------------------------------------------------------------- #
# Step functions
# ---------------------------------------------------------------------- #
def make_prefill_fn(cfg: ModelConfig, *, cache_len=0):
    """(params, batch) -> (last logits [B, V] f32, cache)."""
    def fn(params, batch):
        return tf.prefill(cfg, cast_params(cfg, params), batch,
                          cache_len=cache_len)
    return fn


def make_decode_fn(cfg: ModelConfig):
    """(params, cache, tokens [B]) -> (logits [B, V] f32, new cache).
    The attention caches are written in place (transformer.decode_step)."""
    def fn(params, cache, tokens):
        return tf.decode_step(cfg, cast_params(cfg, params), cache, tokens)
    return fn
