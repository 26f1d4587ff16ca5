"""Public model API: train and serve step functions (loss, train step,
prefill, decode), model init and input batches — what a trainer, a server
or a smoke run touches.

Everything runs on one device: `init_model` puts the parameters on the
card unless `device="cpu"` is passed, and the step functions run on the
device of the parameters they are given.  The dry-run tools (meshes,
pspecs, `abstract_*`) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, InputShape, TrainConfig
from ..kernels.ops import resolve_device
from ..optim import adamw_update, clip_by_global_norm, cosine_schedule
from ..tree import tree_from_leaves, tree_leaves, tree_map
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
    return tree_map(lambda x: x.to(dt) if x.dtype in _FLOATS else x, params)


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
def make_loss_fn(cfg: ModelConfig, *, remat=True):
    """(params, batch) -> (loss, metrics), the parameters cast to the
    activation dtype inside the graph (gradients reach the masters)."""
    def loss(params, batch):
        return tf.loss_fn(cfg, cast_params(cfg, params), batch, remat=remat)
    return loss


def _split_rows(batch, n: int) -> list:
    """n contiguous row groups of every batch entry (the reference's
    reshape(n, B // n, ...))."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    per = b // n
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    Gradients of every float leaf: with grad_dtype "bfloat16" with respect
    to the copies in the activation dtype (bf16 gradients), otherwise
    through the cast of the masters.  With microbatch n the batch's rows
    are n contiguous groups, each one's gradients taken by
    torch.autograd.grad and summed into fp32 accumulators; loss and
    metrics are the groups' means.  Then global-norm clipping, the cosine
    learning rate and AdamW, which writes the new parameters and state
    into `params` and `opt_state` (optim.adamw_update).  The metrics
    {"loss", "grad_norm", "lr", **loss metrics} are 0-d tensors on the
    parameters' device: nothing waits for the host.  `tcfg.zero3` is
    ignored, as the reference ignores it without a mesh."""
    bf16_grads = tcfg.grad_dtype == "bfloat16"
    dt = tf.cfg_dtype(cfg)
    n_mb = tcfg.microbatch

    def grad_fn(params, batch):
        paths = [p for p, x in tree_leaves(params) if x.dtype in _FLOATS]
        leaves = dict(tree_leaves(params))
        if bf16_grads:
            # differentiate wrt the activation-dtype copies: the gradients
            # stay in that dtype; the masters are updated by the optimizer
            wrt = {p: leaves[p].detach().to(dt).requires_grad_()
                   for p in paths}
            cast = wrt
        else:
            wrt = {p: leaves[p].detach().requires_grad_() for p in paths}
            cast = {p: w.to(dt) for p, w in wrt.items()}
        tree = tree_from_leaves({**leaves, **cast})
        loss, metrics = tf.loss_fn(cfg, tree, batch, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, [wrt[p] for p in paths])
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_from_leaves(zip(paths, grads)))

    def train_step(params, opt_state, batch, step):
        dev = params["final_norm"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if n_mb == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=dev), params)
            acc = dict(tree_leaves(grads))
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            ms = []
            for mb in _split_rows(batch, n_mb):
                l, m, g = grad_fn(params, mb)
                for path, gl in tree_leaves(g):
                    acc[path].add_(gl)          # exact: fp32 += bf16
                loss = loss + l
                ms.append(m)
            for g in acc.values():
                g.div_(n_mb)
            loss = loss / n_mb
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        lr = cosine_schedule(torch.as_tensor(step, device=dev), lr=tcfg.lr,
                             warmup=tcfg.warmup,
                             total_steps=tcfg.total_steps)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr,
            b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
            weight_decay=tcfg.weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **metrics}
        return params, opt_state, metrics
    return train_step


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
