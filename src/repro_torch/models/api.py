"""Public model API: train and serve step functions (loss, train step,
prefill, decode), model init, input batches, the dry-run's abstract
inputs and the sharding spec trees — everything a trainer, a server, a
smoke run or the launcher touches.

`init_model` puts the parameters on the card unless `device="cpu"` is
passed.  Without a mesh the step functions run on the device of the
parameters they are given.  With a mesh (a torch DeviceMesh whose axes
are the reference's: 'data' / ('pod', 'data') and 'model') they take
DTensors placed by the pspec trees (`model_pspecs`, `opt_pspecs`,
`batch_pspecs`, `cache_pspecs`; `runtime.reshard` places a tree) and
constrain the activations as the reference does; plain tensors that meet
them (positions, masks, the step) count as replicated.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs.base import ModelConfig, InputShape, TrainConfig
from ..kernels.ops import resolve_device
from ..optim import adamw_update, clip_by_global_norm, cosine_schedule
from ..tree import tree_from_leaves, tree_leaves, tree_map
from .param import (PD, PS, init_params, abstract_params, param_pspecs,
                    make_rules, mesh_sizes, placements, Rules)
from .nn_ops import Sharder
from . import transformer as tf

DECODE_PAD = 128     # extra slots after the prefilled cache

_FLOATS = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------- #
def tp_size(mesh) -> int:
    if mesh is None:
        return 1
    return mesh_sizes(mesh).get("model", 1)


def dp_axes(mesh) -> tuple:
    if mesh is None:
        return ()
    return tuple(a for a in mesh_sizes(mesh) if a != "model")


def make_sharder(cfg: ModelConfig, mesh) -> Sharder:
    tp = tp_size(mesh)
    dp = dp_axes(mesh)
    dp = dp if len(dp) != 1 else dp[0]
    return Sharder(
        mesh=mesh,
        dp=dp,
        tp_heads=cfg.num_heads % tp == 0,
        tp_kv=cfg.num_kv_heads % tp == 0,
    )


def make_param_rules(cfg: ModelConfig, mesh, zero3: bool) -> Rules:
    tp = tp_size(mesh)
    return make_rules(mesh, tp_heads=cfg.num_heads % tp == 0,
                      tp_kv=cfg.num_kv_heads % tp == 0, zero3=zero3)


def model_pspecs(cfg: ModelConfig, mesh, zero3: bool = False):
    return param_pspecs(tf.model_defs(cfg), make_param_rules(cfg, mesh, zero3))


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, cache_len: int,
                 zero3: bool = False):
    return param_pspecs(tf.cache_defs(cfg, batch, cache_len),
                        make_param_rules(cfg, mesh, zero3))


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16


def abstract_model(cfg: ModelConfig):
    """The parameter tree as meta tensors (no memory)."""
    return abstract_params(tf.model_defs(cfg), param_dtype(cfg))


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


_BATCH_DTYPES = {"tokens": torch.int32, "labels": torch.int32,
                 "mask": torch.bool, "frames": torch.bfloat16,
                 "patches": torch.bfloat16}


def batch_abstract(cfg, shape):
    """One batch of `shape` as meta tensors."""
    return {k: torch.empty(pd.shape, dtype=_BATCH_DTYPES[k], device="meta")
            for k, pd in batch_defs(cfg, shape).items()}


def batch_pspecs(cfg, shape, mesh, zero3=False):
    rules = make_param_rules(cfg, mesh, zero3)
    return {k: rules.spec(pd) for k, pd in batch_defs(cfg, shape).items()}


def decode_cache_len(cfg, shape: InputShape) -> int:
    if cfg.attn_type == "sliding":
        return cfg.num_meta_tokens + cfg.window
    return shape.seq_len + DECODE_PAD


def cache_abstract(cfg, shape: InputShape):
    """A full decode cache of `shape` as meta tensors: positions int32,
    recurrent states (S, h) fp32, the rest in the activation dtype."""
    defs = tf.cache_defs(cfg, shape.global_batch,
                         decode_cache_len(cfg, shape))
    act = tf.cfg_dtype(cfg)

    def meta(pd, dt):
        return torch.empty(pd.shape, dtype=dt, device="meta")
    blocks = {k: meta(pd, torch.float32 if k in ("S", "h") else act)
              for k, pd in defs["blocks"].items()}
    return {"blocks": blocks,
            "slot_pos": meta(defs["slot_pos"], torch.int32),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def opt_abstract(cfg: ModelConfig, tcfg: TrainConfig):
    dt = torch.float32 if tcfg.opt_state_dtype == "float32" \
        else torch.bfloat16
    p = abstract_model(cfg)

    def zeros(x):
        return torch.empty(x.shape, dtype=dt, device="meta")
    return {"m": tree_map(zeros, p), "v": tree_map(zeros, p),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_pspecs(cfg: ModelConfig, mesh, zero3=False):
    ps = model_pspecs(cfg, mesh, zero3)
    return {"m": ps, "v": ps, "step": PS()}


def _meshed(mesh):
    """Decorator of the step functions: with a mesh they run under
    implicit_replication, where plain tensors that meet DTensors
    (positions, masks, the step) count as replicated."""
    def wrap(fn):
        if mesh is None:
            return fn
        from torch.distributed.tensor.experimental import \
            implicit_replication

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with implicit_replication():
                return fn(*args, **kwargs)
        return run
    return wrap


# ---------------------------------------------------------------------- #
# Step functions
# ---------------------------------------------------------------------- #
def make_loss_fn(cfg: ModelConfig, mesh=None, *, remat=True):
    """(params, batch) -> (loss, metrics), the parameters cast to the
    activation dtype inside the graph (gradients reach the masters)."""
    shd = make_sharder(cfg, mesh)

    @_meshed(mesh)
    def loss(params, batch):
        return tf.loss_fn(cfg, cast_params(cfg, params), batch, shd,
                          remat=remat)
    return loss


def _split_rows(batch, n: int, shd: Sharder) -> list:
    """n contiguous row groups of every batch entry (the reference's
    reshape(n, B // n, ...)).  Under a mesh each entry is gathered first
    (the batch is ids: small) and every group is spread over the data
    ranks again, each rank holding its slice of the group's rows, as the
    reference's microbatches are."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    per = b // n
    if shd.mesh is not None:
        batch = {k: shd.c(v) for k, v in batch.items()}
    return [{k: shd.c(v[i * per:(i + 1) * per], shd.dp)
             for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
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
    parameters' device: nothing waits for the host.

    With a mesh the parameters, state and batch are DTensors (placed by
    model_pspecs / opt_pspecs with tcfg.zero3, and batch_pspecs), and
    every gradient is redistributed to its parameter's placements (the
    data-parallel reduction; under ZeRO-3 a reduce-scatter over the data
    axes).  `tcfg.zero3` shapes only those placements, as in the
    reference; without a mesh it changes nothing."""
    bf16_grads = tcfg.grad_dtype == "bfloat16"
    dt = tf.cfg_dtype(cfg)
    n_mb = tcfg.microbatch
    shd = make_sharder(cfg, mesh)
    specs = (dict(tree_leaves(model_pspecs(cfg, mesh, tcfg.zero3)))
             if mesh is not None else None)

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
        loss, metrics = tf.loss_fn(cfg, tree, batch, shd, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, [wrt[p] for p in paths])
        if specs is not None:
            grads = [g.redistribute(mesh, placements(specs[p], mesh))
                     for p, g in zip(paths, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_from_leaves(zip(paths, grads)))

    @_meshed(mesh)
    def train_step(params, opt_state, batch, step):
        dev = params["final_norm"].device
        batch = {k: tf.as_input(v, dev) for k, v in batch.items()}
        if n_mb == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            acc = dict(tree_leaves(grads))
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            ms = []
            for mb in _split_rows(batch, n_mb, shd):
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


def make_prefill_fn(cfg: ModelConfig, mesh=None, *, cache_len=0):
    """(params, batch) -> (last logits [B, V] f32, cache)."""
    shd = make_sharder(cfg, mesh)

    @_meshed(mesh)
    def fn(params, batch):
        return tf.prefill(cfg, cast_params(cfg, params), batch, shd,
                          cache_len=cache_len)
    return fn


def make_decode_fn(cfg: ModelConfig, mesh=None):
    """(params, cache, tokens [B]) -> (logits [B, V] f32, new cache).
    The attention caches are written in place (transformer.decode_step)."""
    shd = make_sharder(cfg, mesh)

    @_meshed(mesh)
    def fn(params, cache, tokens):
        return tf.decode_step(cfg, cast_params(cfg, params), cache, tokens,
                              shd)
    return fn
