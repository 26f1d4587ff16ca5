"""Mixture-of-experts FFN with capacity-based shard-local dispatch.

Capacity C = ceil(T*K/E * capacity_factor) (rounded up to 8, at least 8)
per data shard; overflow tokens are dropped (Switch-style), with the drop
fraction reported in metrics.  Expert-parallel layout under a mesh:
expert tensors are sharded on the expert dim over 'model'; tokens are
data-sharded.  Each data shard dispatches its own tokens (positions from
an exclusive cumsum over the shard's token slots, its own capacity
slice), so the dispatch never crosses the data sharding; the dispatched
buffer is then redistributed from data-sharded to expert-sharded (the
all-to-all) and back.  Without a mesh there is one data shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import PD
from .nn_ops import Sharder, NO_SHARD, per_shard


def moe_param_defs(cfg, n_layers_dim=None):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_e
    lead = (n_layers_dim,) if n_layers_dim else ()
    la = ("layers",) if n_layers_dim else ()
    defs = {
        "router": PD(lead + (d, e), la + ("embed", "expert")),
        "w1": PD(lead + (e, d, f), la + ("expert", "embed", "ff")),
        "w3": PD(lead + (e, d, f), la + ("expert", "embed", "ff")),
        "w2": PD(lead + (e, f, d), la + ("expert", "ff", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["sw1"] = PD(lead + (d, fs), la + ("embed", "ff"))
        defs["sw3"] = PD(lead + (d, fs), la + ("embed", "ff"))
        defs["sw2"] = PD(lead + (fs, d), la + ("ff", "embed"))
    return defs


def capacity(cfg, t_tokens: int) -> int:
    c = int(t_tokens * cfg.experts_per_token / cfg.num_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _experts(p, buf):
    """buf [E, C, d] through each expert's SwiGLU -> [E, C, d]."""
    h = F.silu(torch.bmm(buf, p["w1"]))
    h = h * torch.bmm(buf, p["w3"])
    return torch.bmm(h, p["w2"])


def route(cfg, p, xt, shd: Sharder = NO_SHARD):
    """Router over tokens xt [T, d]: (probs [T, E] f32, gate [T, K]
    renormalized, eid [T, K] int64 in top_k order).  Under a mesh the
    logits are gathered over the experts first (softmax and top_k need
    every expert)."""
    logits = (xt @ p["router"]).float()
    if shd.mesh is not None:
        logits = shd.c(logits, shd.dp, None)
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eid


def _dp_degree(shd: Sharder, b: int) -> int:
    """Data-parallel group count, if the flattened token dim aligns."""
    if shd.mesh is None:
        return 1
    n = shd.size(shd.dp)
    return n if (n and b % n == 0) else 1


def _dispatch(xt, eid, e: int, c: int):
    """One data shard's dispatch: xt [t, d] tokens, eid [t, K] expert
    ids.  A slot's position in its expert is the exclusive cumsum of the
    shard's earlier slots routed there, in token-slot order.  Returns
    (buf [1, E, C, d], dest [t*K] row of each slot in the buffer, e*c
    where dropped, keep [t*K])."""
    t, d = xt.shape
    k = eid.shape[1]
    eid_f = eid.reshape(t * k)
    one_hot = F.one_hot(eid_f, e)                           # [t*K, E]
    pos_all = torch.cumsum(one_hot, dim=0) - one_hot        # exclusive
    pos = torch.gather(pos_all, 1, eid_f[:, None])[:, 0]    # [t*K]
    keep = pos < c
    dest = torch.where(keep, eid_f * c + pos, e * c)        # spare row e*c
    tok = torch.arange(t * k, device=xt.device) // k
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[tok]
    return buf[: e * c].reshape(1, e, c, d), dest, keep


def _combine(y, dest, gate):
    """One data shard's combine: y [1, E*C, d] expert outputs, dest
    [t*K], gate [t, K] -> [t, d], each token the gate-weighted sum of its
    kept slots' rows."""
    t, k = gate.shape
    d = y.shape[-1]
    y_l = torch.cat([y[0], torch.zeros((1, d), dtype=y.dtype,
                                       device=y.device)])
    contrib = y_l[dest] * gate.reshape(t * k)[:, None].to(y_l.dtype)
    tok = torch.arange(t * k, device=y.device) // k
    return torch.zeros((t, d), dtype=y_l.dtype,
                       device=y.device).index_add_(0, tok, contrib)


def moe_ffn(cfg, p, x, shd: Sharder = NO_SHARD):
    """x [B, S, D] -> (y [B, S, D], metrics dict).

    The reference's 'local' dispatch: each of the n_dp data shards (1
    without a mesh, or where the data axes do not divide the batch)
    dispatches its own T / n_dp tokens into its own capacity slice; with
    one shard every slot lands where the reference's 'global_sort'
    dispatch puts it.
    """
    from_mesh = shd.mesh is not None
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    n_dp = _dp_degree(shd, b)
    c = capacity(cfg, t // n_dp)         # per-shard expert capacity
    xt = x.reshape(t, d)
    probs, gate, eid = route(cfg, p, xt, shd)
    tok_pl = dp_pl = None
    if from_mesh:
        from torch.distributed.tensor import Partial, Replicate, Shard
        dp_names = set(shd.dp if isinstance(shd.dp, tuple) else (shd.dp,))
        split = [n_dp > 1 and name in dp_names
                 for name in shd.mesh.mesh_dim_names]
        tok_pl = [Shard(0) if sp else Replicate() for sp in split]
        dp_pl = [Partial() if sp else Replicate() for sp in split]
        tok_axes = shd.dp if n_dp > 1 else None
        xt = shd.c(xt, tok_axes, None)
        gate, eid = shd.c(gate, tok_axes, None), shd.c(eid, tok_axes, None)
    buf, dest, keep = per_shard(
        lambda xl, el: _dispatch(xl, el, e, c), [tok_pl] * 3, xt, eid)
    # dp-sharded -> expert-sharded: THE all-to-all
    buf = shd.c(buf.transpose(0, 1).reshape(e, n_dp * c, d),
                "model", None, None)
    y_e = shd.c(_experts(p, buf), "model", None, None)
    # back to the dp-sharded layout (the reverse all-to-all)
    y_l = y_e.reshape(e, n_dp, c, d).transpose(0, 1).reshape(
        n_dp, e * c, d)
    y_l = shd.c(y_l, shd.dp if n_dp > 1 else None, None, None)
    out = per_shard(_combine, tok_pl, y_l, dest, gate)
    if cfg.n_shared_experts:
        hs = F.silu(xt @ p["sw1"]) * (xt @ p["sw3"])
        out = out + hs @ p["sw2"]
    if from_mesh:
        out = shd.c(out, tok_axes, None)
    counts = per_shard(lambda el: F.one_hot(el[:, 0], e).float().sum(0),
                       dp_pl, eid)
    aux = e * torch.sum(counts / t * probs.mean(0))
    dropped = 1.0 - keep.float().mean()
    return out.reshape(b, s, d), {"moe_aux": aux, "moe_drop": dropped}
