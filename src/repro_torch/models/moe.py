"""Mixture-of-experts FFN with capacity-based dispatch.

Capacity C = ceil(T*K/E * capacity_factor) (rounded up to 8, at least 8);
overflow tokens are dropped (Switch-style), with the drop fraction
reported in metrics.  On one card the reference's shard-local dispatch
has one data shard (n_dp = 1): its positions come from an exclusive
cumsum over all token slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import PD


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


def route(cfg, p, xt):
    """Router over tokens xt [T, d]: (probs [T, E] f32, gate [T, K]
    renormalized, eid [T, K] int64 in top_k order)."""
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eid


def moe_ffn(cfg, p, x):
    """x [B, S, D] -> (y [B, S, D], metrics dict).

    A slot's position in its expert is the exclusive cumsum of earlier
    slots routed there, in token-slot order: the reference's 'local'
    dispatch with one data shard, which places every slot where its
    'global_sort' dispatch does.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    c = capacity(cfg, t)
    xt = x.reshape(t, d)
    probs, gate, eid = route(cfg, p, xt)

    eid_f = eid.reshape(t * k)
    one_hot = F.one_hot(eid_f, e)                           # [T*K, E]
    pos_all = torch.cumsum(one_hot, dim=0) - one_hot        # exclusive
    pos = torch.gather(pos_all, 1, eid_f[:, None])[:, 0]    # [T*K]
    keep = pos < c
    dest = torch.where(keep, eid_f * c + pos, e * c)        # spare row e*c
    tok = torch.arange(t * k, device=x.device) // k

    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xt[tok]
    y_e = _experts(p, buf[: e * c].reshape(e, c, d))
    y_l = torch.cat([y_e.reshape(e * c, d),
                     torch.zeros((1, d), dtype=y_e.dtype, device=x.device)])
    contrib = y_l[dest] * gate.reshape(t * k)[:, None].to(y_l.dtype)
    out = torch.zeros((t, d), dtype=y_l.dtype,
                      device=x.device).index_add_(0, tok, contrib)
    if cfg.n_shared_experts:
        hs = F.silu(xt @ p["sw1"]) * (xt @ p["sw3"])
        out = out + hs @ p["sw2"]
    frac_tok = F.one_hot(eid[:, 0], e).float().mean(0)
    aux = e * torch.sum(frac_tok * probs.mean(0))
    dropped = 1.0 - keep.float().mean()
    return out.reshape(b, s, d), {"moe_aux": aux, "moe_drop": dropped}
