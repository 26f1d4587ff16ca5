"""RWKV-6 "Finch" blocks: time-mix with data-dependent decay + channel-mix.

Recurrence (per head, k/v dims = hd):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + (u ⊙ k_t)^T v_t)
with w_t = exp(-exp(w0 + lora(x_t)))  (data-dependent decay, per channel).

Prefill uses the reference's exact *chunked* evaluation: within a chunk of
length c the pairwise decay products exp(Λ_{t-1} - Λ_j) (j <= t-1, Λ =
cumsum log w) are always <= 1, so no overflow is possible.  Cross-chunk
state is carried by a Python loop over chunks.

Decode is the O(1) recurrent step on the state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import PD
from .nn_ops import Sharder, NO_SHARD, per_shard, rms_norm


LORA_R = 64


def rwkv_heads(cfg):
    assert cfg.d_model % cfg.rwkv_head_dim == 0
    return cfg.d_model // cfg.rwkv_head_dim


def time_mix_defs(cfg, lead=()):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = rwkv_heads(cfg)
    la = ("layers",) if lead else ()
    def m(shape, axes, **kw):
        return PD(lead + shape, la + axes, **kw)
    return {
        "mu": m((5, d), (None, "embed")),           # token-shift lerp r,k,v,w,g
        "w0": m((d,), ("embed",), init="zeros"),
        "wA": m((d, LORA_R), ("embed", None)),
        "wB": m((LORA_R, d), (None, "embed")),
        "Wr": m((d, d), ("embed", "heads")),
        "Wk": m((d, d), ("embed", "heads")),
        "Wv": m((d, d), ("embed", "heads")),
        "Wg": m((d, d), ("embed", "heads")),
        "Wo": m((d, d), ("heads", "embed")),
        "u": m((h, hd), ("heads", None), init="zeros"),
        "ln_y": m((d,), ("embed",), init="ones"),
    }


def channel_mix_defs(cfg, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    la = ("layers",) if lead else ()
    def m(shape, axes, **kw):
        return PD(lead + shape, la + axes, **kw)
    return {
        "mu": m((2, d), (None, "embed")),
        "Wk": m((d, f), ("embed", "ff")),
        "Wv": m((f, d), ("ff", "embed")),
        "Wr": m((d, d), ("embed", "embed")),
    }


def _shift(x, prev):
    """x [B,S,D], prev [B,D] = last token of previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _projections(p, x, xprev):
    def lerp(i):
        return x + (xprev - x) * p["mu"][i]
    r, k, v, w_in, g = (lerp(i) for i in range(5))
    logw = -torch.exp(p["w0"] + torch.tanh(w_in @ p["wA"]) @ p["wB"])
    logw = torch.clamp(logw, -50.0, -1e-4).float()
    return r @ p["Wr"], k @ p["Wk"], v @ p["Wv"], logw, F.silu(g @ p["Wg"])


def _wkv_chunks(r, k, v, logw, u, S, c: int):
    """The chunked WKV recurrence: r, k, v, logw [B, S, H*hd] (S a
    multiple of c), u [H, hd], S [B, H, hd, hd] f32 ->
    (y [B, S, H*hd] f32, the new S).  Heads and rows are independent."""
    b, s, dh = r.shape
    hd = S.shape[-1]
    h = dh // hd
    nc = s // c

    def heads(z):  # [B,S,D] -> [B, H, nc, c, hd] f32
        return z.float().reshape(b, nc, c, h, hd).permute(0, 3, 1, 2, 4)
    rh, kh, vh, lw = heads(r), heads(k), heads(v), heads(logw)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     -1)
    ys = []
    for i in range(nc):
        rc, kc, vc, lwc = rh[:, :, i], kh[:, :, i], vh[:, :, i], lw[:, :, i]
        lam = torch.cumsum(lwc, dim=2)                 # inclusive Λ_t
        lam_ex = lam - lwc                             # exclusive Λ_{t-1}
        # state contribution: (r_t ⊙ e^{Λ_{t-1}}) S_prev
        rS = torch.einsum("bhtd,bhde->bhte", rc * torch.exp(lam_ex), S)
        # intra-chunk: A[t,j] = Σ_d r_t k_j e^{Λ_{t-1}-Λ_j}, j < t.
        # For j = t-1 the difference is exactly 0 in real arithmetic but
        # can round to +eps in fp32 cumsums — clamp, don't mask (j >= t is
        # excluded by the tri mask below).
        diff = lam_ex[:, :, :, None, :] - lam[:, :, None, :, :]  # [B,H,t,j,d]
        decay = torch.exp(torch.clamp(diff, max=0.0))
        a = torch.einsum("bhtd,bhjd,bhtjd->bhtj", rc, kc, decay)
        a = torch.where(tri, a, 0.0)
        diag = torch.einsum("bhtd,hd,bhtd->bht", rc, u, kc)
        ys.append(rS + torch.einsum("bhtj,bhjd->bhtd", a, vc)
                  + diag[..., None] * vc)
        # new state: e^{Λ_c} ⊙ S + Σ_j e^{Λ_c - Λ_j} k_j ⊗ v_j
        lam_c = lam[:, :, -1:, :]                      # [B,H,1,d]
        kdec = kc * torch.exp(lam_c - lam)
        S = torch.exp(lam_c[:, :, 0, :, None]) * S \
            + torch.einsum("bhjd,bhje->bhde", kdec, vc)
    return torch.stack(ys, 2).permute(0, 2, 3, 1, 4).reshape(b, s, dh), S


def _wkv_step(r, k, v, logw, u, S0):
    """One token: r, k, v, logw [B, H*hd], u [H, hd], S0 [B, H, hd, hd]
    f32 -> (y [B, H*hd] f32, the new S)."""
    b, dh = r.shape
    hd = S0.shape[-1]
    h = dh // hd

    def hs(z):
        return z.reshape(b, h, hd).float()
    rh, kh, vh = hs(r), hs(k), hs(v)
    w = torch.exp(hs(logw))
    kv = torch.einsum("bhd,bhe->bhde", kh, vh)
    y = torch.einsum("bhd,bhde->bhe", rh, S0 + u[None, :, :, None] * kv)
    return y.reshape(b, dh), w[..., None] * S0 + kv


def _per_head_shard(fn, shd: Sharder, h: int, acts, u, S):
    """fn(*acts, u, S) on each rank's heads under a mesh (heads over
    'model' where they divide it, rows over the data axes): the
    recurrence never mixes heads or rows."""
    if shd.mesh is None:
        return fn(*acts, u, S)
    hax = "model" if h % shd.size("model") == 0 else None
    acts = [shd.c(a, shd.dp, *([None] * (a.ndim - 2)), hax) for a in acts]
    u = shd.c(u, hax, None)
    S = shd.c(S, shd.dp, hax, None, None)
    return per_shard(fn, [acts[0].placements, S.placements], *acts, u, S)


def time_mix_chunked(cfg, p, x, state, chunk=None,
                     shd: Sharder = NO_SHARD):
    """x [B,S,D]; state (S [B,H,hd,hd] f32, prev_x [B,D]).

    Returns (y [B,S,D], new_state)."""
    b, s_real, d = x.shape
    c = min(chunk or cfg.rwkv_chunk, s_real)
    S, prev_x = state
    x_last = x[:, -1]

    r, k, v, logw, g = _projections(p, x, _shift(x, prev_x))
    if s_real % c:
        # pad tail: k=0 and logw=0 make padded steps state-neutral
        pad = c - s_real % c
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    y, S = _per_head_shard(lambda *a: _wkv_chunks(*a, c), shd,
                           rwkv_heads(cfg), (r, k, v, logw),
                           p["u"].float(), S)
    y = y[:, :s_real]
    y = rms_norm(y.to(x.dtype), p["ln_y"], cfg.norm_eps) * g
    out = y @ p["Wo"]
    return out, (S, x_last)


def time_mix_step(cfg, p, x, state, shd: Sharder = NO_SHARD):
    """Single-token decode: x [B,D] -> (y [B,D], new_state)."""
    S0, prev_x = state
    r, k, v, logw, g = _projections(p, x[:, None], prev_x[:, None])
    y, S_new = _per_head_shard(_wkv_step, shd, rwkv_heads(cfg),
                               (r[:, 0], k[:, 0], v[:, 0], logw[:, 0]),
                               p["u"].float(), S0)
    y = rms_norm(y.to(x.dtype), p["ln_y"], cfg.norm_eps) * g[:, 0]
    return y @ p["Wo"], (S_new, x)


def channel_mix(cfg, p, x, prev_x):
    """x [B,S,D], prev_x [B,D] -> (y, last_x)."""
    xprev = _shift(x, prev_x)
    xk = x + (xprev - x) * p["mu"][0]
    xr = x + (xprev - x) * p["mu"][1]
    kk = torch.square(torch.relu(xk @ p["Wk"]))
    return torch.sigmoid(xr @ p["Wr"]) * (kk @ p["Wv"]), x[:, -1]


def channel_mix_step(cfg, p, x, prev_x):
    xk = x + (prev_x - x) * p["mu"][0]
    xr = x + (prev_x - x) * p["mu"][1]
    kk = torch.square(torch.relu(xk @ p["Wk"]))
    return torch.sigmoid(xr @ p["Wr"]) * (kk @ p["Wv"]), x
