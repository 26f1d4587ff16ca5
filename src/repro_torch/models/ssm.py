"""Mamba-style selective SSM heads (the SSM half of Hymba's hybrid block).

Per head (dim hd, state size N):
    Δ_t = softplus(x_t W_Δ + b_Δ)            [B, S, H, hd]
    B_t, C_t = x_t W_B, x_t W_C              [B, S, H, N]
    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + Δ_t ⊙ (B_t ⊗ x_t)
    y_t = (h_t · C_t) + D ⊙ x_t
A is a learned negative diagonal (stored as log).  Sequence evaluation is
the exact per-token recurrence; decode is the O(1) step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .param import PD


def ssm_defs(cfg, lead=()):
    d = cfg.d_model
    h, n = cfg.ssm_heads, cfg.ssm_state
    hd = d // h
    la = ("layers",) if lead else ()
    def m(shape, axes, **kw):
        return PD(lead + shape, la + axes, **kw)
    return {
        "Wx": m((d, d), ("embed", "heads")),
        "Wdt": m((d, h), ("embed", None)),
        "bdt": m((h,), (None,), init="zeros"),
        "WB": m((d, h * n), ("embed", None)),
        "WC": m((d, h * n), ("embed", None)),
        "Alog": m((h, hd, n), (None, None, None), init="zeros"),
        "D": m((h, hd), (None, None), init="ones"),
        "Wo": m((d, d), ("heads", "embed")),
    }


def _proj(cfg, p, x):
    b, s, d = x.shape
    h, n = cfg.ssm_heads, cfg.ssm_state
    hd = d // h
    xh = (x @ p["Wx"]).reshape(b, s, h, hd)
    dt = F.softplus(x @ p["Wdt"] + p["bdt"]).float()
    bb = (x @ p["WB"]).reshape(b, s, h, n).float()
    cc = (x @ p["WC"]).reshape(b, s, h, n).float()
    a = -torch.exp(p["Alog"].float())                      # [H, hd, N] < 0
    return xh, dt, bb, cc, a


def ssm_scan(cfg, p, x, h0, chunk: int = 128):
    """x [B,S,D]; h0 [B,H,hd,N] f32.  Returns (y [B,S,D], h_fin).

    A Python loop over tokens.  Each chunk of `chunk` tokens computes its
    decays and increments at once ([B, chunk, H, hd, N]), so the loop
    itself is one multiply-add a token; memory stays at O(chunk) states.
    The reference pads the tail with Δ = 0, which leaves the state as it
    is, so the port walks the real tokens only.
    """
    b, s, d = x.shape
    h, n = cfg.ssm_heads, cfg.ssm_state
    hd = d // h
    xh, dt, bb, cc, a = _proj(cfg, p, x)
    hc = h0
    ys = []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        dtc = dt[:, lo:hi, :, None, None]                  # [B,c,H,1,1]
        decay = torch.exp(dtc * a)                         # [B,c,H,hd,N]
        inc = dtc * bb[:, lo:hi, :, None, :] \
            * xh[:, lo:hi].float()[..., None]
        states = []
        for i in range(hi - lo):
            hc = decay[:, i] * hc + inc[:, i]
            states.append(hc)
        ys.append(torch.einsum("bthdn,bthn->bthd", torch.stack(states, 1),
                               cc[:, lo:hi]))
    y = torch.cat(ys, 1)
    y = y.to(x.dtype) + xh * p["D"][None, None]
    return y.reshape(b, s, d) @ p["Wo"], hc


def ssm_step(cfg, p, x, hc):
    """x [B,D] -> (y [B,D], h_new)."""
    b, d = x.shape
    xh, dt, bb, cc, a = _proj(cfg, p, x[:, None])
    xt, dtt, bt, ct = xh[:, 0], dt[:, 0], bb[:, 0], cc[:, 0]
    decay = torch.exp(dtt[..., None, None] * a[None])
    inc = dtt[..., None, None] * bt[:, :, None, :] \
        * xt.float()[..., None]
    h_new = decay * hc + inc
    y = torch.einsum("bhdn,bhn->bhd", h_new, ct).to(x.dtype)
    y = y + xt * p["D"][None]
    return y.reshape(b, d) @ p["Wo"], h_new
