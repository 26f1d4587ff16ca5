"""Shared neural ops: norms, rotary, flash attention (chunked online
softmax, memory-bounded), decode attention over (possibly ring) KV caches,
FFNs.

Attention memory discipline: full [S, S] score materialization is never
allowed.  `flash_attention` walks KV in chunks with an online softmax
(running max / normalizer), keeping peak block memory at
B*H*S_q*kv_chunk.  All of it is plain PyTorch: the reference computes it
in jnp, with no Pallas kernel.

The reference's products with `preferred_element_type=float32` go through
`matmul_f32`: bf16 operands, fp32 result.  `chunked_cross_entropy` is the
training loss head: logits one sequence chunk at a time, recomputed in
the backward pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------------- #
class _MatmulF32(torch.autograd.Function):
    """Half operands on the card, fp32 result (torch.mm / torch.bmm with
    out_dtype, which have no derivative of their own).  The backward is
    the reference's transpose rule for a dot with
    preferred_element_type=float32: the fp32 cotangent times the other
    operand gives an fp32 product, cast to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D or batched 3-D) with an fp32 result, as jnp's
    preferred_element_type=float32: products of the operands' dtype summed
    in fp32.  On the card a bf16 product runs on the tensor cores with an
    fp32 output (_MatmulF32); elsewhere (and for fp32 operands) the
    operands are widened, which is exact for bf16."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def rms_norm(x, gamma, eps=1e-5):
    h = x.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rotary(x, positions, theta=10_000.0):
    """x [..., S, hd] (hd even), positions [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [..., S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def ffn(x, w1, w2, w3=None):
    """SwiGLU when w3 given, GELU 2-matrix otherwise (jax.nn.gelu's tanh
    form)."""
    if w3 is not None:
        h = F.silu(x @ w1) * (x @ w3)
    else:
        h = F.gelu(x @ w1, approximate="tanh")
    return h @ w2


# ---------------------------------------------------------------------- #
def _mask_block(qpos, kpos, *, causal, window, n_meta):
    """[qc, kc] boolean: True = attend."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window:
        in_window = (qpos[:, None] - kpos[None, :]) < window
        is_meta = kpos[None, :] < n_meta
        ok &= in_window | is_meta
    return ok


def flash_attention(q, k, v, *, causal=True, window=0, n_meta=0,
                    kv_chunk=1024, softmax_scale=None):
    """q [B, Hq, Sq, hd]; k, v [B, Hkv, Skv, hd] -> [B, Hq, Sq, hd].

    GQA via head grouping; online softmax over KV chunks.  The causal
    rectangle is masked, not skipped, as in the reference.
    """
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = softmax_scale or hd ** -0.5
    dev = q.device
    # [B*Hkv, G*Sq, hd]: one batched product per chunk covers every group
    qg = q.reshape(b * hkv, g * sq, hd)
    kv_chunk = min(kv_chunk, skv)
    skv_real = skv
    if skv % kv_chunk:                       # pad KV; padded keys masked off
        pad = kv_chunk - skv % kv_chunk
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        skv = skv + pad
    nk = skv // kv_chunk
    kf = k.reshape(b * hkv, skv, hd)
    vf = v.reshape(b * hkv, skv, hd)
    qpos = torch.arange(sq, device=dev)

    acc = torch.zeros((b * hkv, g, sq, hd), dtype=torch.float32, device=dev)
    m = torch.full((b * hkv, g, sq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b * hkv, g, sq), dtype=torch.float32, device=dev)
    for ki in range(nk):
        lo = ki * kv_chunk
        kb, vb = kf[:, lo:lo + kv_chunk], vf[:, lo:lo + kv_chunk]
        s = matmul_f32(qg, kb.transpose(1, 2)).view(
            b * hkv, g, sq, kv_chunk) * scale
        kpos = lo + torch.arange(kv_chunk, device=dev)
        ok = _mask_block(qpos, kpos, causal=causal, window=window,
                         n_meta=n_meta)
        ok &= (kpos < skv_real)[None, :]
        s = torch.where(ok, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # guard -inf rows (no valid key yet)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(ok, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        pv = matmul_f32(p.to(vb.dtype).view(b * hkv, g * sq, kv_chunk), vb)
        acc = acc * corr[..., None] + pv.view(b * hkv, g, sq, hd)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(b, hq, sq, hd).to(q.dtype)


# ---------------------------------------------------------------------- #
def decode_attention(q, k_cache, v_cache, slot_positions, pos, *,
                     window=0, n_meta=0, softmax_scale=None):
    """Single-step attention over a cache.

    q [B, Hq, hd]; caches [B, Hkv, C, hd]; slot_positions [C] int32 (the
    absolute position stored in each slot, -1 = empty); pos = current
    query position (0-d int32 tensor, read on the device).
    """
    b, hq, hd = q.shape
    _, hkv, c, _ = k_cache.shape
    g = hq // hkv
    scale = softmax_scale or hd ** -0.5
    qg = q.reshape(b * hkv, g, hd)
    s = matmul_f32(qg, k_cache.reshape(b * hkv, c, hd).transpose(1, 2)) \
        * scale                                            # [B*Hkv, G, C]
    valid = (slot_positions >= 0) & (slot_positions <= pos)
    if window:
        in_w = (pos - slot_positions) < window
        valid &= in_w | (slot_positions < n_meta)
    s = torch.where(valid, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = matmul_f32(p.to(v_cache.dtype), v_cache.reshape(b * hkv, c, hd))
    return out.reshape(b, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------- #
def _ce_chunk(x, embed, labels, mask):
    """Summed NLL and mask count of one chunk: x [B, c, D], embed [V, D],
    labels [B, c] int64, mask [B, c] float32."""
    b, c, d = x.shape
    logits = matmul_f32(x.reshape(b * c, d), embed.t()).view(b, c, -1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def chunked_cross_entropy(x, embed, labels, *, chunk=512, mask=None):
    """Next-token CE without materializing [B, S, V] logits.

    x [B, S, D]; embed [V, D]; labels [B, S] int; mask [B, S] optional.
    Walks sequence chunks; where autograd records, each chunk is
    checkpointed, so its [B, chunk, V] fp32 logits are recomputed in the
    backward pass and never kept (the reference: jax.checkpoint on the
    scan body).  Returns sum(nll·mask) / max(sum(mask), 1).
    """
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    labels = labels.long()
    mask = (torch.ones((b, s), dtype=torch.float32, device=x.device)
            if mask is None else mask.to(torch.float32))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        args = (x[:, lo:lo + chunk], embed, labels[:, lo:lo + chunk],
                mask[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            nll, n = checkpoint(_ce_chunk, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, n = _ce_chunk(*args)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
