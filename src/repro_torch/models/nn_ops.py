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

Sharding: with a mesh every tensor is a DTensor of global shape, and
`Sharder.c` redistributes it to a partition spec, as the reference's
with_sharding_constraint tells XLA how to partition (TP on heads when
divisible, else context-parallel on the query-sequence dim).  Regions that
act on each shard alone (the attention, the MoE dispatch, the caches' slot
writes) run on the local shards through `per_shard`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .param import PS, mesh_sizes, placements


# ---------------------------------------------------------------------- #
@dataclass
class Sharder:
    mesh: object | None            # a DeviceMesh, or None: one device
    dp: tuple | str | None         # data-parallel mesh axes, e.g. ('pod','data')
    tp_heads: bool                 # q-heads divisible by tp size
    tp_kv: bool

    def _ok(self, dim, axis):
        if axis is None:
            return None
        return axis if dim % self.size(axis) == 0 else None

    def spec(self, shape, *axes) -> PS:
        """PS(axes) for a tensor of `shape`, an axis dropped where it does
        not divide its dim or is already used by an earlier dim."""
        parts = [self._ok(d, a) for d, a in zip(shape, axes)]
        used = set()
        clean = []
        for a in parts:
            flat = a if isinstance(a, tuple) else (a,) if a else ()
            if any(f in used for f in flat):
                clean.append(None)
            else:
                clean.append(a)
                used.update(flat)
        return PS(*clean)

    def c(self, x, *axes):
        """x redistributed to PS(axes), dropping non-divisible axes (the
        reference's with_sharding_constraint); x itself with no mesh."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return x.redistribute(self.mesh, placements(
            self.spec(x.shape, *axes), self.mesh))

    def coord(self, axis: str) -> int:
        """This rank's coordinate along a mesh axis (0 with no mesh)."""
        if self.mesh is None:
            return 0
        return self.mesh.get_local_rank(axis)

    def size(self, axis) -> int:
        """Devices along a mesh axis or tuple of axes (1 with no mesh)."""
        if self.mesh is None or axis is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            n *= sizes[a]
        return n


NO_SHARD = Sharder(mesh=None, dp=(), tp_heads=False, tp_kv=False)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def per_shard(fn, out_placements, *args):
    """fn over the local shards of its DTensor arguments (other arguments
    pass as they are); its tensor outputs become DTensors with
    `out_placements` (one placement list per output, or one list for a
    single output).  With no DTensor argument, fn(*args).

    The gradient of an input that is replicated along a mesh dim on which
    some output is not (each rank along it used the input for a part of
    the work) is a partial sum there: it is declared Partial, and the
    upstream reduction adds the parts."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    single = not isinstance(out_placements[0], (list, tuple))
    outs_pl = [out_placements] if single else list(out_placements)
    split = [any(not isinstance(o[i], Replicate) for o in outs_pl)
             for i in range(mesh.ndim)]
    local = []
    for a in args:
        if isinstance(a, DTensor):
            grad_pl = [Partial() if isinstance(p, Replicate) and split[i]
                       else p for i, p in enumerate(a.placements)]
            a = a.to_local(grad_placements=grad_pl)
        local.append(a)
    out = fn(*local)
    outs = [out] if single else list(out)
    wrapped = [DTensor.from_local(o, mesh, pl, run_check=False)
               for o, pl in zip(outs, outs_pl)]
    return wrapped[0] if single else tuple(wrapped)


@functools.cache
def _register_dtensor_mm():
    """Sharding rules for torch.mm / torch.bmm with out_dtype (which
    DTensor has none for): those of mm and bmm.  Once a process."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    r, p = Replicate(), Partial()

    @register_sharding(aten.mm.dtype)
    def _mm(a, b, out_dtype):
        return [([r], [r, r, None]), ([Shard(0)], [Shard(0), r, None]),
                ([Shard(1)], [r, Shard(1), None]),
                ([p], [Shard(1), Shard(0), None])]

    @register_sharding(aten.bmm.dtype)
    def _bmm(a, b, out_dtype):
        return [([r], [r, r, None]),
                ([Shard(0)], [Shard(0), Shard(0), None]),
                ([Shard(1)], [Shard(1), r, None]),
                ([Shard(2)], [r, Shard(2), None]),
                ([p], [Shard(2), Shard(1), None])]


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
    operands are widened, which is exact for bf16.  Meta tensors (the
    dry-run's) take the card's way."""
    if (a.is_cuda or a.is_meta) and a.dtype in (torch.bfloat16,
                                                torch.float16):
        if is_dtensor(a):
            _register_dtensor_mm()
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
                    kv_chunk=1024, softmax_scale=None, q_offset: int = 0):
    """q [B, Hq, Sq, hd]; k, v [B, Hkv, Skv, hd] -> [B, Hq, Sq, hd].

    GQA via head grouping; online softmax over KV chunks.  The causal
    rectangle is masked, not skipped, as in the reference.  q_offset: the
    absolute position of q's first row (a context-parallel shard's).
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
    qpos = torch.arange(sq, device=dev) + q_offset

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
def _vocab_gold(logits, labels, lo: int):
    """The logits of the gold labels within this shard's vocab slice
    [lo, lo + V_local), 0 where a label lies outside it."""
    v = logits.shape[-1]
    idx = labels - lo
    inside = (idx >= 0) & (idx < v)
    gold = torch.gather(logits, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
    return torch.where(inside, gold, 0.0)


def _sharded_lse_gold(logits, labels, shd: Sharder):
    """logsumexp and gold logit of vocab-sharded logits [B, c, V]: the
    max and the sum of exponentials reduced over the shards, the gold
    logit taken on the shard that holds it (a partial sum over 'model')."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    # the max, the sum and the gold logit reduced over 'model' at once, as
    # in the reference's layout: DTensor would otherwise scatter them over
    # the sequence and gather the [B, c, V] cotangent in the backward pass
    m = shd.c(logits.detach().amax(-1, keepdim=True), shd.dp, None, None)
    lse = torch.log(shd.c(torch.exp(logits - m).sum(-1), shd.dp, None)) \
        + m[..., 0]
    vocab_sharded = [p == Shard(2) for p in logits.placements]
    lab_pl = [p if p == Shard(0) else Replicate()
              for p in logits.placements]
    if not is_dtensor(labels):
        labels = shd.c(labels)
    labels = labels.redistribute(logits.device_mesh, lab_pl)
    lo = shd.coord("model") * (logits.shape[-1] // shd.size("model")) \
        if any(vocab_sharded) else 0
    out_pl = [Partial() if vs else p
              for vs, p in zip(vocab_sharded, lab_pl)]
    gold = per_shard(lambda lg, lb: _vocab_gold(lg, lb, lo), out_pl,
                     logits, labels)
    return lse, shd.c(gold, shd.dp, None)


def _ce_chunk(x, embed, labels, mask, shd: Sharder = NO_SHARD):
    """Summed NLL and mask count of one chunk: x [B, c, D], embed [V, D],
    labels [B, c] int64, mask [B, c] float32.  With a mesh the chunk's
    logits are vocab-sharded (the reference's constraint)."""
    b, c, d = x.shape
    # the vocab-sharded product's cotangent of x is a partial sum over
    # 'model': reduce it here, as the reference's layout does, and not in
    # the trunk's row-parallel products
    x = shd.c(x, shd.dp, None, None)
    logits = matmul_f32(x.reshape(b * c, d), embed.t()).view(b, c, -1)
    if shd.mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        logits = shd.c(logits, shd.dp, None, "model")
        lse, gold = _sharded_lse_gold(logits, labels, shd)
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def chunked_cross_entropy(x, embed, labels, *, chunk=512,
                          shd: Sharder = NO_SHARD, mask=None):
    """Next-token CE without materializing [B, S, V] logits.

    x [B, S, D]; embed [V, D]; labels [B, S] int; mask [B, S] optional.
    Walks sequence chunks; where autograd records, each chunk is
    checkpointed, so its [B, chunk, V] fp32 logits are recomputed in the
    backward pass and never kept (the reference: jax.checkpoint on the
    scan body).  Each chunk's logits are vocab-sharded under a mesh.
    Returns sum(nll·mask) / max(sum(mask), 1).
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

    def step(xb, emb, lb, mb):
        return _ce_chunk(xb, emb, lb, mb, shd)
    for lo in range(0, s, chunk):
        args = (x[:, lo:lo + chunk], embed, labels[:, lo:lo + chunk],
                mask[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            nll, n = checkpoint(step, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, n = step(*args)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
