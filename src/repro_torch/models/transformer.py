"""Composable model assembly for every architecture family.

One "block" covers `moe_every` layers (so interleaved-MoE models stay
uniform); block params are stacked on a leading 'layers' dim, as in the
reference, and the trunk is a Python loop over the stacked blocks, with
optional per-block remat (torch.utils.checkpoint).

With a mesh (a Sharder `shd` with one), parameters, batch and caches are
DTensors and `shd.c` constrains the activations where the reference
does: the embedded inputs, q/k/v (heads over 'model' where they divide,
else the query sequence: context parallel), the prefill caches, the
logits.  The attention and the caches' writes run on each rank's shards
(nn_ops.per_shard).

Entry points (all plain functions of (cfg, params, ...)):
  loss_fn       train loss (chunked CE / masked CE for encoders)
  prefill       full-sequence forward producing decode caches + last logits
  decode_step   one token with cache/state (the serve step of decode shapes)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .param import PD
from .nn_ops import (Sharder, NO_SHARD, per_shard, is_dtensor, matmul_f32,
                     rms_norm, rotary, ffn, flash_attention,
                     decode_attention, chunked_cross_entropy)
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from . import ssm as ssm_mod


# ====================================================================== #
# Parameter definitions
# ====================================================================== #
def n_blocks(cfg) -> int:
    if cfg.family == "moe":
        assert cfg.num_layers % cfg.moe_every == 0
        return cfg.num_layers // cfg.moe_every
    return cfg.num_layers


def layers_per_block(cfg) -> int:
    return cfg.moe_every if cfg.family == "moe" else 1


def _attn_defs(cfg, lead):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    la = ("layers",) if lead else ()
    def m(shape, axes, **kw):
        return PD(lead + shape, la + axes, **kw)
    defs = {
        "norm": m((d,), ("embed",), init="ones"),
        "wq": m((d, h * hd), ("embed", "heads")),
        "wk": m((d, kv * hd), ("embed", "kv")),
        "wv": m((d, kv * hd), ("embed", "kv")),
        "wo": m((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = m((h * hd,), ("heads",), init="zeros")
        defs["bk"] = m((kv * hd,), ("kv",), init="zeros")
        defs["bv"] = m((kv * hd,), ("kv",), init="zeros")
    return defs


def _ffn_defs(cfg, lead):
    d, f = cfg.d_model, cfg.d_ff
    la = ("layers",) if lead else ()
    def m(shape, axes, **kw):
        return PD(lead + shape, la + axes, **kw)
    defs = {
        "norm": m((d,), ("embed",), init="ones"),
        "w1": m((d, f), ("embed", "ff")),
        "w2": m((f, d), ("ff", "embed")),
    }
    if cfg.gated_ffn:
        defs["w3"] = m((d, f), ("embed", "ff"))
    return defs


def block_defs(cfg):
    nb = n_blocks(cfg)
    lead = (nb,)
    fam = cfg.family
    if fam == "rwkv6":
        return {
            "tm": rwkv_mod.time_mix_defs(cfg, lead),
            "tm_norm": PD(lead + (cfg.d_model,), ("layers", "embed"),
                          init="ones"),
            "cm": rwkv_mod.channel_mix_defs(cfg, lead),
            "cm_norm": PD(lead + (cfg.d_model,), ("layers", "embed"),
                          init="ones"),
        }
    if fam == "hybrid":
        return {
            "attn": _attn_defs(cfg, lead),
            "ssm": ssm_mod.ssm_defs(cfg, lead),
            "ssm_norm": PD(lead + (cfg.d_model,), ("layers", "embed"),
                           init="ones"),
            "mlp": _ffn_defs(cfg, lead),
        }
    if fam == "moe":
        out = {}
        for i in range(cfg.moe_every):
            out[f"attn{i}"] = _attn_defs(cfg, lead)
            if i == cfg.moe_every - 1:
                out[f"moe{i}"] = moe_mod.moe_param_defs(cfg, nb)
                out[f"moe{i}"]["norm"] = PD(
                    lead + (cfg.d_model,), ("layers", "embed"), init="ones")
            else:
                out[f"mlp{i}"] = _ffn_defs(cfg, lead)
        return out
    # dense / vlm / encoder
    return {"attn": _attn_defs(cfg, lead), "mlp": _ffn_defs(cfg, lead)}


def model_defs(cfg):
    d, v = cfg.d_model, cfg.vocab_size
    defs = {
        "blocks": block_defs(cfg),
        "final_norm": PD((d,), ("embed",), init="ones"),
    }
    if cfg.frontend != "audio":
        defs["embed"] = PD((v, d), ("vocab", "embed"))
    if not cfg.tie_embeddings or cfg.frontend == "audio":
        defs["unembed"] = PD((v, d), ("vocab", "embed"))
    if cfg.num_meta_tokens:
        defs["meta"] = PD((cfg.num_meta_tokens, d), (None, "embed"))
    return defs


def unembed_matrix(cfg, params):
    return params.get("unembed", params.get("embed"))


def prefix_len(cfg) -> int:
    return cfg.num_prefix_tokens + cfg.num_meta_tokens


def unstack(tree, n: int) -> list:
    """The n blocks of a tree whose leaves are stacked on a leading dim,
    as views: one torch.unbind per leaf, whose backward is one stack.
    (Indexing block i of every leaf would give each block's backward a
    zero-filled gradient of the whole stacked leaf.)"""
    leaves = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
              for k, v in tree.items()}
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def _stack(trees: list):
    """Per-block trees -> one tree with leaves stacked on a leading dim."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


# ====================================================================== #
# Block forward (full sequence: prefill)
# ====================================================================== #
def _rows_matmul(x, w, shd: Sharder):
    """x @ w over each rank's rows of x (a DTensor, its rows sharded in
    any way; a shard of its last dim is gathered), w gathered whole: a
    product over sequence-sharded rows, which DTensor cannot flatten
    into one row dim without gathering them."""
    from torch.distributed.tensor import Replicate, Shard
    x = x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(x.ndim - 1) else p for p in x.placements])
    w = shd.c(w, *([None] * w.ndim))
    return per_shard(lambda a, b: a @ b, x.placements, x, w)


def _qkv(cfg, p, x, shd: Sharder = NO_SHARD, seq=None):
    """q, k, v projections [..., H*hd] / [..., KV*hd]; under a mesh their
    head dims are sharded over 'model' only where the heads divide it
    (so that splitting the heads off never splits a head), and a
    sequence dim over `seq`."""
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    if seq is None:
        hin = shd.c(hin, shd.dp, None, None)
        q, k, v = hin @ p["wq"], hin @ p["wk"], hin @ p["wv"]
    else:
        q, k, v = (_rows_matmul(hin, p[w], shd) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if shd.mesh is not None:
        lead = (shd.dp,) + (seq,) * (q.ndim - 2)
        q = shd.c(q, *lead, "model" if shd.tp_heads else None)
        k = shd.c(k, *lead, "model" if shd.tp_kv else None)
        v = shd.c(v, *lead, "model" if shd.tp_kv else None)
    return q, k, v


def _local_kv(q, k, v, g: int, h0: int):
    """The kv heads a shard of q heads [h0, h0 + Hq_l) reads, laid out so
    that flash_attention's grouping (local q head i -> kv head
    i // (Hq_l / Hkv_l)) maps every q head to its kv head (h // g)."""
    hq_l, hkv_l = q.shape[1], k.shape[1]
    if hkv_l * g == hq_l:                # kv heads sharded like q, or whole
        return k, v
    lo, hi = h0 // g, (h0 + hq_l - 1) // g + 1
    if hq_l % g == 0 or g % hq_l == 0:   # whole groups, or one group
        return k[:, lo:hi], v[:, lo:hi]
    idx = (h0 + torch.arange(hq_l, device=k.device)) // g
    return k[:, idx], v[:, idx]


def _fill_cache(cfg, k, cl: int):
    """A decode cache of length cl holding k [B, kv, s, hd]: the last cl
    positions, or with a sliding window the meta region and the ring,
    entries placed at their decode write-slots so prefill and decode_step
    stay consistent."""
    b, kv, s, hd = k.shape
    ck = torch.zeros((b, kv, cl, hd), dtype=k.dtype, device=k.device)
    if cfg.attn_type == "sliding":
        n_meta = cfg.num_meta_tokens
        w = cl - n_meta
        take = min(s - n_meta, w)
        ck[:, :, :n_meta] = k[:, :, :n_meta]
        p_arr = torch.arange(s - take, s, device=k.device)
        slots = n_meta + (p_arr - n_meta) % w
        ck[:, :, slots] = k[:, :, p_arr]
    else:
        take = min(s, cl)
        ck[:, :, :take] = k[:, :, s - take:]
    return ck


def _attention_seq(cfg, p, x, shd: Sharder = NO_SHARD, *, make_cache=False,
                   cache_len=0):
    """Full-sequence attention sublayer.  Returns (y, cache | None)."""
    b, s, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    # context parallel: each rank projects only its query rows; k and v
    # are gathered over the sequence below
    cp = shd.mesh is not None and not shd.tp_heads
    if cp:
        x = shd.c(x, shd.dp, "model", None)
    q, k, v = _qkv(cfg, p, x, shd, seq="model" if cp else None)
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, kv, hd).transpose(1, 2)
    v = v.reshape(b, s, kv, hd).transpose(1, 2)
    pos = torch.arange(s, device=x.device)
    q = rotary(q, pos[None, None], cfg.rope_theta)
    k = rotary(k, pos[None, None], cfg.rope_theta)
    if shd.tp_heads:
        q_axes = (shd.dp, "model", None, None)
        kv_axes = (shd.dp, "model" if shd.tp_kv else None, None, None)
    else:   # context parallel: shard query sequence, replicate KV
        q_axes = (shd.dp, None, "model", None)
        kv_axes = (shd.dp, None, None, None)
    q, k, v = shd.c(q, *q_axes), shd.c(k, *kv_axes), shd.c(v, *kv_axes)
    q_spec = shd.spec(q.shape, *q_axes) if shd.mesh is not None else ()
    heads_sharded = len(q_spec) > 1 and q_spec[1] == "model"
    seq_sharded = len(q_spec) > 2 and q_spec[2] == "model"

    def attend(ql, kl, vl):
        h0 = shd.coord("model") * ql.shape[1] if heads_sharded else 0
        kl, vl = _local_kv(ql, kl, vl, h // kv, h0)
        return flash_attention(
            ql, kl, vl, causal=cfg.causal,
            window=cfg.window if cfg.attn_type == "sliding" else 0,
            n_meta=cfg.num_meta_tokens,
            q_offset=shd.coord("model") * ql.shape[2] if seq_sharded else 0)
    y = per_shard(attend, getattr(q, "placements", None), q, k, v)
    y = y.transpose(1, 2).reshape(b, s, h * hd)
    if seq_sharded:     # each rank's query rows through the whole wo
        out = _rows_matmul(y, p["wo"], shd)
    else:
        out = y @ p["wo"]
    out = shd.c(out, shd.dp, None, None)
    cache = None
    if make_cache:
        cl = cache_len or s
        pl = getattr(k, "placements", None)
        ck = per_shard(lambda t: _fill_cache(cfg, t, cl), pl, k)
        cv = per_shard(lambda t: _fill_cache(cfg, t, cl), pl, v)
        cache = {"k": shd.c(ck, shd.dp, None, "model", None),
                 "v": shd.c(cv, shd.dp, None, "model", None)}
    return out, cache


def _ffn_seq(cfg, p, x, shd: Sharder = NO_SHARD):
    """The FFN sublayer; under a mesh its output is reduced over 'model'
    (the residual stream stays data-sharded and whole)."""
    hin = shd.c(rms_norm(x, p["norm"], cfg.norm_eps), shd.dp, None, None)
    return shd.c(ffn(hin, p["w1"], p["w2"], p.get("w3")), shd.dp, None, None)


def block_forward(cfg, bp, x, shd: Sharder = NO_SHARD, *, make_cache=False,
                  cache_len=0):
    """One block over the full sequence.

    Returns (x, (cache, metrics))."""
    fam = cfg.family
    metrics = {}
    cache = {}
    if fam == "rwkv6":
        b = x.shape[0]
        hd, d = cfg.rwkv_head_dim, cfg.d_model
        h = rwkv_mod.rwkv_heads(cfg)
        s0 = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=x.device),
              torch.zeros((b, d), dtype=x.dtype, device=x.device))
        y, (s_fin, prev_tm) = rwkv_mod.time_mix_chunked(
            cfg, bp["tm"], rms_norm(x, bp["tm_norm"], cfg.norm_eps), s0,
            shd=shd)
        x = x + y
        y, prev_cm = rwkv_mod.channel_mix(
            cfg, bp["cm"], rms_norm(x, bp["cm_norm"], cfg.norm_eps),
            torch.zeros((b, d), dtype=x.dtype, device=x.device))
        x = x + y
        if make_cache:
            cache = {"S": s_fin, "prev_tm": prev_tm, "prev_cm": prev_cm}
    elif fam == "hybrid":
        y_attn, c = _attention_seq(cfg, bp["attn"], x, shd,
                                   make_cache=make_cache, cache_len=cache_len)
        hin = rms_norm(x, bp["ssm_norm"], cfg.norm_eps)
        b = x.shape[0]
        h0 = torch.zeros((b, cfg.ssm_heads, cfg.d_model // cfg.ssm_heads,
                          cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
        y_ssm, h_fin = ssm_mod.ssm_scan(cfg, bp["ssm"], hin, h0)
        x = x + y_attn + y_ssm
        x = x + _ffn_seq(cfg, bp["mlp"], x, shd)
        if make_cache:
            cache = {**(c or {}), "h": h_fin}
    elif fam == "moe":
        for i in range(cfg.moe_every):
            y, c = _attention_seq(cfg, bp[f"attn{i}"], x, shd,
                                  make_cache=make_cache, cache_len=cache_len)
            x = x + y
            if make_cache:
                cache[f"k{i}"] = c["k"]
                cache[f"v{i}"] = c["v"]
            if i == cfg.moe_every - 1:
                mp = bp[f"moe{i}"]
                hin = rms_norm(x, mp["norm"], cfg.norm_eps)
                y, m = moe_mod.moe_ffn(cfg, mp, hin, shd)
                metrics.update(m)
                x = x + y
            else:
                x = x + _ffn_seq(cfg, bp[f"mlp{i}"], x, shd)
    else:  # dense / vlm / encoder
        y, c = _attention_seq(cfg, bp["attn"], x, shd,
                              make_cache=make_cache, cache_len=cache_len)
        x = x + y
        x = x + _ffn_seq(cfg, bp["mlp"], x, shd)
        if make_cache:
            cache = c or {}
    return x, (cache, metrics)


# ====================================================================== #
# Trunk
# ====================================================================== #
def cfg_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def as_input(x, device):
    """A batch entry as a tensor on `device` (a DTensor stays as it is)."""
    return x if is_dtensor(x) else torch.as_tensor(x, device=device)


def lookup(table, tokens, shd: Sharder = NO_SHARD):
    """Rows of `table` [V, D] at `tokens`.  Under a mesh the table keeps
    only its vocab sharding (a ZeRO-3 shard of D is gathered) and each
    rank looks up the tokens of its vocab slice: the rows are a partial
    sum over 'model', reduced where they are used."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    table = table.redistribute(table.device_mesh, [
        p if p == Shard(0) else Replicate() for p in table.placements])
    tokens = shd.c(tokens, *([shd.dp] + [None] * (tokens.ndim - 1)))
    vocab = any(p == Shard(0) for p in table.placements)
    out_pl = [Partial() if tp == Shard(0) else xp
              for tp, xp in zip(table.placements, tokens.placements)]
    lo = shd.coord("model") * (table.shape[0] // shd.size("model")) \
        if vocab else 0

    def rows(tl, xl):
        idx = xl - lo
        inside = (idx >= 0) & (idx < tl.shape[0])
        return tl[idx.clamp(0, tl.shape[0] - 1)] * inside[..., None]
    return per_shard(rows, out_pl, table, tokens)


def embed_inputs(cfg, params, batch, shd: Sharder = NO_SHARD):
    """Build x0 [B, prefix + S, D] from the batch dict (numpy arrays or
    tensors; moved to the parameters' device)."""
    dev = params["final_norm"].device
    dt = cfg_dtype(cfg)
    if cfg.frontend == "audio":
        x = as_input(batch["frames"], dev).to(dt)
    else:
        tokens = as_input(batch["tokens"], dev).long()
        x = lookup(params["embed"], tokens, shd).to(dt)
        if cfg.frontend == "vision":
            patches = as_input(batch["patches"], dev)
            x = torch.cat([patches.to(x.dtype), x], dim=1)
    if cfg.num_meta_tokens:
        b = x.shape[0]
        meta = params["meta"][None].to(x.dtype).expand(
            b, cfg.num_meta_tokens, x.shape[-1])
        x = torch.cat([meta, x], dim=1)
    return shd.c(x, shd.dp, None, None)


def trunk(cfg, params, x, shd: Sharder = NO_SHARD, *, remat=True,
          make_cache=False, cache_len=0):
    """Loop over blocks.  Returns (x, caches stacked per block, metrics
    averaged over blocks).  With remat, where autograd records, each block
    is checkpointed: only its input is kept, and its activations are
    recomputed in the backward pass (the reference: jax.checkpoint on the
    scan body)."""
    def body(bp, x):
        return block_forward(cfg, bp, x, shd, make_cache=make_cache,
                             cache_len=cache_len)
    remat = remat and torch.is_grad_enabled()
    caches, metrics = [], []
    for bp in unstack(params["blocks"], n_blocks(cfg)):
        if remat:
            x, (cache, m) = checkpoint(body, bp, x, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            x, (cache, m) = body(bp, x)
        caches.append(cache)
        metrics.append(m)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = _stack(caches) if caches[0] else {}
    metrics = ({k: torch.stack([m[k] for m in metrics]).mean()
                for k in metrics[0]} if metrics[0] else {})
    return x, caches, metrics


# ====================================================================== #
# Losses
# ====================================================================== #
def loss_fn(cfg, params, batch, shd: Sharder = NO_SHARD, *, remat=True):
    """Returns (loss, metrics): the chunked next-token CE over the text
    positions (a VLM's patches and the meta tokens cut off; an encoder's
    masked positions only, by batch["mask"]), plus 0.01·moe_aux."""
    x = embed_inputs(cfg, params, batch, shd)
    x, _, metrics = trunk(cfg, params, x, shd, remat=remat)
    pl = prefix_len(cfg)
    if pl:
        x = x[:, pl:]
    un = unembed_matrix(cfg, params).to(x.dtype)
    labels = as_input(batch["labels"], x.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = as_input(mask, x.device)
    ce = chunked_cross_entropy(x, un, labels, chunk=cfg.loss_chunk,
                               shd=shd, mask=mask)
    loss = ce
    if "moe_aux" in metrics:
        loss = loss + 0.01 * metrics["moe_aux"]
    return loss, {"ce": ce, **metrics}


# ====================================================================== #
# Prefill & decode
# ====================================================================== #
def init_slot_positions(cfg, cache_len: int, filled: int, device):
    pos = torch.arange(cache_len, device=device)
    return torch.where(pos < filled, pos, -1).to(torch.int32)


def prefill(cfg, params, batch, shd: Sharder = NO_SHARD, *,
            cache_len: int = 0):
    """Full-sequence forward; returns (last_logits f32, cache_tree)."""
    x = embed_inputs(cfg, params, batch, shd)
    dev = x.device
    s_total = x.shape[1]
    cache_len = cache_len or s_total
    x, caches, _ = trunk(cfg, params, x, shd, remat=False, make_cache=True,
                         cache_len=cache_len)
    un = unembed_matrix(cfg, params).to(x.dtype)
    logits = shd.c(matmul_f32(x[:, -1], un.t()), shd.dp, "model")
    if cfg.family in ("rwkv6",):
        slot_pos = torch.zeros((0,), dtype=torch.int32, device=dev)
    elif cfg.attn_type == "sliding":
        n_meta = cfg.num_meta_tokens
        w = cache_len - n_meta
        take = min(s_total - n_meta, w)
        slot_pos = torch.full((cache_len,), -1, dtype=torch.int32,
                              device=dev)
        slot_pos[:n_meta] = torch.arange(n_meta, dtype=torch.int32,
                                         device=dev)
        p_arr = torch.arange(s_total - take, s_total, dtype=torch.int32,
                             device=dev)
        slot_pos[n_meta + (p_arr.long() - n_meta) % w] = p_arr
    else:
        take = min(s_total, cache_len)
        slot_pos = init_slot_positions(cfg, cache_len, take, dev)
        slot_pos = torch.where(slot_pos >= 0,
                               slot_pos + (s_total - take), -1)
    pos = torch.tensor(s_total, dtype=torch.int32, device=dev)
    if shd.mesh is not None:
        slot_pos, pos = shd.c(slot_pos, "model"), shd.c(pos)
    cache = {"blocks": caches, "slot_pos": slot_pos, "pos": pos}
    return logits, cache


def _write_slot(cfg, pos, cache_len):
    """Slot to write position `pos` into (ring for sliding windows); a
    0-d tensor, computed on the device."""
    if cfg.attn_type == "sliding":
        n_meta = cfg.num_meta_tokens
        w = cache_len - n_meta
        return torch.where(pos < n_meta, pos, n_meta + (pos - n_meta) % w)
    return torch.clamp(pos, max=cache_len - 1)


def _write_sharded(shd: Sharder, c, new, slot):
    """Write new [B, kv, hd] into slot `slot` of the cache c [B, kv, C,
    hd] in place, on each rank's shard of the slots (the slot lies on one
    'model' shard; the others write back what they hold)."""
    from torch.distributed.tensor import Shard
    new = shd.c(new, shd.dp, None, None)
    seq_sharded = Shard(2) in c.placements          # slots over 'model'

    def write(cl, nl, sl):
        n = cl.shape[2]
        idx = sl.reshape(1).long() - (shd.coord("model") * n
                                      if seq_sharded else 0)
        inside = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        old = cl.index_select(2, idx)
        return cl.index_copy_(2, idx, torch.where(inside, nl[:, :, None],
                                                  old))
    return per_shard(write, c.placements, c, new, slot)


def _attention_step(cfg, p, x, cache, slot_pos, pos, slot,
                    shd: Sharder = NO_SHARD):
    """One token's attention.  Writes this token's k, v into `slot` of
    the block's cache views in place (index_copy_)."""
    b, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _qkv(cfg, p, x, shd)
    q = q.reshape(b, h, hd)
    k = k.reshape(b, kv, hd)
    v = v.reshape(b, kv, hd)
    q = rotary(q, pos.expand(b, h), cfg.rope_theta)
    k = rotary(k, pos.expand(b, kv), cfg.rope_theta)
    if shd.mesh is None:
        idx = slot.reshape(1).long()
        ck = cache["k"].index_copy_(2, idx, k[:, :, None])
        cv = cache["v"].index_copy_(2, idx, v[:, :, None])
    else:
        ck = _write_sharded(shd, cache["k"], k, slot)
        cv = _write_sharded(shd, cache["v"], v, slot)
        q = shd.c(q, shd.dp, None, None)
    y = decode_attention(
        q, ck, cv, slot_pos, pos,
        window=cfg.window if cfg.attn_type == "sliding" else 0,
        n_meta=cfg.num_meta_tokens)
    return shd.c(y.reshape(b, h * hd) @ p["wo"], shd.dp, None)


def _ffn_step(cfg, p, x, shd: Sharder = NO_SHARD):
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    return shd.c(ffn(hin, p["w1"], p["w2"], p.get("w3")), shd.dp, None)


def _block_step(cfg, bp, bc, x, slot_pos, pos, slot,
                shd: Sharder = NO_SHARD):
    """One block's decode step.  Attention caches are written in place;
    returns (x, the block's new recurrent states: S/prev_tm/prev_cm or
    h, empty for attention-only blocks)."""
    fam = cfg.family
    if fam == "rwkv6":
        st = (bc["S"], bc["prev_tm"])
        y, (s_new, prev_tm) = rwkv_mod.time_mix_step(
            cfg, bp["tm"], rms_norm(x, bp["tm_norm"], cfg.norm_eps), st,
            shd)
        x = x + y
        y, prev_cm = rwkv_mod.channel_mix_step(
            cfg, bp["cm"], rms_norm(x, bp["cm_norm"], cfg.norm_eps),
            bc["prev_cm"])
        x = x + y
        return x, {"S": s_new, "prev_tm": prev_tm, "prev_cm": prev_cm}
    if fam == "hybrid":
        y_attn = _attention_step(cfg, bp["attn"], x, bc, slot_pos, pos,
                                 slot, shd)
        hin = rms_norm(x, bp["ssm_norm"], cfg.norm_eps)
        y_ssm, h_new = ssm_mod.ssm_step(cfg, bp["ssm"], hin, bc["h"])
        x = x + y_attn + y_ssm
        x = x + _ffn_step(cfg, bp["mlp"], x, shd)
        return x, {"h": h_new}
    if fam == "moe":
        for i in range(cfg.moe_every):
            x = x + _attention_step(cfg, bp[f"attn{i}"], x,
                                    {"k": bc[f"k{i}"], "v": bc[f"v{i}"]},
                                    slot_pos, pos, slot, shd)
            if i == cfg.moe_every - 1:
                mp = bp[f"moe{i}"]
                hin = rms_norm(x, mp["norm"], cfg.norm_eps)
                y, _ = moe_mod.moe_ffn(cfg, mp, hin[:, None], shd)
                x = x + y[:, 0]
            else:
                x = x + _ffn_step(cfg, bp[f"mlp{i}"], x, shd)
        return x, {}
    x = x + _attention_step(cfg, bp["attn"], x, bc, slot_pos, pos, slot,
                            shd)
    x = x + _ffn_step(cfg, bp["mlp"], x, shd)
    return x, {}


def decode_step(cfg, params, cache, tokens, shd: Sharder = NO_SHARD):
    """One decode step.  tokens [B] int.  Returns (logits f32, new cache).

    Attention caches are written in place: the returned cache holds the
    same k/v tensors as `cache`, with this step's slot filled.  `pos` and
    the write slot stay on the device, so a step never waits for the
    host."""
    pos = cache["pos"]
    dev = pos.device
    tokens = as_input(tokens, dev).long()
    x = shd.c(lookup(params["embed"], tokens, shd).to(cfg_dtype(cfg)),
              shd.dp, None)

    cache_len = 0
    if cfg.family != "rwkv6":
        cache_len = _first_attn_len(cache["blocks"])
    slot = _write_slot(cfg, pos, cache_len) if cache_len else \
        torch.zeros((), dtype=torch.int32, device=dev)
    slot_pos = cache["slot_pos"]
    if cache_len and shd.mesh is None:
        slot_pos = slot_pos.index_copy(0, slot.reshape(1).long(),
                                       pos.reshape(1))
    elif cache_len:         # elementwise: keeps the slots' sharding
        slots = torch.arange(cache_len, device=dev)
        slot_pos = torch.where(slots == slot, pos, slot_pos)

    states = []
    nb = n_blocks(cfg)
    for bp, bc in zip(unstack(params["blocks"], nb),
                      unstack(cache["blocks"], nb)):
        x, st = _block_step(cfg, bp, bc, x, slot_pos, pos, slot, shd)
        states.append(st)
    blocks = dict(cache["blocks"])
    if states[0]:
        blocks.update(_stack(states))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    un = unembed_matrix(cfg, params).to(x.dtype)
    logits = shd.c(matmul_f32(x, un.t()), shd.dp, "model")
    new_cache = {"blocks": blocks, "slot_pos": slot_pos, "pos": pos + 1}
    return logits, new_cache


def _first_attn_len(blocks) -> int:
    """Static cache length from any k-cache leaf [nB, B, kv, C, hd]."""
    for key in ("k", "k0"):
        node = blocks.get(key) if isinstance(blocks, dict) else None
        if node is not None:
            return node.shape[3]
    # search nested
    for v in blocks.values():
        if isinstance(v, dict):
            r = _first_attn_len(v)
            if r:
                return r
    return 0


# ====================================================================== #
# Cache construction
# ====================================================================== #
def cache_defs(cfg, batch: int, cache_len: int):
    """PD tree describing a fully-populated decode cache."""
    nb = n_blocks(cfg)
    kv, hd = cfg.num_kv_heads, cfg.hd
    d = cfg.d_model

    def kv_pd():
        return PD((nb, batch, kv, cache_len, hd),
                  ("layers", "batch", None, "cache_seq", None))

    fam = cfg.family
    if fam == "rwkv6":
        rhd = cfg.rwkv_head_dim
        h = rwkv_mod.rwkv_heads(cfg)
        blocks = {
            "S": PD((nb, batch, h, rhd, rhd),
                    ("layers", "batch", "heads", None, None)),
            "prev_tm": PD((nb, batch, d), ("layers", "batch", "embed")),
            "prev_cm": PD((nb, batch, d), ("layers", "batch", "embed")),
        }
        slot = PD((0,), (None,))
    elif fam == "hybrid":
        hd_ssm = d // cfg.ssm_heads
        blocks = {
            "k": kv_pd(), "v": kv_pd(),
            "h": PD((nb, batch, cfg.ssm_heads, hd_ssm, cfg.ssm_state),
                    ("layers", "batch", None, None, None)),
        }
        slot = PD((cache_len,), ("cache_seq",))
    elif fam == "moe":
        blocks = {}
        for i in range(cfg.moe_every):
            blocks[f"k{i}"] = kv_pd()
            blocks[f"v{i}"] = kv_pd()
        slot = PD((cache_len,), ("cache_seq",))
    else:
        blocks = {"k": kv_pd(), "v": kv_pd()}
        slot = PD((cache_len,), ("cache_seq",))
    return {"blocks": blocks, "slot_pos": slot, "pos": PD((), ())}
