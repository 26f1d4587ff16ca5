"""Composable model assembly for every architecture family.

One "block" covers `moe_every` layers (so interleaved-MoE models stay
uniform); block params are stacked on a leading 'layers' dim, as in the
reference, and the trunk is a Python loop over the stacked blocks, with
optional per-block remat (torch.utils.checkpoint).

Entry points (all plain functions of (cfg, params, ...)):
  loss_fn       train loss (chunked CE / masked CE for encoders)
  prefill       full-sequence forward producing decode caches + last logits
  decode_step   one token with cache/state (the serve step of decode shapes)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .param import PD
from .nn_ops import (matmul_f32, rms_norm, rotary, ffn, flash_attention,
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
def _qkv(cfg, p, x):
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    q = hin @ p["wq"]
    k = hin @ p["wk"]
    v = hin @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _attention_seq(cfg, p, x, *, make_cache=False, cache_len=0):
    """Full-sequence attention sublayer.  Returns (y, cache | None)."""
    b, s, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _qkv(cfg, p, x)
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, kv, hd).transpose(1, 2)
    v = v.reshape(b, s, kv, hd).transpose(1, 2)
    pos = torch.arange(s, device=x.device)
    q = rotary(q, pos[None, None], cfg.rope_theta)
    k = rotary(k, pos[None, None], cfg.rope_theta)
    y = flash_attention(
        q, k, v, causal=cfg.causal,
        window=cfg.window if cfg.attn_type == "sliding" else 0,
        n_meta=cfg.num_meta_tokens)
    y = y.transpose(1, 2).reshape(b, s, h * hd)
    out = y @ p["wo"]
    cache = None
    if make_cache:
        cl = cache_len or s
        ck = torch.zeros((b, kv, cl, hd), dtype=k.dtype, device=x.device)
        cv = torch.zeros((b, kv, cl, hd), dtype=v.dtype, device=x.device)
        if cfg.attn_type == "sliding":
            # meta region + ring region, entries placed at their decode
            # write-slots so prefill and decode_step stay consistent
            n_meta = cfg.num_meta_tokens
            w = cl - n_meta
            take = min(s - n_meta, w)
            ck[:, :, :n_meta] = k[:, :, :n_meta]
            cv[:, :, :n_meta] = v[:, :, :n_meta]
            p_arr = torch.arange(s - take, s, device=x.device)
            slots = n_meta + (p_arr - n_meta) % w
            ck[:, :, slots] = k[:, :, p_arr]
            cv[:, :, slots] = v[:, :, p_arr]
        else:
            take = min(s, cl)
            ck[:, :, :take] = k[:, :, s - take:]
            cv[:, :, :take] = v[:, :, s - take:]
        cache = {"k": ck, "v": cv}
    return out, cache


def _ffn_seq(cfg, p, x):
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    return ffn(hin, p["w1"], p["w2"], p.get("w3"))


def block_forward(cfg, bp, x, *, make_cache=False, cache_len=0):
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
            cfg, bp["tm"], rms_norm(x, bp["tm_norm"], cfg.norm_eps), s0)
        x = x + y
        y, prev_cm = rwkv_mod.channel_mix(
            cfg, bp["cm"], rms_norm(x, bp["cm_norm"], cfg.norm_eps),
            torch.zeros((b, d), dtype=x.dtype, device=x.device))
        x = x + y
        if make_cache:
            cache = {"S": s_fin, "prev_tm": prev_tm, "prev_cm": prev_cm}
    elif fam == "hybrid":
        y_attn, c = _attention_seq(cfg, bp["attn"], x,
                                   make_cache=make_cache, cache_len=cache_len)
        hin = rms_norm(x, bp["ssm_norm"], cfg.norm_eps)
        b = x.shape[0]
        h0 = torch.zeros((b, cfg.ssm_heads, cfg.d_model // cfg.ssm_heads,
                          cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
        y_ssm, h_fin = ssm_mod.ssm_scan(cfg, bp["ssm"], hin, h0)
        x = x + y_attn + y_ssm
        x = x + _ffn_seq(cfg, bp["mlp"], x)
        if make_cache:
            cache = {**(c or {}), "h": h_fin}
    elif fam == "moe":
        for i in range(cfg.moe_every):
            y, c = _attention_seq(cfg, bp[f"attn{i}"], x,
                                  make_cache=make_cache, cache_len=cache_len)
            x = x + y
            if make_cache:
                cache[f"k{i}"] = c["k"]
                cache[f"v{i}"] = c["v"]
            if i == cfg.moe_every - 1:
                mp = bp[f"moe{i}"]
                hin = rms_norm(x, mp["norm"], cfg.norm_eps)
                y, m = moe_mod.moe_ffn(cfg, mp, hin)
                metrics.update(m)
                x = x + y
            else:
                x = x + _ffn_seq(cfg, bp[f"mlp{i}"], x)
    else:  # dense / vlm / encoder
        y, c = _attention_seq(cfg, bp["attn"], x,
                              make_cache=make_cache, cache_len=cache_len)
        x = x + y
        x = x + _ffn_seq(cfg, bp["mlp"], x)
        if make_cache:
            cache = c or {}
    return x, (cache, metrics)


# ====================================================================== #
# Trunk
# ====================================================================== #
def cfg_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def embed_inputs(cfg, params, batch):
    """Build x0 [B, prefix + S, D] from the batch dict (numpy arrays or
    tensors; moved to the parameters' device)."""
    dev = params["final_norm"].device
    dt = cfg_dtype(cfg)
    if cfg.frontend == "audio":
        x = torch.as_tensor(batch["frames"], device=dev).to(dt)
    else:
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        x = params["embed"][tokens].to(dt)
        if cfg.frontend == "vision":
            patches = torch.as_tensor(batch["patches"], device=dev)
            x = torch.cat([patches.to(x.dtype), x], dim=1)
    if cfg.num_meta_tokens:
        b = x.shape[0]
        meta = params["meta"][None].to(x.dtype).expand(
            b, cfg.num_meta_tokens, x.shape[-1])
        x = torch.cat([meta, x], dim=1)
    return x


def trunk(cfg, params, x, *, remat=True, make_cache=False, cache_len=0):
    """Loop over blocks.  Returns (x, caches stacked per block, metrics
    averaged over blocks).  With remat, where autograd records, each block
    is checkpointed: only its input is kept, and its activations are
    recomputed in the backward pass (the reference: jax.checkpoint on the
    scan body)."""
    def body(bp, x):
        return block_forward(cfg, bp, x, make_cache=make_cache,
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
def loss_fn(cfg, params, batch, *, remat=True):
    """Returns (loss, metrics): the chunked next-token CE over the text
    positions (a VLM's patches and the meta tokens cut off; an encoder's
    masked positions only, by batch["mask"]), plus 0.01·moe_aux."""
    x = embed_inputs(cfg, params, batch)
    x, _, metrics = trunk(cfg, params, x, remat=remat)
    pl = prefix_len(cfg)
    if pl:
        x = x[:, pl:]
    un = unembed_matrix(cfg, params).to(x.dtype)
    labels = torch.as_tensor(batch["labels"], device=x.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=x.device)
    ce = chunked_cross_entropy(x, un, labels, chunk=cfg.loss_chunk,
                               mask=mask)
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


def prefill(cfg, params, batch, *, cache_len: int = 0):
    """Full-sequence forward; returns (last_logits f32, cache_tree)."""
    x = embed_inputs(cfg, params, batch)
    dev = x.device
    s_total = x.shape[1]
    cache_len = cache_len or s_total
    x, caches, _ = trunk(cfg, params, x, remat=False, make_cache=True,
                         cache_len=cache_len)
    un = unembed_matrix(cfg, params).to(x.dtype)
    logits = matmul_f32(x[:, -1], un.t())
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
    cache = {"blocks": caches, "slot_pos": slot_pos,
             "pos": torch.tensor(s_total, dtype=torch.int32, device=dev)}
    return logits, cache


def _write_slot(cfg, pos, cache_len):
    """Slot to write position `pos` into (ring for sliding windows); a
    0-d tensor, computed on the device."""
    if cfg.attn_type == "sliding":
        n_meta = cfg.num_meta_tokens
        w = cache_len - n_meta
        return torch.where(pos < n_meta, pos, n_meta + (pos - n_meta) % w)
    return torch.clamp(pos, max=cache_len - 1)


def _attention_step(cfg, p, x, cache, slot_pos, pos, slot):
    """One token's attention.  Writes this token's k, v into `slot` of
    the block's cache views in place (index_copy_)."""
    b, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _qkv(cfg, p, x)
    q = q.reshape(b, h, hd)
    k = k.reshape(b, kv, hd)
    v = v.reshape(b, kv, hd)
    q = rotary(q, pos.expand(b, h), cfg.rope_theta)
    k = rotary(k, pos.expand(b, kv), cfg.rope_theta)
    idx = slot.reshape(1).long()
    ck = cache["k"].index_copy_(2, idx, k[:, :, None])
    cv = cache["v"].index_copy_(2, idx, v[:, :, None])
    y = decode_attention(
        q, ck, cv, slot_pos, pos,
        window=cfg.window if cfg.attn_type == "sliding" else 0,
        n_meta=cfg.num_meta_tokens)
    return y.reshape(b, h * hd) @ p["wo"]


def _ffn_step(cfg, p, x):
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    return ffn(hin, p["w1"], p["w2"], p.get("w3"))


def _block_step(cfg, bp, bc, x, slot_pos, pos, slot):
    """One block's decode step.  Attention caches are written in place;
    returns (x, the block's new recurrent states: S/prev_tm/prev_cm or
    h, empty for attention-only blocks)."""
    fam = cfg.family
    if fam == "rwkv6":
        st = (bc["S"], bc["prev_tm"])
        y, (s_new, prev_tm) = rwkv_mod.time_mix_step(
            cfg, bp["tm"], rms_norm(x, bp["tm_norm"], cfg.norm_eps), st)
        x = x + y
        y, prev_cm = rwkv_mod.channel_mix_step(
            cfg, bp["cm"], rms_norm(x, bp["cm_norm"], cfg.norm_eps),
            bc["prev_cm"])
        x = x + y
        return x, {"S": s_new, "prev_tm": prev_tm, "prev_cm": prev_cm}
    if fam == "hybrid":
        y_attn = _attention_step(cfg, bp["attn"], x, bc, slot_pos, pos,
                                 slot)
        hin = rms_norm(x, bp["ssm_norm"], cfg.norm_eps)
        y_ssm, h_new = ssm_mod.ssm_step(cfg, bp["ssm"], hin, bc["h"])
        x = x + y_attn + y_ssm
        x = x + _ffn_step(cfg, bp["mlp"], x)
        return x, {"h": h_new}
    if fam == "moe":
        for i in range(cfg.moe_every):
            x = x + _attention_step(cfg, bp[f"attn{i}"], x,
                                    {"k": bc[f"k{i}"], "v": bc[f"v{i}"]},
                                    slot_pos, pos, slot)
            if i == cfg.moe_every - 1:
                mp = bp[f"moe{i}"]
                hin = rms_norm(x, mp["norm"], cfg.norm_eps)
                y, _ = moe_mod.moe_ffn(cfg, mp, hin[:, None])
                x = x + y[:, 0]
            else:
                x = x + _ffn_step(cfg, bp[f"mlp{i}"], x)
        return x, {}
    x = x + _attention_step(cfg, bp["attn"], x, bc, slot_pos, pos, slot)
    x = x + _ffn_step(cfg, bp["mlp"], x)
    return x, {}


def decode_step(cfg, params, cache, tokens):
    """One decode step.  tokens [B] int.  Returns (logits f32, new cache).

    Attention caches are written in place: the returned cache holds the
    same k/v tensors as `cache`, with this step's slot filled.  `pos` and
    the write slot stay on the device, so a step never waits for the
    host."""
    pos = cache["pos"]
    dev = pos.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = params["embed"][tokens].to(cfg_dtype(cfg))

    cache_len = 0
    if cfg.family != "rwkv6":
        cache_len = _first_attn_len(cache["blocks"])
    slot = _write_slot(cfg, pos, cache_len) if cache_len else \
        torch.zeros((), dtype=torch.int32, device=dev)
    slot_pos = cache["slot_pos"]
    if cache_len:
        slot_pos = slot_pos.index_copy(0, slot.reshape(1).long(),
                                       pos.reshape(1))

    states = []
    nb = n_blocks(cfg)
    for bp, bc in zip(unstack(params["blocks"], nb),
                      unstack(cache["blocks"], nb)):
        x, st = _block_step(cfg, bp, bc, x, slot_pos, pos, slot)
        states.append(st)
    blocks = dict(cache["blocks"])
    if states[0]:
        blocks.update(_stack(states))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    un = unembed_matrix(cfg, params).to(x.dtype)
    logits = matmul_f32(x, un.t())
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
