"""Architecture registry: --arch <id> resolves here."""
from .base import (ModelConfig, InputShape, TrainConfig, ALL_SHAPES,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
                   supported_shapes)

from . import (rwkv6_7b, granite_moe_1b_a400m, llama4_maverick_400b_a17b,
               stablelm_1_6b, starcoder2_15b, minitron_8b, qwen2_0_5b,
               paligemma_3b, hubert_xlarge, hymba_1_5b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (rwkv6_7b, granite_moe_1b_a400m, llama4_maverick_400b_a17b,
              stablelm_1_6b, starcoder2_15b, minitron_8b, qwen2_0_5b,
              paligemma_3b, hubert_xlarge, hymba_1_5b)
}

SHAPES: dict[str, InputShape] = {s.name: s for s in ALL_SHAPES}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    import dataclasses
    small = dict(
        num_layers=2,
        d_model=max(64, cfg.hd),
        num_heads=max(2, min(4, cfg.num_heads)),
        num_kv_heads=max(1, min(2, cfg.num_kv_heads)),
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        d_ff_expert=64 if cfg.num_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        window=min(cfg.window, 16) if cfg.window else 0,
        num_meta_tokens=min(cfg.num_meta_tokens, 4),
        num_prefix_tokens=min(cfg.num_prefix_tokens, 4),
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        rwkv_chunk=8,
        loss_chunk=16,
        dtype="float32", param_dtype="float32",
    )
    small["d_model"] = small["num_heads"] * small["head_dim"]
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
