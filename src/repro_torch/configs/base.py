"""Model / run configuration system.

One ModelConfig describes any architecture in the assigned pool; family
selects the block type.  Everything is plain dataclasses — configs are
importable, diffable, and hashable for checkpoint metadata.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | rwkv6 | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # --- attention style -------------------------------------------------
    attn_type: str = "full"      # full | sliding
    window: int = 0              # sliding-window size
    num_meta_tokens: int = 0     # learned global prefix tokens (hymba)
    causal: bool = True          # False for encoder-only
    gated_ffn: bool = True       # SwiGLU (False: 2-matrix GELU FFN)

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1           # routed FFN every k-th layer (llama4: 2)
    d_ff_expert: int = 0         # 0 -> d_ff
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM / RWKV -------------------------------------------------------
    ssm_state: int = 0           # mamba state size (hymba)
    ssm_heads: int = 0           # parallel ssm heads (hymba); 0 = none
    rwkv_head_dim: int = 64

    # --- modality frontend stubs -------------------------------------------
    frontend: str | None = None  # None | vision | audio
    num_prefix_tokens: int = 0   # vision: patch tokens prepended

    # --- numerics / training ----------------------------------------------
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "float32"  # master param dtype
    rwkv_chunk: int = 32
    loss_chunk: int = 512         # chunked cross-entropy seq chunk

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_ff_e(self) -> int:
        return self.d_ff_expert or self.d_ff

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv6"

    @property
    def sub_quadratic(self) -> bool:
        """Can run 500k-token decode (state-based or windowed attention)."""
        return self.family in ("rwkv6",) or \
            (self.family == "hybrid" and self.attn_type == "sliding")

    @property
    def decoder(self) -> bool:
        return self.family != "encoder"

    def num_params(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs)."""
        d, ff, v, l = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, h, kv = self.hd, self.num_heads, self.num_kv_heads
        per_layer = 0
        if self.family == "rwkv6":
            per_layer = 6 * d * d + 2 * d * ff     # r,k,v,g,w,o + channel mix
        else:
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.family == "hybrid" and self.ssm_heads:
                attn += 2 * d * d + d * (2 * self.ssm_state + 1) * 2
            ffn = (3 if self.gated_ffn else 2) * d * ff
            per_layer = attn + ffn
        total = l * per_layer
        if self.num_experts:
            n_moe_layers = l // self.moe_every
            expert = 3 * d * self.d_ff_e
            total += n_moe_layers * (self.num_experts - 1) * expert
            total += n_moe_layers * self.n_shared_experts * expert
            total += n_moe_layers * d * self.num_experts    # router
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def num_active_params(self) -> int:
        if not self.num_experts:
            return self.num_params()
        d, l = self.d_model, self.num_layers
        n_moe = l // self.moe_every
        expert = 3 * d * self.d_ff_e
        inactive = n_moe * (self.num_experts - self.experts_per_token) * expert
        return int(self.num_params() - inactive)

    def config_hash(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def supported_shapes(cfg: ModelConfig) -> list[InputShape]:
    """Per-brief skip rules: long_500k only for sub-quadratic archs; no
    decode shapes for encoder-only archs."""
    out = [TRAIN_4K, PREFILL_32K]
    if cfg.decoder:
        out.append(DECODE_32K)
        if cfg.sub_quadratic:
            out.append(LONG_500K)
    return out


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    opt_state_dtype: str = "float32"   # bf16 halves optimizer memory
    grad_dtype: str = "float32"        # bf16 halves gradient-reduce bytes
    microbatch: int = 1                # gradient accumulation steps
    zero3: bool = False                # shard params over data axes too
    remat: bool = True
    seed: int = 0
