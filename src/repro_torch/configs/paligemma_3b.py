"""PaliGemma-3B — SigLIP (stub) + Gemma backbone, MQA (kv=1)
[arXiv:2407.07726].  input_specs feeds 256 precomputed patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216,
    frontend="vision", num_prefix_tokens=256,
)
