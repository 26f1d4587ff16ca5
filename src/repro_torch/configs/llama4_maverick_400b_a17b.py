"""Llama-4 Maverick-class 400B/A17B — interleaved MoE (every other layer
routed, 128 experts top-1 + 1 shared expert), GQA kv=8
[hf:meta-llama/Llama-4-*; unverified].  moe_every=2 reproduces the ~400B
total / ~17B active split with the brief's dims (see DESIGN.md)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_every=2,
    d_ff_expert=8192, n_shared_experts=1,
)
