"""Hymba-1.5B — parallel attention + Mamba heads per layer, SWA with
global meta tokens, ssm_state=16 [arXiv:2411.13676].
We approximate the 3 global-attention layers with 128 learned meta tokens
visible everywhere (see DESIGN.md §Arch-applicability)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    attn_type="sliding", window=2048, num_meta_tokens=128,
    ssm_state=16, ssm_heads=25,
)
