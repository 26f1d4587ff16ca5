"""StarCoder2-15B — dense, GQA kv=4, RoPE, non-gated FFN [arXiv:2402.19173]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    head_dim=128, d_ff=24576, vocab_size=49152,
    gated_ffn=False, rope_theta=100_000.0, qkv_bias=True,
)
