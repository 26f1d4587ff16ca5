"""HuBERT X-Large — encoder-only audio transformer (frame embeddings
precomputed by a stub conv frontend) [arXiv:2106.07447]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    head_dim=80, d_ff=5120, vocab_size=504,
    causal=False, gated_ffn=False, frontend="audio",
    tie_embeddings=False,
)
