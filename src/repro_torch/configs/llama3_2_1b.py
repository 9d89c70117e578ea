"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B; unverified]

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256 — small llama3.
"""
from .base import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    qkv_bias=False,
    tie_embeddings=True,
)
FAMILY = "lm"
