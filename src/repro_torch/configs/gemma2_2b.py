"""Gemma2-2B [arXiv:2408.00118]: local/global alternating attention with
logit softcaps, 26L, d_model 2304, 8 heads GQA kv=4, d_ff 9216, vocab 256k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    block_pattern=("local", "global"),     # 1:1 alternation
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
