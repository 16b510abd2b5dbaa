"""PaliGemma-3B [arXiv:2407.07726]: SigLIP vision frontend (STUB: precomputed
patch embeddings) + Gemma-2B text backbone: 18L, d_model 2048, 8 heads MQA
kv=1, d_ff 16384, vocab 257216, 256 image-prefix tokens."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    block_pattern=("global",),
    frontend="vision",
    num_prefix_tokens=256,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
