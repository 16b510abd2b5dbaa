"""StarCoder2-7B [arXiv:2402.19173]: dense GQA kv=4 decoder w/ RoPE,
32L, d_model 4608, 36 heads, d_ff 18432."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    block_pattern=("global",),
    act="gelu",
    rope_theta=100_000.0,
    tie_embeddings=True,
)
