"""Granite-3-8B [hf:ibm-granite]: dense GQA decoder, 40L, d_model 4096,
32 heads kv=8, d_ff 12800."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,
    block_pattern=("global",),
    rope_theta=10_000.0,
    tie_embeddings=True,
)
