"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: dense GQA kv=8,
40L, d_model 5120, 32 heads (head_dim 128), d_ff 14336, 128k context."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    block_pattern=("global",),
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    tie_embeddings=False,
)
