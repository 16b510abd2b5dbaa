"""DBRX-132B [hf:databricks/dbrx-base]: 16-expert top-4 MoE, 40L,
d_model 6144, 48 heads GQA kv=8, expert d_ff 10752."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10_752,
    moe_d_ff=10_752,
    vocab_size=100_352,
    num_experts=16,
    num_shared_experts=0,
    top_k=4,
    block_pattern=("global",),
    rope_theta=500_000.0,
    tie_embeddings=False,
)
