"""Mamba2-130M [arXiv:2405.21060]: attention-free SSD (state-space duality),
24L, d_model 768, state 128, expand 2, head_dim 64.  Runs long_500k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,                # unused by mamba blocks
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,                     # no MLP: mamba block carries the capacity
    vocab_size=50_280,
    block_pattern=("mamba2",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_width=4,
    tie_embeddings=True,
)
