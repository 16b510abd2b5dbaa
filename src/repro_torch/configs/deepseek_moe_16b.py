"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64 routed
top-6 experts, 28L, d_model 2048, 16 heads (kv=16), expert d_ff 1408."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                 # per-expert width (fine-grained)
    moe_d_ff=1408,
    vocab_size=102_400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    block_pattern=("global",),
    rope_theta=10_000.0,
    tie_embeddings=False,
)
