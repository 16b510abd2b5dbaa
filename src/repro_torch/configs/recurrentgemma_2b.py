"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: RG-LRU recurrent blocks
with 1 local-attention layer per 2 recurrent layers, 26L, d_model 2560,
10 heads MQA kv=1, d_ff 7680.  Attention is bounded-window only => runs the
long_500k cell (constant-size state)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,                       # pattern cycles rglru,rglru,local
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    lru_width=2560,
    conv_width=4,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
