"""SeamlessM4T-Large-v2 [arXiv:2308.11596]: encoder-decoder transformer
backbone (audio frontend STUB: precomputed frame embeddings), 24L enc +
24L dec, d_model 1024, 16 heads (kv=16), d_ff 8192, vocab 256206."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,                 # decoder layers
    num_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    block_pattern=("global",),
    frontend="audio",
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)
