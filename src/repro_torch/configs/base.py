"""Config system: architecture + run-shape + mesh configs.

Every assigned architecture is a ``ModelConfig`` in
``repro_torch/configs/<id>.py`` (field for field the reference package's);
the four canonical input shapes live here.  ``reduced()`` derives the small
CPU-smoke-test variant of any architecture (same family/wiring, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads

    # attention flavour
    block_pattern: Tuple[str, ...] = ("global",)   # cycled over layers
    window_size: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    max_seq_len: int = 131_072

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2) / RG-LRU (recurrentgemma)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    lru_width: int = 0

    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # modality frontend (STUB: precomputed embeddings arrive as inputs)
    frontend: Optional[str] = None    # None | "vision" | "audio"
    num_prefix_tokens: int = 0        # e.g. 256 SigLIP patch embeddings

    act: str = "silu"                 # silu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # implementation switches
    attn_impl: str = "cuda"           # cuda (hand-written kernels; the twin
                                      # of the reference's "pallas") | einsum
    remat: str = "none"               # none | full | selective
    scan_layers: bool = True
    moe_impl: str = "onehot"          # onehot (GShard dispatch) | sort (gather)
    moe_group_size: int = 2048        # routing-group tokens (onehot path)
    kv_cache_dtype: str = "model"     # model (= dtype) | int8 (quantised KV)
    attn_scores_f32: bool = True      # False: bf16 score tensors (halves the
                                      # blocked-attention HBM term)
    pipeline_stages: int = 1          # >1: GPipe stages over the mesh's pod
    pipeline_microbatches: int = 8

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (Megatron-style padding, kept
        so parameter shapes equal the reference's).  Padded logit columns are
        masked to -1e30 before softmax/CE."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def attention_free(self) -> bool:
        return all(b in ("mamba2",) for b in self.block_pattern)

    @property
    def full_attention(self) -> bool:
        """True if any layer uses unbounded global attention."""
        return any(b == "global" for b in self.block_pattern) or \
            self.is_encoder_decoder

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable?, reason) for an (arch × shape) cell — see DESIGN.md §5."""
    if shape.name == "long_500k" and model.full_attention:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests (one fwd/train step)."""
    pattern_len = len(cfg.block_pattern)
    layers = max(2 * pattern_len, 2)
    enc = min(cfg.num_encoder_layers, 2) if cfg.is_encoder_decoder else 0
    return cfg.replace(
        num_layers=layers,
        num_encoder_layers=enc,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        moe_d_ff=64 if cfg.num_experts else 0,
        num_experts=min(cfg.num_experts, 8),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        vocab_size=256,
        window_size=32,
        max_seq_len=512,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=16,
        lru_width=64 if cfg.lru_width else 0,
        num_prefix_tokens=8 if cfg.num_prefix_tokens else 0,
        dtype="float32",
    )
