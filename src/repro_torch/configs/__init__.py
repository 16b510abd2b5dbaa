"""Architecture config registry: ``get_config("<arch-id>")`` + shapes."""
from .base import (ModelConfig, ShapeConfig, SHAPES, cell_is_runnable,
                   reduced)
from . import (dbrx_132b, deepseek_moe_16b, gemma2_2b, granite_3_8b,
               mamba2_130m, mistral_nemo_12b, paligemma_3b,
               recurrentgemma_2b, seamless_m4t_large_v2, starcoder2_7b)

ARCHITECTURES = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_moe_16b, dbrx_132b, granite_3_8b, gemma2_2b,
              starcoder2_7b, mistral_nemo_12b, recurrentgemma_2b,
              mamba2_130m, paligemma_3b, seamless_m4t_large_v2)
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHITECTURES)}")


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHITECTURES",
           "get_config", "get_shape", "cell_is_runnable", "reduced"]
