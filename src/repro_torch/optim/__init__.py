from .adamw import (AdamWConfig, adamw_init, adamw_update, apply_updates,
                    global_norm)
from .schedule import cosine_schedule
from .compression import (compress_int8, decompress_int8, ef_compress_grads,
                          ef_init)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "apply_updates",
           "global_norm", "cosine_schedule", "compress_int8",
           "decompress_int8", "ef_compress_grads", "ef_init"]
