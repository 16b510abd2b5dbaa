"""Plain PyTorch oracles of the ported kernels, under the reference's names.

The twin of ``src/repro/kernels/ref.py`` for the kernels ported so far.  One
difference, stated in the tests: on a row with no valid key the JAX oracle
returns the mean of ``v`` (a softmax over equal -1e30 scores); these follow the
kernels and return 0.
"""
from .decode_attention import decode_attention_plain as decode_attention_ref
from .flash_attention import flash_attention_plain as flash_attention_ref

__all__ = ["flash_attention_ref", "decode_attention_ref"]
