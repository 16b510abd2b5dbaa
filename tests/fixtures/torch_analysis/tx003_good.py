"""TX003 fixtures — effects deferred to the first call (clean + waiver)."""
import os

from repro_torch.kernels import _build

_lib = None


def kernel():
    global _lib
    if _lib is None:
        import triton                          # inside the launching function
        del triton
        _lib = _build.load("flash_attention")  # the first call, not import
    return _lib


os.environ.setdefault("X", "1")  # lint: waive TX003 -- fixture: a program


def env_for():
    return dict(os.environ, PYTHONPATH="src")  # a copy: no write
