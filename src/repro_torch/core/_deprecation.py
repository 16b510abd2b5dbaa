"""Shared shim factory for the one-release deprecation policy (DESIGN.md §4,
§9): legacy entry points warn and delegate to the unchanged internals."""
from __future__ import annotations

import functools
import warnings


def deprecated_entry_point(fn, alternative: str):
    """Warn-and-delegate wrapper around an unchanged internal entry point."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        warnings.warn(
            f"calling {fn.__name__} directly is deprecated; use {alternative}",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)
    return wrapper
