"""Typed error hierarchy for the scenario facade (DESIGN.md §9, §14).

All facade validation errors derive from :class:`ScenarioError`, which
itself derives from ``ValueError`` so pre-existing ``except ValueError``
call sites (and tests pinning ``pytest.raises(ValueError)``) keep working
through the transition.

* :class:`BackendCapabilityError` — the requested feature exists, but not
  on the requested backend; the message names the capability and the
  backend(s) that do have it.
* :class:`LaneAxisError` — a ``sweep`` axis (name, value, or combination)
  is malformed or unsupported.
"""
from __future__ import annotations


class ScenarioError(ValueError):
    """Base class for scenario facade configuration errors."""


class BackendCapabilityError(ScenarioError):
    """A capability is not available on the requested backend.

    Constructed with the capability, the backend that was asked, and the
    backend(s) that support it, so messages are uniformly actionable.
    """

    def __init__(self, capability: str, backend: str, supported: str,
                 detail: str = ""):
        self.capability = capability
        self.backend = backend
        self.supported = supported
        msg = (f"{capability} is not supported on backend={backend!r}; "
               f"use {supported}")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class LaneAxisError(ScenarioError):
    """A sweep lane axis is unknown, malformed, or inconsistent."""
