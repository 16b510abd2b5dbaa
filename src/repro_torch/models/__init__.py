"""Model substrate of the port: layers, attention, stacks, the Model API.

Differences from ``repro.models`` that hold for every module here: the
reference also annotates activations with logical sharding axes
(``sharding.shard(...)``, no-ops outside a mesh); the port runs on one device
and drops those (parameters keep theirs: ``Model.param_logical`` /
``param_pspecs``).  ``jit`` has no counterpart (PyTorch runs eagerly), and the
``lax.scan`` over layers is a Python loop over views of the stacked leaves.
"""
from .model import Model, build_model
from .params import ParamStore, from_jax_params

__all__ = ["Model", "build_model", "ParamStore", "from_jax_params"]
