"""Model substrate of the port: layers, attention, stacks, the Model API.

Activations carry the reference's logical sharding constraints
(``sharding.shard(...)``): no-ops without a device mesh, as on one card; a
layout for ``DTensor`` activations under one (the dry-run's partitioned
count).  Parameters carry their logical axes (``Model.param_logical`` /
``param_pspecs``).  Differences from ``repro.models`` that hold for every
module here: ``jit`` has no counterpart (PyTorch runs eagerly), and the
``lax.scan`` over layers is a Python loop over views of the stacked leaves.
"""
from .model import Model, build_model
from .params import ParamStore, from_jax_params

__all__ = ["Model", "build_model", "ParamStore", "from_jax_params"]
