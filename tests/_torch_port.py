"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both frameworks; results
come back as float32 numpy arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import reduced as torch_reduced

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def to_jax(x, dtype="float32"):
    return jnp.asarray(x, JDT[dtype])


def to_torch(x, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TDT[dtype])


def f32(x):
    """A jax or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def config_pair(arch, jax_impl="einsum", torch_impl="einsum", **overrides):
    """The reduced config of ``arch`` in both packages, same overrides."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(attn_impl=jax_impl,
                                                     **overrides)
    tcfg = torch_reduced(torch_get_config(arch)).replace(attn_impl=torch_impl,
                                                         **overrides)
    # every field but the implementation switch agrees
    a, b = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    a.pop("attn_impl"), b.pop("attn_impl")
    assert a == b
    return jcfg, tcfg


def numpy_tree(tree):
    """A jax pytree as nested dicts of numpy arrays (what the port accepts)."""
    return jax.tree.map(np.asarray, tree)


def assert_trees_close(torch_tree, jax_tree, tol):
    """Nested dicts, leaf by leaf under the same keys."""
    assert isinstance(torch_tree, dict) == isinstance(jax_tree, dict)
    if isinstance(torch_tree, dict):
        assert sorted(torch_tree) == sorted(jax_tree)
        for key in torch_tree:
            assert_trees_close(torch_tree[key], jax_tree[key], tol)
    else:
        assert tuple(torch_tree.shape) == tuple(jax_tree.shape)
        assert_close(torch_tree, jax_tree, tol)
