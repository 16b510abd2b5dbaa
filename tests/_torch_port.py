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


def softplus(v):
    return np.log1p(np.exp(v)).astype(np.float32)


def sigmoid(v):
    return (1.0 / (1.0 + np.exp(-v))).astype(np.float32)


def ssd_inputs(seed, B, L, H, P, N, chunk):
    """x, dt, A, Bm, Cm in the model layout and the chunked views of them
    (dA, cs computed once here, so both packages see the same f32 values)."""
    x = rnd(seed, (B, L, H, P), 0.5)
    dt = softplus(rnd(seed + 1, (B, L, H)))
    A = -np.exp(rnd(seed + 2, (H,), 0.3))
    Bm = rnd(seed + 3, (B, L, N), 0.3)
    Cm = rnd(seed + 4, (B, L, N), 0.3)
    nc = L // chunk
    dA = (dt * A).reshape(B, nc, chunk, H)
    cs = np.cumsum(dA, axis=2, dtype=np.float32)
    chunked = (x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H), dA,
               cs, Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N))
    return (x, dt, A, Bm, Cm), chunked


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


def record_logits(engine, owner, prefill: str, decode: str):
    """Records, per request id, the logits row of every token ``engine``
    emits: the prefill's last row, then the request's slot row of each decode
    tick.  ``owner`` holds the two callables the engine calls, under the names
    ``prefill`` and ``decode``: the model for the port's engine, the engine
    itself (its jitted ``_prefill`` / ``_decode``) for the JAX one.  They are
    wrapped on the instance; give the port's engine a model of its own."""
    rows = {}
    admitting = []
    admit = engine._admit
    pre, dec = getattr(owner, prefill), getattr(owner, decode)

    def _admit(req, slot):
        admitting[:] = [req.rid]
        return admit(req, slot)

    def _prefill(*args, **kw):
        out = pre(*args, **kw)
        rows.setdefault(admitting[0], []).append(f32(out[0])[0, -1])
        return out

    def _decode(*args, **kw):
        active = [(i, r.rid) for i, r in enumerate(engine.active)
                  if r is not None]
        out = dec(*args, **kw)
        logits = f32(out[0])
        for i, rid in active:
            rows[rid].append(logits[i, -1])
        return out

    engine._admit = _admit
    setattr(owner, prefill, _prefill)
    setattr(owner, decode, _decode)
    return rows


def echo_share(logits, tokens) -> float:
    """Share of positions whose greedy token is the input token there:
    logits (B,S,V) of a teacher-forced forward over tokens (B,S)."""
    return float(np.mean(np.argmax(f32(logits), axis=-1) == np.asarray(tokens)))
