"""The port's GPipe schedule (``models/pipeline.py``) against the reference's
and against the port's own plain stack, on the CPU.

The reference's case of tests/test_pipeline.py (reduced granite-3-8b in f32,
2 repeats on 2 stages, 2 microbatches, B=4, S=32, a (2,2,2) pod/data/model
mesh with ``rules_for(kind="train_pp")``) runs in a forced-8-device
subprocess, which also writes its parameters and batch; the port runs
``pipeline_stack`` on ``from_jax_params`` of the same parameters.
Tolerances: the pipelined loss within 1e-5 relative of the reference's, and
the gradient norm (the sum of |g| over every leaf, as the reference prints
it) within 1e-4 relative; against the port's own plain stack, the loss
within 1e-6 relative and every gradient leaf within 1e-5 of its largest
entry.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import rules_for
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding import Mesh, use_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 32
POD_MESH = Mesh((2, 2, 2), ("pod", "data", "model"))

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.models import build_model
    from repro.sharding import use_mesh
    from repro.launch.mesh import rules_for

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    cfg = reduced(get_config("granite-3-8b"))
    B, S = 4, 32
    rules = rules_for(mesh, batch_size=B, kind="train_pp")
    with use_mesh(mesh, rules):
        model = build_model(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        toks = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                  cfg.vocab_size)
        batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
        model_pp = build_model(cfg.replace(pipeline_stages=2,
                                           pipeline_microbatches=2))
        def shard_stack(path, leaf):
            names = [getattr(k, "key", None) for k in path]
            if "stack" in names:
                return jax.device_put(leaf, NamedSharding(
                    mesh, P(*("pod",) + (None,) * (leaf.ndim - 1))))
            return leaf
        params_pp = jax.tree_util.tree_map_with_path(shard_stack, params)
        pp = jax.jit(model_pp.loss_fn)(params_pp, batch)
        g = jax.jit(jax.grad(model_pp.loss_fn))(params_pp, batch)
        gn = sum(float(jnp.sum(jnp.abs(x.astype(jnp.float32))))
                 for x in jax.tree.leaves(g))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(sys.argv[1], tokens=np.asarray(toks), **flat)
    print(f"RESULT {float(pp)!r} {gn!r}")
""")


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], env=env,
                          capture_output=True, text=True, timeout=420,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT"))
    loss, gn = map(float, line.split()[1:])
    with np.load(out) as z:
        tokens = z["tokens"]
        params = _nest({k: z[k] for k in z.files if k != "tokens"})
    return loss, gn, params, tokens


def _cfg(**kw):
    return reduced(get_config("granite-3-8b")).replace(attn_impl="blocked",
                                                        **kw)


def _batch(tokens):
    t = torch.from_numpy(np.asarray(tokens, np.int64))
    return {"tokens": t, "labels": torch.roll(t, -1, 1)}


def _loss_and_grads(cfg, params, batch):
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss = build_model(cfg, device="cpu").loss_fn(live, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))


def test_gpipe_matches_the_reference_pipeline(reference):
    ref_loss, ref_gn, jparams, tokens = reference
    params = from_jax_params(jparams, device="cpu")
    with use_mesh(POD_MESH, rules_for(POD_MESH, batch_size=B,
                                      kind="train_pp")):
        loss, grads = _loss_and_grads(
            _cfg(pipeline_stages=2, pipeline_microbatches=2), params,
            _batch(tokens))
    gn = sum(float(g.abs().sum()) for g in grads)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    assert abs(gn - ref_gn) <= 1e-4 * ref_gn and np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("stages,micro,remat", [
    (2, 2, "none"), (2, 4, "full"), (4, 2, "none"), (4, 4, "selective"),
    (1, 2, "none")])
def test_gpipe_matches_the_plain_stack(stages, micro, remat):
    """Reduced granite with 4 repeats, B=4: the pipelined loss and every
    gradient leaf against the plain stack on the same parameters."""
    cfg = _cfg(num_layers=4, remat=remat)
    params = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    batch = _batch(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    mesh = Mesh((stages, 2, 2), ("pod", "data", "model"))
    with use_mesh(mesh, rules_for(mesh, batch_size=B, kind="train_pp")):
        base, g0 = _loss_and_grads(cfg, params, batch)
        pp, g1 = _loss_and_grads(
            cfg.replace(pipeline_stages=stages, pipeline_microbatches=micro),
            params, batch)
    assert abs(float(pp) - float(base)) <= 1e-6 * abs(float(base))
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        assert bool(b.any())


def test_encoder_stack_is_never_pipelined():
    """``apply_stack(encoder=True)`` runs the plain stack whatever
    ``pipeline_stages`` says (as the reference's), so it needs no mesh."""
    from repro_torch.models import transformer as tf
    cfg = reduced(get_config("seamless-m4t-large-v2")).replace(
        attn_impl="blocked")
    params = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 24, cfg.d_model)).astype(np.float32))
    pos = torch.arange(24)[None, :]
    plain = tf.apply_stack(params["encoder"], cfg, x, pos, encoder=True)
    piped = tf.apply_stack(params["encoder"],
                           cfg.replace(pipeline_stages=2,
                                       pipeline_microbatches=2),
                           x, pos, encoder=True)
    assert torch.equal(plain, piped)


def test_pipeline_checks_raise_with_the_reference_messages():
    cfg = _cfg(pipeline_stages=2, pipeline_microbatches=2)
    params = build_model(cfg, device="cpu").init_params()
    batch = _batch(np.zeros((B, S), np.int64))
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh with a 'pod' axis"):
        model.loss_fn(params, batch)
    four = Mesh((4, 2, 1), ("pod", "data", "model"))
    with use_mesh(four, rules_for(four, batch_size=B, kind="train_pp")):
        with pytest.raises(ValueError, match=r"repeats 2 % stages 4 != 0"):
            model.loss_fn(params, batch)
    with use_mesh(POD_MESH, rules_for(POD_MESH, batch_size=B,
                                      kind="train_pp")):
        with pytest.raises(ValueError, match=r"batch 4 % microbatches 3"):
            build_model(cfg.replace(pipeline_microbatches=3),
                        device="cpu").loss_fn(params, batch)
    with use_mesh(POD_MESH, rules_for(POD_MESH, batch_size=B, kind="train")):
        with pytest.raises(ValueError, match="must not shard over 'pod'"):
            model.loss_fn(params, batch)
    odd = reduced(get_config("gemma2-2b")).replace(
        attn_impl="blocked", num_layers=5, pipeline_stages=2,
        pipeline_microbatches=2)
    with use_mesh(POD_MESH, rules_for(POD_MESH, batch_size=B,
                                      kind="train_pp")):
        with pytest.raises(ValueError, match="layers % pattern"):
            build_model(odd, device="cpu").loss_fn(
                build_model(odd, device="cpu").init_params(), batch)
