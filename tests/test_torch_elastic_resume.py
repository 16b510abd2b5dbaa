"""Elastic resume on the port: a checkpoint written under one layout resumes
under another and keeps training, against the reference's run across meshes.

The reference's run of tests/test_elastic_resume.py (reduced granite-3-8b,
B=8, S=32, lr 1e-3: 5 steps on a (1,1) mesh, saved, restored onto a (2,4)
mesh and 5 more steps) runs in a forced-8-device subprocess, which writes
its initial and final parameters.  The port starts from the same initial
parameters (``from_jax_params``), takes 5 steps under the host mesh's rules,
saves, restores under the (2,4) mesh's rules and takes 5 more; on one device
a layout places nothing, so the resumed run must equal 10 unbroken steps bit
for bit, and end within 5e-3 of the reference's final parameters (the
reference test's bound across its two meshes).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMPipeline
from repro_torch.launch.mesh import make_host_mesh, rules_for
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.models import build_model, from_jax_params
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import Mesh, use_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, S, LR = 8, 32, 1e-3

SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config, reduced
    from repro.data import SyntheticLMPipeline
    from repro.launch.mesh import rules_for
    from repro.launch.steps import init_opt_state, make_train_step
    from repro.models import build_model
    from repro.optim import AdamWConfig
    from repro.sharding import use_mesh

    cfg = reduced(get_config("granite-3-8b"))
    B, S, LR = 8, 32, 1e-3
    ckpt = tempfile.mkdtemp()
    init = {}

    def flat(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v) for path, v in
                jax.tree_util.tree_leaves_with_path(tree)}

    def run_steps(mesh, start, stop, resume):
        rules = rules_for(mesh, batch_size=B)
        with use_mesh(mesh, rules):
            model = build_model(cfg)
            pipe = SyntheticLMPipeline(cfg.vocab_size, B, S, seed=0)
            mgr = CheckpointManager(ckpt)
            if resume:
                model.abstract_params()
                pspecs = model.param_pspecs()
                shardings = jax.tree.map(
                    lambda ps: NamedSharding(mesh, ps), pspecs,
                    is_leaf=lambda x: isinstance(x, P))
                state, meta = mgr.restore(
                    shardings={"params": shardings,
                               "opt": {"master": shardings, "mu": shardings,
                                       "nu": shardings,
                                       "step": NamedSharding(mesh, P())}})
                params, opt = state["params"], state["opt"]
                pipe.load_state_dict(meta["data"])
            else:
                params = model.init_params(jax.random.PRNGKey(0))
                init.update(flat(params))
                opt = init_opt_state(params)
            step_fn = jax.jit(make_train_step(model, AdamWConfig(lr=LR)),
                              donate_argnums=(0, 1))
            losses = []
            for t in range(start, stop):
                b = pipe.batch_at(t)
                pipe.state.step = t + 1
                params, opt, m = step_fn(params, opt, b)
                losses.append(float(m["loss"]))
            mgr.save(stop, {"params": params, "opt": opt},
                     meta={"data": pipe.state_dict()})
            return params, losses

    mesh1 = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    p1, l1 = run_steps(mesh1, 0, 5, resume=False)
    mesh2 = jax.make_mesh((2, 4), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    p2, l2 = run_steps(mesh2, 5, 10, resume=True)
    np.savez(sys.argv[1], **{"init/" + k: v for k, v in init.items()},
             **{"final/" + k: v for k, v in flat(p2).items()})
    print("RESULT", " ".join(repr(x) for x in l1 + l2))
""")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


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
    out = tmp_path_factory.mktemp("elastic") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], env=env,
                          capture_output=True, text=True, timeout=420,
                          cwd=str(ROOT))
    assert proc.returncode == 0, (proc.stdout[-1000:], proc.stderr[-3000:])
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT"))
    with np.load(out) as z:
        tree = _nest({k: z[k] for k in z.files})
    return tree["init"], tree["final"], [float(x) for x in line.split()[1:]]


def _run(cfg, params, opt, mesh, start, stop):
    with use_mesh(mesh, rules_for(mesh, batch_size=B)):
        step = make_train_step(build_model(cfg, device="cpu"),
                               AdamWConfig(lr=LR))
        pipe = SyntheticLMPipeline(cfg.vocab_size, B, S, seed=0)
        losses = []
        for t in range(start, stop):
            params, opt, m = step(params, opt, pipe.batch_at(t))
            pipe.state.step = t + 1
            losses.append(float(m["loss"]))
    return params, opt, losses, pipe


def test_resume_across_meshes_matches_the_reference(reference, tmp_path):
    init, ref_final, ref_losses = reference
    cfg = reduced(get_config("granite-3-8b")).replace(attn_impl="blocked")
    host, wide = make_host_mesh(), Mesh((2, 4), ("data", "model"))

    params = from_jax_params(init, device="cpu")
    params, opt, l1, pipe = _run(cfg, params, init_opt_state(params), host,
                                 0, 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"params": params, "opt": opt},
             meta={"data": pipe.state_dict()})
    del params, opt
    state, meta = mgr.restore(device="cpu")
    assert meta["step"] == 5 and meta["data"]["step"] == 5
    resumed, _, l2, _ = _run(cfg, state["params"], state["opt"], wide, 5, 10)

    params = from_jax_params(init, device="cpu")
    straight, _, l3, _ = _run(cfg, params, init_opt_state(params), host,
                              0, 10)
    a, b = _flat(resumed), _flat(straight)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert l1 + l2 == l3 and np.isfinite(l3).all()
    got, want = _flat(resumed), _flat(ref_final)
    assert set(got) == set(want)
    err = max(float(np.abs(got[k].numpy() - np.asarray(want[k], np.float32))
                    .max()) for k in got)
    assert err < 5e-3, err
    assert np.allclose(l3, ref_losses, rtol=1e-5)
