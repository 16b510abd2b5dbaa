"""The port's training path on the CPU: the training loop (mirroring the five
training tests of tests/test_train_and_serve.py), one train step per
architecture (mirroring tests/test_arch_smoke.py), train steps and
checkpoints against the JAX package's, and ``remat``.  The kernels' refusal
to run under grad is in tests/test_torch_card.py.

Tolerances.  Losses 1e-5.  Parameters after 5 AdamW steps: 1e-3 of each
leaf's largest entry (Adam divides a gradient's small difference by
sqrt(v), so an update's relative error exceeds the gradient's); with int8
compression 5·lr absolute (a code one step off at its rounding boundary
moves an element's update by up to lr a step).  ``remat`` and a resumed run:
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import config_pair, f32, numpy_tree
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.launch.steps import init_opt_state as jax_init_opt_state
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import train as jax_train
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHITECTURES, get_config, reduced
from repro_torch.data import SyntheticLMPipeline
from repro_torch.launch.steps import (batch_to, init_opt_state,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.launch.train import (StragglerWatchdog, deterministic,
                                      train, train_config, train_with_retries)
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.params import tree_leaves
from repro_torch.models.ssm import inclusive_cumsum
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)

CPU = "cpu"
LR = 3e-3


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(f32(got) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------- loop

def test_train_loss_decreases():
    params, losses, _ = train(arch="mamba2-130m", preset="tiny", steps=30,
                              batch=8, seq=64, lr=3e-3, device=CPU)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_train_preemption_resume_bit_exact(tmp_path):
    """5 steps + preemption + resume == 10 uninterrupted steps."""
    kw = dict(arch="mamba2-130m", preset="tiny", steps=10, batch=4, seq=32,
              lr=1e-3, ckpt_every=5, seed=1, device=CPU)
    p_straight, _, _ = train(ckpt_dir=str(tmp_path / "a"), **kw)
    p_resumed, _, _ = train_with_retries(
        ckpt_dir=str(tmp_path / "b"), fail_at=7, **kw)
    assert CheckpointManager(str(tmp_path / "b")).steps() == [5, 10]
    for a, b in zip(tree_leaves(p_straight), tree_leaves(p_resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_with_compression_still_converges():
    _, losses, _ = train(arch="mamba2-130m", preset="tiny", steps=30,
                         batch=8, seq=64, lr=3e-3, compress_grads=True,
                         device=CPU)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_train_with_accumulation_matches_loss_scale():
    _, losses, _ = train(arch="mamba2-130m", preset="tiny", steps=10,
                         batch=8, seq=32, lr=1e-3, accum=4, device=CPU)
    _, plain, _ = train(arch="mamba2-130m", preset="tiny", steps=1,
                        batch=8, seq=32, lr=1e-3, device=CPU)
    assert np.isfinite(losses).all()
    # the mean of 4 microbatch means = the batch mean, before any update
    assert losses[0] == pytest.approx(plain[0], rel=1e-5)


def test_straggler_watchdog_flags_slow_step():
    wd = StragglerWatchdog(factor=3.0, warmup=3)
    flagged = [wd.observe(i, 0.1) for i in range(8)]
    assert not any(flagged)
    assert wd.observe(9, 1.0)          # 10× median -> straggler
    assert wd.events and wd.events[0]["step"] == 9


def test_presets_train_blocked_and_refuse_what_is_not_ported():
    tiny, full = (train_config("gemma2-2b", "tiny"),
                  train_config("gemma2-2b", "full"))
    assert (tiny.attn_impl, tiny.remat, tiny.dtype, tiny.d_model) == (
        "blocked", "none", "float32", 64)
    assert (full.attn_impl, full.remat, full.dtype, full.d_model) == (
        "blocked", "full", "bfloat16", get_config("gemma2-2b").d_model)
    with pytest.raises(ValueError, match="has 256 devices; this process has"):
        train_with_retries(production_mesh=True, steps=1, device=CPU)
    with pytest.raises(ValueError, match="frontend"):
        train_config("paligemma-3b", "full")


# ---------------------------------------------------------------- one step

def _batch(cfg, seed, B=2, S=64):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": t, "labels": np.roll(t, -1, axis=1)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)
                                          ).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_train_step_decreases_loss(arch):
    """The reference's per-architecture step, on its weights: the loss equals
    the reference's (1e-5), the gradient norm is finite and positive, and one
    SGD step moves the loss down."""
    jcfg, cfg = config_pair(arch, "blocked", "blocked")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = build_model(cfg, device=CPU)
    params = from_jax_params(numpy_tree(jparams), device=CPU)
    batch = batch_to(_batch(cfg, 1), CPU)
    live = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss_fn(params, batch)
    g = torch.autograd.grad(loss, live, allow_unused=True,
                            materialize_grads=True)
    l0 = loss.detach()
    jl0 = jmodel.loss_fn(jparams, {k: jnp.asarray(v) for k, v in
                                   _batch(cfg, 1).items()})
    assert float(l0) == pytest.approx(float(jl0), rel=1e-5)
    gnorm = float(torch.sqrt(sum(torch.sum(x.float() ** 2) for x in g)))
    assert np.isfinite(gnorm) and gnorm > 0
    lr = 0.05 / max(gnorm, 1.0)
    with torch.no_grad():
        for p, gg in zip(live, g):
            p.sub_(lr * gg)
        l1 = model.loss_fn(params, batch)
    assert float(l1) < float(l0), f"{arch}: loss {float(l0)} -> {float(l1)}"


# ---------------------------------------------------------------- vs JAX

@pytest.mark.parametrize("accum,compress", [(1, False), (4, False),
                                            (1, True)],
                         ids=["accum1", "accum4", "compress"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-2b"])
def test_train_steps_match_reference(arch, accum, compress):
    """5 steps of ``make_train_step`` against the reference's (jitted), from
    the same weights (``from_jax_params``) on the same batches."""
    jcfg, cfg = config_pair(arch, "blocked", "blocked")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = from_jax_params(numpy_tree(jparams), device=CPU)
    jopt = jax_init_opt_state(jparams, compress_grads=compress)
    opt = init_opt_state(params, compress_grads=compress)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxAdamWConfig(lr=LR),
                                        accum_steps=accum,
                                        compress_grads=compress))
    step = make_train_step(build_model(cfg, device=CPU), AdamWConfig(lr=LR),
                           accum_steps=accum, compress_grads=compress)
    pipe = SyntheticLMPipeline(cfg.vocab_size, 8, 64, seed=0)
    for s in range(5):
        b = pipe.batch_at(s)
        jparams, jopt, jm = jstep(jparams, jopt, b)
        params, opt, m = step(params, opt, b)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-3)
    assert int(opt["step"]) == 5 and sorted(opt) == sorted(jopt)
    for got, want in zip(_sorted_leaves(params), jax.tree.leaves(jparams)):
        if compress:
            np.testing.assert_allclose(f32(got), np.asarray(want, np.float32),
                                       rtol=0, atol=5 * LR)
        else:
            assert _rel_err(got, want) <= 1e-3


def test_checkpoints_cross_packages_and_training_continues(tmp_path):
    """The reference trains 4 steps and saves; the port restores, trains to
    step 8 and saves; the reference restores and trains to step 12.  The
    chain ends within the stated tolerance of the reference's unbroken run,
    and the port's checkpoint holds the reference's tree, dtypes included."""
    kw = dict(arch="mamba2-130m", preset="tiny", batch=4, seq=32, lr=1e-3,
              seed=2, ckpt_every=100)
    d = str(tmp_path / "chain")
    jax_train(steps=4, ckpt_dir=d, **kw)
    _, losses, _ = train(steps=8, ckpt_dir=d, resume=True, device=CPU, **kw)
    assert len(losses) == 4 and np.isfinite(losses).all()
    mine, meta = CheckpointManager(d).restore()
    ref, jmeta = JaxCheckpointManager(d).restore(step=4)
    assert meta["step"] == 8 and meta["data"] == {"seed": 2, "step": 8}
    assert sorted(mine) == sorted(ref) == ["opt", "params"]
    for a, b in zip(_sorted_leaves(mine), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    p_chain, _, _ = jax_train(steps=12, ckpt_dir=d, resume=True, **kw)
    p_ref, _, _ = jax_train(steps=12, **kw)
    for a, b in zip(jax.tree.leaves(p_chain), jax.tree.leaves(p_ref)):
        assert _rel_err(a, b) <= 1e-3


def test_serve_steps_match_reference():
    """``make_prefill_step`` + ``make_serve_step``: greedy tokens equal the
    reference's, logits 1e-4."""
    jcfg, cfg = config_pair("gemma2-2b", "einsum", "einsum")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = build_model(cfg, device=CPU)
    params = from_jax_params(numpy_tree(jparams), device=CPU)
    tokens = _batch(cfg, 3, B=2, S=12)["tokens"]
    logits, cache = make_prefill_step(model, 20)(
        params, {"tokens": torch.from_numpy(tokens)})
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, 20))(
        jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(f32(logits), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    serve, jserve = make_serve_step(model), jax.jit(jax_make_serve_step(jmodel))
    for pos in range(12, 16):
        tok, logits, cache = serve(params, cache, tok, pos)
        jtok, jlogits, jcache = jserve(jparams, jcache, jtok, jnp.int32(pos))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(f32(logits), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- remat

def _loss_and_grads(arch, remat):
    cfg = reduced(get_config(arch)).replace(attn_impl="blocked", remat=remat)
    model = build_model(cfg, device=CPU)
    params = model.init_params(torch.Generator().manual_seed(0))
    live = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss_fn(params, batch_to(_batch(cfg, 5), CPU))
    return loss, live, cfg


@pytest.mark.parametrize("remat", ["full", "selective"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-2b",
                                  "recurrentgemma-2b", "deepseek-moe-16b",
                                  "seamless-m4t-large-v2"])
def test_remat_is_bit_exact(arch, remat):
    """The loss and every gradient leaf, bit for bit, under none and remat."""
    loss0, live0, _ = _loss_and_grads(arch, "none")
    g0 = torch.autograd.grad(loss0, live0, allow_unused=True,
                             materialize_grads=True)
    loss, live, _ = _loss_and_grads(arch, remat)
    g = torch.autograd.grad(loss, live, allow_unused=True,
                            materialize_grads=True)
    assert torch.equal(loss, loss0)
    for a, b in zip(g, g0):
        assert torch.equal(a, b)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_selective_remat_saves_mm_and_recomputes_the_rest():
    """In the backward, ``full`` recomputes the projections' ``mm``s and the
    attention's ``bmm``s; ``selective`` only the ``bmm``s."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    seen = {}
    for remat in ("none", "full", "selective"):
        loss, live, _ = _loss_and_grads("gemma2-2b", remat)
        with _CountOps() as c:
            torch.autograd.grad(loss, live)
        seen[remat] = (c.n.get(mm, 0), c.n.get(bmm, 0))
    assert seen["full"][0] > seen["none"][0] == seen["selective"][0]
    assert seen["full"][1] == seen["selective"][1] > seen["none"][1]
    with pytest.raises(ValueError, match="remat"):
        _loss_and_grads("gemma2-2b", "sometimes")


# ---------------------------------------------------------------- determinism

def test_deterministic_cumsum_and_the_ssd_gradient():
    """Under the training loop's deterministic mode the SSD's cumsum is a fixed-order
    doubling sum (torch has no deterministic float cumsum on a CUDA tensor):
    within 1e-6 of ``torch.cumsum`` and the same bits call to call.  At a
    chunk of 256 the SSD's gradient is finite (the mask is applied before
    exp; the reference's gradient is NaN there)."""
    x = -torch.rand(2, 3, 256, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(inclusive_cumsum(x, 2), torch.cumsum(x, 2))
    with deterministic():
        a, b = inclusive_cumsum(x, 2), inclusive_cumsum(x, 2)
        assert torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), torch.cumsum(x, 2).numpy(),
                               rtol=1e-6, atol=1e-6 * float(x.abs().sum(2).max()))
    cfg = reduced(get_config("mamba2-130m")).replace(attn_impl="blocked")
    model = build_model(cfg, device=CPU)
    params = model.init_params(torch.Generator().manual_seed(0))
    live = [p.requires_grad_() for p in tree_leaves(params)]
    batch = batch_to(SyntheticLMPipeline(cfg.vocab_size, 2, 256).batch_at(0),
                     CPU)
    for mode in (False, True):
        torch.use_deterministic_algorithms(mode)
        try:
            g = torch.autograd.grad(model.loss_fn(params, batch), live)
        finally:
            torch.use_deterministic_algorithms(False)
        assert all(bool(torch.isfinite(x).all()) for x in g)
