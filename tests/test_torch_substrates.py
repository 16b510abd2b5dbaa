"""The port's training substrates — data pipeline, optimizer, compression,
checkpointing — mirroring tests/test_substrates.py on the CPU, and held
against the JAX package on the same numpy inputs: the pipeline's batches
array for array, int8 codes exactly, one AdamW step at 1e-6 relative (f32 and
bf16 moments; the two back ends round pow and sqrt alike but not always
divide and sum alike), and checkpoints written by either package restored by
the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, numpy_tree
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import SyntheticLMPipeline as JaxPipeline
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import compress_int8 as jax_compress_int8
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro.optim import ef_compress_grads as jax_ef_compress_grads
from repro.optim import ef_init as jax_ef_init
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMPipeline
from repro_torch.models.params import from_jax_params, tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               apply_updates, compress_int8, cosine_schedule,
                               decompress_int8, ef_compress_grads, ef_init,
                               global_norm)

torch.set_num_threads(1)


# ---------------------------------------------------------------- data

def test_pipeline_deterministic_addressing():
    p1 = SyntheticLMPipeline(1000, 8, 64, seed=3)
    p2 = SyntheticLMPipeline(1000, 8, 64, seed=3)
    for step in [0, 5, 17]:
        np.testing.assert_array_equal(p1.batch_at(step)["tokens"],
                                      p2.batch_at(step)["tokens"])


def test_pipeline_restart_no_drift():
    p = SyntheticLMPipeline(1000, 4, 32, seed=0)
    seen = [p.next_batch()["tokens"] for _ in range(6)]
    p2 = SyntheticLMPipeline(1000, 4, 32, seed=999)
    p2.load_state_dict({"seed": 0, "step": 3})
    np.testing.assert_array_equal(p2.next_batch()["tokens"], seen[3])
    np.testing.assert_array_equal(p2.next_batch()["tokens"], seen[4])


def test_pipeline_host_sharding_partitions_global_batch():
    g = SyntheticLMPipeline(500, 8, 16, seed=1).batch_at(7)["tokens"]
    parts = [SyntheticLMPipeline(500, 8, 16, seed=1, host_index=i,
                                 host_count=4).batch_at(7)["tokens"]
             for i in range(4)]
    assert g.shape == (8, 16)
    assert all(p.shape == (2, 16) for p in parts)
    assert len({p.tobytes() for p in parts}) == 4


def test_pipeline_labels_shifted():
    b = SyntheticLMPipeline(100, 2, 16, seed=0).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("vocab,batch,seq,seed,host", [
    (1000, 8, 64, 3, (0, 1)), (50277, 4, 256, 0, (0, 1)),
    (500, 8, 16, 1, (2, 4))])
def test_pipeline_batches_equal_the_reference(vocab, batch, seq, seed, host):
    kw = dict(seed=seed, host_index=host[0], host_count=host[1])
    mine, ref = (SyntheticLMPipeline(vocab, batch, seq, **kw),
                 JaxPipeline(vocab, batch, seq, **kw))
    for step in (0, 1, 9):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    mine.next_batch(), ref.next_batch()
    assert mine.state_dict() == ref.state_dict()


# ---------------------------------------------------------------- optimizer

def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(200):
        g = {"w": 2.0 * params["w"]}               # d/dw sum(w^2)
        params, opt, _ = adamw_update(cfg, g, opt, params=params)
    assert float(torch.sum(torch.square(params["w"]))) < 1e-3


def test_adamw_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    g = {"w": torch.full((4,), 1e6)}
    new, opt, gnorm = adamw_update(cfg, g, opt, params=params)
    assert float(gnorm) == pytest.approx(2e6, rel=1e-3)
    assert torch.all(new["w"].abs() < 2.0)          # clipped step
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((6, 8)).astype(np.float32),
                  "b": rng.standard_normal((8,)).astype(np.float32)},
            "emb": rng.standard_normal((16, 4)).astype(np.float32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_step_matches_reference(moment_dtype, param_dtype):
    """Three AdamW steps (the clip active in the last) on the same numpy
    gradients against ``repro.optim.adamw_update``: master, moments and new
    parameters at 1e-6 relative to each leaf's largest entry (bf16 leaves at
    one bf16 step), the norm at 1e-6."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    p_np = _opt_tree(0)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tparams = from_jax_params(numpy_tree(jparams), device="cpu")
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    jopt = jax_adamw_init(jparams, moment_dtype=moment_dtype)
    topt = adamw_init(tparams, moment_dtype=moment_dtype)
    for step, scale in enumerate((0.1, 0.3, 10.0)):
        g_np = jax.tree.map(lambda a: a * np.float32(scale), _opt_tree(step + 1))
        jparams, jopt, jn = jax_adamw_update(
            cfg, jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np), jopt,
            params=jparams)
        tparams, topt, tn = adamw_update(
            cfg, from_jax_params(numpy_tree(jax.tree.map(
                lambda a: jnp.asarray(a, jdt), g_np)), device="cpu"),
            topt, params=tparams)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        for name in ("master", "mu", "nu"):
            for got, want in zip(tree_leaves(_sorted(topt[name])),
                                 jax.tree.leaves(jopt[name])):
                assert got.dtype == {"float32": torch.float32,
                                     "bfloat16": torch.bfloat16}[
                    moment_dtype if name != "master" else "float32"]
                _close(got, want, name != "master" and moment_dtype
                       == "bfloat16")
        for got, want in zip(tree_leaves(_sorted(tparams)),
                             jax.tree.leaves(jparams)):
            assert str(got.dtype)[6:] == param_dtype
            _close(got, want, param_dtype == "bfloat16")


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _close(got, want, bf16: bool):
    got, want = f32(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    tol = 2.0 ** -7 if bf16 else 1e-6
    assert float(np.abs(got - want).max()) <= tol * scale


def test_global_norm_and_apply_updates_match_reference():
    p_np, u_np = _opt_tree(0), _opt_tree(1)
    tp = from_jax_params(p_np, device="cpu")
    tu = from_jax_params(u_np, device="cpu")
    np.testing.assert_allclose(float(global_norm(tp)),
                               float(jax_global_norm(p_np)), rtol=1e-6)
    got = apply_updates(tp, tu)
    want = jax_apply_updates(jax.tree.map(jnp.asarray, p_np),
                             jax.tree.map(jnp.asarray, u_np))
    for g, w in zip(tree_leaves(_sorted(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(f32(g), np.asarray(w))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 100, 140])
def test_cosine_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    got = cosine_schedule(step, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_cosine_schedule(step, **kw)),
                               rtol=1e-6)
    assert float(cosine_schedule(torch.tensor(step), **kw)) == float(got)


# ---------------------------------------------------------------- compression

@pytest.mark.parametrize("seed", [0, 7, 50])
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_int8_compression_bounded_error(seed, scale):
    x = torch.randn(256, generator=torch.Generator().manual_seed(seed)) * scale
    q, s = compress_int8(x)
    rt = decompress_int8(q, s)
    assert q.dtype == torch.int8
    # error bounded by half a quantisation bucket
    np.testing.assert_allclose(rt.numpy(), x.numpy(),
                               atol=float(s) * 0.51 + 1e-12)


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_int8_codes_equal_the_reference(scale):
    x = (np.random.default_rng(3).standard_normal(4096) * scale
         ).astype(np.float32)
    x[17] = np.float32(0.5) * x.max()             # a code at a .5 boundary
    q, s = compress_int8(torch.from_numpy(x))
    jq, js = jax_compress_int8(jnp.asarray(x))
    assert float(s) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_ef_compress_grads_matches_reference():
    g_np = _opt_tree(2)
    err = ef_init(from_jax_params(g_np, device="cpu"))
    jerr = jax_ef_init(jax.tree.map(jnp.asarray, g_np))
    for step in range(3):
        g_np = _opt_tree(step + 2)
        rt, err = ef_compress_grads(from_jax_params(g_np, device="cpu"), err)
        jrt, jerr = jax_ef_compress_grads(jax.tree.map(jnp.asarray, g_np),
                                          jerr)
        for a, b in zip(tree_leaves(_sorted(rt)), jax.tree.leaves(jrt)):
            np.testing.assert_array_equal(f32(a), np.asarray(b))
        for a, b in zip(tree_leaves(_sorted(err)), jax.tree.leaves(jerr)):
            np.testing.assert_allclose(f32(a), np.asarray(b), rtol=0,
                                       atol=1e-7 * float(np.abs(b).max()))


def test_error_feedback_preserves_signal_over_steps():
    """EF: the accumulated transmitted signal tracks the true gradient sum."""
    rng = np.random.default_rng(0)
    true = [rng.normal(size=64).astype(np.float32) * 1e-3 for _ in range(50)]
    err = ef_init({"g": torch.zeros(64)})
    sent = np.zeros(64, dtype=np.float64)
    for g in true:
        rt, err = ef_compress_grads({"g": torch.from_numpy(g)}, err)
        sent += rt["g"].numpy().astype(np.float64)
    total = np.sum(true, axis=0)
    np.testing.assert_allclose(sent + err["g"].numpy(), total, rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------- checkpoint

def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn((4, 8), generator=g),
                  "b": torch.randn((8,), generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = make_tree()
    mgr.save(10, tree, meta={"data": {"seed": 0, "step": 10}})
    got, meta = mgr.restore()
    assert meta["step"] == 10 and meta["data"]["step"] == 10
    assert torch.equal(got["a"]["w"], tree["a"]["w"])
    assert got["a"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["a"]["b"], tree["a"]["b"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, make_tree(s))
    assert mgr.latest_step() == 4
    assert mgr.steps() == [3, 4]                 # older ones collected
    got, _ = mgr.restore(step=3)
    assert got is not None


def test_checkpoint_async_save(tmp_path):
    """The device->host copy is made before the writer starts: the tree may
    change at once (the optimizer updates its state in place)."""
    mgr = CheckpointManager(tmp_path)
    tree = make_tree()
    want = tree["a"]["w"].clone()
    mgr.save(5, tree, blocking=False)
    tree["a"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore()[0]["a"]["w"], want)


def test_checkpoint_crash_mid_write_keeps_previous(tmp_path):
    """A partially-written checkpoint must never become the restore point."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, make_tree(1))
    d = tmp_path / "step_000000099"
    d.mkdir()
    (d / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1                # manifest still points at 1
    got, meta = mgr.restore()
    assert meta["step"] == 1


def test_checkpoint_restore_with_device(tmp_path):
    """The reference's ``restore(shardings=)`` is ``restore(device=)``."""
    mgr = CheckpointManager(tmp_path)
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    mgr.save(1, tree)
    got, _ = mgr.restore(device="cpu")
    assert got["w"].device == torch.device("cpu")
    assert torch.equal(got["w"], tree["w"])


def _bf16_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(rng.standard_normal((5, 3)),
                                        jnp.bfloat16),
                       "s": jnp.asarray(rng.standard_normal(3), jnp.float32)},
            "opt": {"step": jnp.int32(4)}}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _bf16_tree(0)
    JaxCheckpointManager(tmp_path).save(4, tree, meta={"data": {"seed": 1,
                                                                "step": 4}})
    got, meta = CheckpointManager(tmp_path).restore(device="cpu")
    assert meta["data"] == {"seed": 1, "step": 4} and meta["step"] == 4
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got["params"]["w"]),
                                  np.asarray(tree["params"]["w"], np.float32))
    np.testing.assert_array_equal(got["params"]["s"].numpy(),
                                  np.asarray(tree["params"]["s"]))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 4


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = make_tree(3)
    CheckpointManager(tmp_path).save(2, tree, meta={"data": {"seed": 0,
                                                             "step": 2}})
    got, meta = JaxCheckpointManager(tmp_path).restore()
    assert meta["step"] == 2 and meta["_dtypes"] == {"a/b": "bfloat16"}
    assert got["a"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["a"]["b"], np.float32),
                                  f32(tree["a"]["b"]))
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"].numpy())
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7
