"""The port's serving engine: the twins of the serving tests of
tests/test_train_and_serve.py for gemma2-2b, mamba2-130m, recurrentgemma-2b
and deepseek-moe-16b, and the JAX ``ServeEngine``'s tokens AND logits on the
same prompts from converted weights.

With seeded random weights and the tied, sqrt(d_model)-scaled embedding, the
greedy token of these reduced models is the input token at every position,
so a token comparison would pass even if every block returned zeros.  The
weights here have the embedding scaled by 0.1 (the echo share then falls to a
few per cent, asserted below 50%), and the comparisons are of logits, at
every prefill and decode step: 1e-4 in float32 (a few dozen matrix products
deep, each summed in another order by the two back ends, and by the kernel
and einsum paths).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port import (config_pair, echo_share, numpy_tree, record_logits,
                         assert_close)
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.core import poisson_trace
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.engine import _scatter_slot

torch.set_num_threads(1)

TOL = 1e-4
SETUPS = [(arch, impl) for arch in ("gemma2-2b", "mamba2-130m",
                                    "recurrentgemma-2b", "deepseek-moe-16b")
          for impl in ("cuda", "einsum")]


def _setup_id(p):
    arch, impl = p
    return impl if arch == "gemma2-2b" else f"{arch}-{impl}"   # ids of before


@pytest.fixture(scope="module", params=SETUPS, ids=_setup_id)
def serve_setup(request):
    arch, impl = request.param
    jcfg, tcfg = config_pair(arch, "einsum", impl, window_size=32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jparams = {**jparams, "embed": {**jparams["embed"],
                                    "tok": jparams["embed"]["tok"] * 0.1}}
    model = build_model(tcfg, device="cpu")
    params = from_jax_params(numpy_tree(jparams), device="cpu")
    return tcfg, model, params, jmodel, jparams


def _greedy_reference(model, params, prompt, n_new):
    """Teacher-forced greedy continuation via full forwards (oracle)."""
    toks = list(prompt)
    for _ in range(n_new):
        with torch.no_grad():
            logits = model.forward_logits(params,
                                          {"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_engine_matches_teacher_forced_greedy(serve_setup):
    """Tokens equal teacher-forced greedy decoding, and the logits of every
    step equal the forward's at that position.  An MoE model runs with a
    capacity that drops nothing: the forward routes the whole sequence as
    one group, the engine the prompt and then each tick's slot tokens, so a
    capacity that drops pairs would drop different ones (as the reference
    would)."""
    cfg, model, params, _, _ = serve_setup
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9)]
    model = build_model(cfg, device="cpu")             # wrapped below
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    rows = record_logits(eng, model, "prefill", "decode_step")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    V = cfg.vocab_size
    for r in reqs:
        want = _greedy_reference(model, params, list(r.prompt), 6)
        assert r.output == want, (r.rid, r.output, want)
        toks = list(r.prompt) + r.output[:-1]
        with torch.no_grad():
            full = model.forward_logits(params, {"tokens": torch.tensor([toks])})
        got = np.stack(rows[r.rid])
        assert got.shape == (6, cfg.padded_vocab)
        assert_close(got[:, :V], full[0, len(r.prompt) - 1:, :V], TOL)


def test_engine_slot_recycling_more_requests_than_slots(serve_setup):
    cfg, model, params, _, _ = serve_setup
    rng = np.random.default_rng(1)
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=4)
                    .astype(np.int32), max_new_tokens=3) for i in range(5)]
    eng.run(reqs)
    assert all(r.finish_s is not None and len(r.output) == 3 for r in reqs)


def test_engine_with_ds3_arrival_process(serve_setup):
    """The paper's job generator drives serving arrivals."""
    cfg, model, params, _, _ = serve_setup
    trace = poisson_trace(rate_jobs_per_ms=0.2, num_jobs=4,
                          app_names=["llm"], seed=0)
    rng = np.random.default_rng(2)
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=4)
                    .astype(np.int32), max_new_tokens=2,
                    arrival_s=float(t) * 1e-6)      # us -> s (sped up)
            for i, t in enumerate(trace.arrival_us)]
    eng.run(reqs)
    assert all(r.latency_s is not None and r.latency_s >= 0 for r in reqs)


def test_engine_emits_the_jax_engines_tokens(serve_setup):
    """Five prompts of mixed lengths through two slots (so slots are recycled
    and decode at different positions; 40 > window 32 wraps the ring): the
    same tokens as the JAX engine, and the same logits at every prefill and
    decode step of every request.  The weights do not echo their input."""
    cfg, model, params, jmodel, jparams = serve_setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 40, 9, 3, 17)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    model = build_model(model.cfg, device="cpu")       # wrapped below
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    rows = record_logits(eng, model, "prefill", "decode_step")
    eng.run(reqs)
    jeng = JaxServeEngine(jmodel, jparams, num_slots=2, max_len=64)
    jrows = record_logits(jeng, jeng, "_prefill", "_decode")
    jeng.run(jreqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert eng.ticks == jeng.ticks
    V = cfg.vocab_size
    for r in reqs:
        got, want = np.stack(rows[r.rid]), np.stack(jrows[r.rid])
        assert got.shape == want.shape == (5, cfg.padded_vocab)
        assert_close(got[:, :V], want[:, :V], TOL)
    for p in prompts:
        with torch.no_grad():
            logits = model.forward_logits(params,
                                          {"tokens": torch.tensor(p[None])})
        echo = echo_share(logits[..., :V], p[None])
        assert echo < 0.5, (len(p), echo)


@pytest.mark.parametrize("impl", ["cuda", "einsum"])
def test_int8_engine_emits_the_jax_engines_tokens(impl):
    """gemma2-2b with the int8 KV cache through both engines: the cache's
    int8 and bf16-scale leaves go through slot admission unchanged; five
    prompts through two slots (40 > window 32 wraps the ring) give the JAX
    engine's tokens and its logits at every prefill and decode step, at the
    model's 1e-4 (see tests/test_torch_model.py's int8 test for why it
    holds)."""
    jcfg, tcfg = config_pair("gemma2-2b", "einsum", impl, window_size=32,
                             kv_cache_dtype="int8")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jparams = {**jparams, "embed": {**jparams["embed"],
                                    "tok": jparams["embed"]["tok"] * 0.1}}
    params = from_jax_params(numpy_tree(jparams), device="cpu")
    model = build_model(tcfg, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 40, 9, 3, 17)]
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    kv = eng.cache["stack"]["p0"]["kv"]
    assert kv["k"].dtype == torch.int8 and kv["v_scale"].dtype == torch.bfloat16
    rows = record_logits(eng, model, "prefill", "decode_step")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    jeng = JaxServeEngine(jmodel, jparams, num_slots=2, max_len=64)
    jrows = record_logits(jeng, jeng, "_prefill", "_decode")
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert eng.cache["stack"]["p0"]["kv"]["k"].dtype == torch.int8
    V = tcfg.vocab_size
    for r in reqs:
        got, want = np.stack(rows[r.rid]), np.stack(jrows[r.rid])
        assert got.shape == want.shape == (5, tcfg.padded_vocab)
        assert_close(got[:, :V], want[:, :V], TOL)
    with torch.no_grad():
        logits = model.forward_logits(params,
                                      {"tokens": torch.tensor(prompts[1][None])})
    assert echo_share(logits[..., :V], prompts[1][None]) < 0.5


def test_slots_decode_as_if_served_alone(serve_setup):
    """Four requests through four slots emit the tokens each emits through
    an engine of one slot.  An MoE tick routes its four slot tokens as one
    group, whose capacity (8) is at least the 4 pairs one expert can get,
    so no slot's token is dropped because of the others."""
    cfg, model, params, _, _ = serve_setup
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (7, 3, 12, 5)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    ServeEngine(model, params, num_slots=4, max_len=64, device="cpu").run(reqs)
    for r in reqs:
        alone = Request(rid=r.rid, prompt=r.prompt, max_new_tokens=6)
        ServeEngine(model, params, num_slots=1, max_len=64,
                    device="cpu").run([alone])
        assert r.output == alone.output, (r.rid, r.output, alone.output)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_cli_serves_the_moe_families(arch, capsys):
    from repro_torch.serving.__main__ import main
    main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
          "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"{arch} on cpu: 3 requests, 9 tokens" in out


def test_cli_refuses_the_front_end_families(capsys):
    """``python -m repro_torch.serving`` refuses paligemma-3b and
    seamless-m4t-large-v2 (the engine admits tokens only) with the way to
    drive them."""
    from repro_torch.serving.__main__ import main
    for arch in ("paligemma-3b", "seamless-m4t-large-v2"):
        with pytest.raises(SystemExit):
            main(["--arch", arch, "--reduced", "--device", "cpu"])
        assert "Model.prefill" in capsys.readouterr().err


def test_engine_stops_at_eos_and_at_max_len(serve_setup):
    cfg, model, params, _, _ = serve_setup
    prompt = np.arange(1, 6, dtype=np.int32)
    free = Request(rid=0, prompt=prompt, max_new_tokens=8)
    ServeEngine(model, params, num_slots=1, max_len=64, device="cpu").run([free])
    eos = free.output[2]
    first = free.output.index(eos)
    stopped = Request(rid=1, prompt=prompt, max_new_tokens=8)
    ServeEngine(model, params, num_slots=1, max_len=64, eos_id=eos,
                device="cpu").run([stopped])
    # the first token comes from prefill and is not checked, as in the reference
    assert stopped.output == free.output[:max(first, 1) + 1]
    capped = Request(rid=2, prompt=prompt, max_new_tokens=50)
    ServeEngine(model, params, num_slots=1, max_len=12, device="cpu").run([capped])
    assert len(prompt) + len(capped.output) - 1 == 12 - 1


def test_scatter_slot_stacked_and_tail_leaves():
    buf = torch.zeros(3, 4, 5)                       # (R, B, ...)
    new = torch.ones(3, 1, 5)
    out = _scatter_slot(buf, new, 2, stacked=True)
    assert out is buf and buf[:, 2].eq(1).all() and buf.sum() == 15
    tail = torch.zeros(4, 5)                         # (B, ...)
    _scatter_slot(tail, torch.ones(1, 5, dtype=torch.float64), 1, stacked=False)
    assert tail[1].eq(1).all() and tail.sum() == 5 and tail.dtype == torch.float32


def test_engine_default_device_raises_without_a_card(serve_setup):
    cfg, model, params, _, _ = serve_setup
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, num_slots=2, max_len=64)
