"""The port's serving engine: the twins of the serving tests of
tests/test_train_and_serve.py, and the same tokens as the JAX ``ServeEngine``
on the same prompts from converted weights."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import config_pair, numpy_tree
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.core import poisson_trace
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.engine import _scatter_slot

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["cuda", "einsum"])
def serve_setup(request):
    jcfg, tcfg = config_pair("gemma2-2b", "einsum", request.param,
                             window_size=32)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
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
    cfg, model, params, _, _ = serve_setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9)]
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    for r in reqs:
        want = _greedy_reference(model, params, list(r.prompt), 6)
        assert r.output == want, (r.rid, r.output, want)


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
    and decode at different positions; 40 > window 32 wraps the ring)."""
    cfg, model, params, jmodel, jparams = serve_setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 40, 9, 3, 17)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    eng.run(reqs)
    jeng = JaxServeEngine(jmodel, jparams, num_slots=2, max_len=64)
    jeng.run(jreqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert eng.ticks == jeng.ticks


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
