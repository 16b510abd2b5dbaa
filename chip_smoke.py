#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--verbose] [--profile]

Drives the port's main path — ``ServeEngine`` -> prefill -> decode for
gemma2-2b — through the entry points a user would call, and holds every CUDA
kernel of that path against its plain PyTorch version.  Needs one CUDA device;
without one it exits non-zero at once.  Imports ``repro_torch`` only (from
``src/`` beside this file), never ``jax`` or ``repro``.  Phases:

1. card    the ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build   the kernels, from the sources in this checkout (seconds printed);
3. kernels each wrapper vs its plain version on the card, at the shapes the
           main path gives it and at one small shape, bf16 (2e-2) and f32
           (2e-5); device times from CUDA-graph replays timed by CUDA events
           (and the time of one eager call from Python beside them); one
           library call (``scaled_dot_product_attention``, softcap and window
           off, used nowhere in the port) timed beside each as a yardstick;
4. reduced the reduced gemma2-2b in f32: engine output equals teacher-forced
           greedy decoding; first-step logits of the kernel path and the
           einsum path agree within 3e-2;
5. full    gemma2-2b at full width, all 26 layers, bf16, seeded random weights:
           8 requests with Poisson arrivals, 16 new tokens each, through a
           4-slot engine with an 8192-token cache.  The kernels' launch counts
           are set to 0 just before and read just after.

``--profile`` adds a second, instrumented pass of phase 5 after the measured
one: prefill and tick times by a host clock with a synchronise after each, and
``torch.profiler``'s device time by kernel.

A failure in any phase raises: the run exits non-zero and prints no result
line.  The last line of standard output is the result object; the line before
it describes the kernels; the card's name and power limit stand on their own
line before both.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
             "False); this script runs on the GPU only")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.jobgen import poisson_trace  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as k3  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

DEV = torch.device("cuda", 0)
# NVIDIA H100 SXM data sheet (dense rates): the peaks every bound is stated against
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PROMPT_LENS = [37, 128, 512, 1000, 2048, 5000, 64, 300]
NEW_TOKENS = 16


def log(msg: str):
    print(msg, flush=True)


def eager_ms(fn, iters: int = 10, warm: int = 2) -> float:
    """Median milliseconds of one ``fn()`` called from Python, by CUDA events.
    Where the device finishes before the host has issued the next call, this
    is the host's time per call, not the device's."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fns, rounds: int = 3, reps: int = 5) -> float:
    """Median device milliseconds of one call: ``rounds`` passes over the
    closures ``fns`` are captured into one CUDA graph and replayed, so no host
    time lies between the launches.  Several closures on different buffers
    keep a call from finding its inputs in the 50 MB L2 left by the last."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / (rounds * len(fns)))
    del graph
    return statistics.median(times)


def compare(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol·|want| everywhere."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)} or non-finite output")
    err = (g - w).abs()
    if bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3e} "
                             f"exceeds tolerance {tol}")
    return float(err.max())


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV,
                       dtype=torch.float32).to(dtype)


# ------------------------------------------------------------------ phase 1-2

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0 of {torch.cuda.device_count()}: "
        f"{torch.cuda.get_device_name(0)}")
    log(smi)
    return smi


def phase_build(verbose: bool):
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[build] {nvcc[-2].strip()} ({nvcc[-1].strip()}), "
        f"flags {' '.join(_build.NVCC_FLAGS)}")
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=verbose)
    for name in libs:
        _build.load(name)
    log(f"[build] {len(libs)} CUDA sources ({', '.join(sorted(libs))}) built "
        f"and loaded in {time.perf_counter() - t0:.1f} s into "
        f"{_build.build_dir()}")


# ------------------------------------------------------------------ phase 3

def keys_attended(S: int, window) -> int:
    r = np.arange(1, S + 1, dtype=np.int64)
    return int((np.minimum(r, window) if window else r).sum())


def flash_bound_ms(B, H, KV, S, Dh, window, dtype):
    """(ms, 'bytes'|'operations'): the larger of Q,K,V read + O written once
    over the memory rate and 4·B·H·Dh·Σ_rows(keys attended) FLOP over the peak
    rate of the input type (bf16: tensor cores; f32: CUDA cores)."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * H * Dh + 2 * B * S * KV * Dh) * item
    flops = 4 * B * H * Dh * keys_attended(S, window)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def decode_bound_ms(B, H, KV, L, Dh, valid, dtype):
    """As above for one decode call.  Only valid slots need reading, so the
    bytes are this run's: 2·(valid keys)·KV·Dh K/V elements, q, the output and
    the (B,L) mask."""
    item = torch.finfo(dtype).bits // 8
    nvalid = int(valid.sum())
    nbytes = 2 * nvalid * KV * Dh * item + 2 * B * H * Dh * item + B * L
    flops = 4 * H * Dh * nvalid
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def sdpa_causal(q, k, v, scale):
    """The library yardstick for K2: (B,S,H,Dh) in and out, GQA, causal; no
    softcap and no window (the library call has neither)."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=scale, enable_gqa=True)
    return o.transpose(1, 2)


def sdpa_decode(q, k, v, valid, scale):
    """The library yardstick for K3: boolean mask, GQA; no softcap."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], scale=scale, enable_gqa=True)
    return o.transpose(1, 2)


def phase_flash(gen):
    """K2 vs plain.  Returns the `kernels` entry, timed at the path's heaviest
    prefill (S=5000, bf16, global layer)."""
    B, H, KV, Dh = 1, 8, 4, 256
    scale = Dh ** -0.5
    cases = [(B, S, H, KV, Dh, w, 50.0) for S in (37, 1000, 5000)
             for w in (None, 4096)]
    cases.append((2, 100, 4, 2, 16, 32, 50.0))      # the reduced config's shape
    cases.append((2, 100, 4, 2, 16, None, None))
    # the other head dims and head groupings the supported configs use
    cases.append((1, 200, 8, 2, 128, None, None))   # 4 query heads per KV head
    cases.append((1, 150, 9, 1, 64, 64, 30.0))      # 9 per KV head (MQA-like)
    cases.append((2, 70, 2, 2, 32, None, None))     # MHA
    entry = {}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (b, S, h, kv, dh, window, softcap) in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(gen, (b, S, h, dh), dtype)
            k = randn(gen, (b, S, kv, dh), dtype)
            v = randn(gen, (b, S, kv, dh), dtype)
            kw = dict(causal=True, window=window, softcap=softcap,
                      scale=dh ** -0.5)
            out = k2.flash_attention(q, k, v, **kw)
            want = k2.flash_attention_plain(q, k, v, **kw)
            what = (f"flash_attention B={b} S={S} H={h} KV={kv} Dh={dh} "
                    f"window={window} softcap={softcap} "
                    f"{str(dtype).split('.')[-1]}")
            err = compare(out, want, TOL[dtype], what)
            errs[dtype] = max(errs[dtype], err)
            del want
            line = f"[kernels] {what}: max_abs_err {err:.3e}"
            if dh == Dh:
                ms = device_ms([lambda: k2.flash_attention(q, k, v, **kw)])
                eager = eager_ms(lambda: k2.flash_attention(q, k, v, **kw))
                plain = device_ms(
                    [lambda: k2.flash_attention_plain(q, k, v, **kw)], rounds=2)
                bound, by = flash_bound_ms(b, h, kv, S, dh, window, dtype)
                line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                         f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by})")
                if S == 5000 and window is None and dtype == torch.bfloat16:
                    lib = device_ms([lambda: sdpa_causal(q, k, v, scale)])
                    line += f", library {lib:.4f} ms"
                    entry = {"shape": f"B={b} S={S} H={h} KV={kv} Dh={dh} bf16 "
                                      "causal softcap=50 window=None",
                             "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib}
            log(line)
    entry["max_abs_err_f32_all_cases"] = errs[torch.float32]
    entry["max_abs_err_bf16_all_cases"] = errs[torch.bfloat16]
    return entry


def full_valid(L, pos):
    idx = torch.arange(L, device=DEV)[None, :]
    return idx <= torch.tensor(pos, device=DEV)[:, None]


def ring_valid(L, window, pos):
    """The ring-buffer mask of models/attention.py for per-slot positions."""
    posb = torch.tensor(pos, device=DEV)[:, None]
    idx = torch.arange(L, device=DEV)[None, :]
    slot_pos = posb - torch.remainder(torch.remainder(posb, L) - idx, L)
    return (slot_pos >= 0) & (slot_pos > posb - window)


def phase_decode(gen):
    """K3 vs plain.  Returns the `kernels` entry, timed at a global layer's
    decode tick (B=4, L=8192, bf16, four different positions)."""
    B, H, KV, Dh = 4, 8, 4, 256
    scale = Dh ** -0.5
    cases = [
        ("full L=8192", B, 8192, H, KV, Dh, full_valid(8192, [5015, 2063, 1015, 315]), 50.0),
        ("full L=8192 at the brim", B, 8192, H, KV, Dh, full_valid(8192, [8190, 8191, 0, 4096]), 50.0),
        ("ring L=4096", B, 4096, H, KV, Dh, ring_valid(4096, 4096, [5015, 9000, 4096, 315]), 50.0),
        ("small full", 2, 64, 4, 2, 16, full_valid(64, [10, 63]), 50.0),
        ("small ring, one slot empty", 2, 32, 4, 2, 16,
         ring_valid(32, 32, [40, 7]) & torch.tensor([[True], [False]], device=DEV), None),
        # the other head dims and head groupings the supported configs use
        ("4 heads per KV head", 2, 300, 8, 2, 128, full_valid(300, [299, 130]), None),
        ("9 heads per KV head", 1, 200, 9, 1, 64, full_valid(200, [150]), 30.0),
        ("MHA", 2, 129, 2, 2, 32, full_valid(129, [128, 5]), None),
    ]
    entry = {}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (name, b, L, h, kv, dh, valid, softcap) in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(gen, (b, 1, h, dh), dtype)
            k = randn(gen, (b, L, kv, dh), dtype)
            v = randn(gen, (b, L, kv, dh), dtype)
            kw = dict(softcap=softcap, scale=dh ** -0.5)
            out = k3.decode_attention(q, k, v, valid, **kw)
            want = k3.decode_attention_plain(q, k, v, valid, **kw)
            what = (f"decode_attention {name} B={b} L={L} H={h} KV={kv} "
                    f"Dh={dh} valid={int(valid.sum())} "
                    f"{str(dtype).split('.')[-1]}")
            err = compare(out, want, TOL[dtype], what)
            errs[dtype] = max(errs[dtype], err)
            line = f"[kernels] {what}: max_abs_err {err:.3e}"
            if dh == Dh:
                # the caller finds the cache cold (26 layers of caches and
                # weights pass between two ticks of one layer): time over
                # several copies of K/V, more than the L2 holds
                sets = [(k, v)] + [(k.clone(), v.clone()) for _ in range(5)]

                def calls(fn):
                    return [lambda kk=kk, vv=vv: fn(q, kk, vv, valid, **kw)
                            for kk, vv in sets]
                ms = device_ms(calls(k3.decode_attention))
                eager = eager_ms(lambda: k3.decode_attention(q, k, v, valid, **kw))
                plain = device_ms(calls(k3.decode_attention_plain), rounds=1)
                bound, by = decode_bound_ms(b, h, kv, L, dh, valid, dtype)
                line += (f", kernel {ms:.4f} ms (eager call {eager:.4f} ms), "
                         f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by})")
                if name == "full L=8192" and dtype == torch.bfloat16:
                    lib = device_ms(calls(
                        lambda q, kk, vv, valid, **kw:
                        sdpa_decode(q, kk, vv, valid, scale)))
                    line += f", library {lib:.4f} ms"
                    entry = {"shape": f"B={b} L={L} H={h} KV={kv} Dh={dh} bf16 "
                                      f"softcap=50 valid keys={int(valid.sum())}",
                             "max_abs_err": err, "ms": ms, "eager_call_ms": eager,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib}
                del sets
            log(line)
    entry["max_abs_err_f32_all_cases"] = errs[torch.float32]
    entry["max_abs_err_bf16_all_cases"] = errs[torch.bfloat16]
    return entry


# ------------------------------------------------------------------ phase 4

def greedy_reference(model, params, prompt, n_new):
    """Teacher-forced greedy continuation via full forwards (the oracle)."""
    toks = list(int(t) for t in prompt)
    for _ in range(n_new):
        logits = model.forward_logits(
            params, {"tokens": torch.tensor([toks], device=DEV)})
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


@torch.no_grad()
def phase_reduced():
    cfg = reduced(get_config("gemma2-2b")).replace(window_size=32)
    assert cfg.attn_impl == "cuda" and cfg.dtype == "float32"
    model = build_model(cfg, device=DEV)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9)]
    before = (k2.launches, k3.launches)
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device=DEV)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    if k2.launches == before[0] or k3.launches == before[1]:
        raise AssertionError("reduced engine did not go through the kernels")
    for r in reqs:
        want = greedy_reference(model, params, r.prompt, 6)
        if r.output != want:
            raise AssertionError(f"reduced engine req {r.rid}: {r.output} != "
                                 f"teacher-forced greedy {want}")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48))).to(DEV)
    a = model.forward_logits(params, {"tokens": tokens})
    b = build_model(cfg.replace(attn_impl="einsum"), device=DEV) \
        .forward_logits(params, {"tokens": tokens})
    err = compare(a, b, 3e-2, "reduced forward_logits cuda vs einsum")
    log(f"[reduced] engine == teacher-forced greedy for {len(reqs)} requests "
        f"({eng.ticks} ticks); logits cuda vs einsum max_abs_err {err:.3e}")


# ------------------------------------------------------------------ phase 5

def make_requests(cfg):
    trace = poisson_trace(rate_jobs_per_ms=0.5, num_jobs=len(PROMPT_LENS),
                          app_names=["chat"], seed=0)
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=n,
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=NEW_TOKENS, arrival_s=float(t) * 1e-6)
            for i, (n, t) in enumerate(zip(PROMPT_LENS, trace.arrival_us))]


def profile_serve(model, params, cfg, smi: str):
    """The serve of phase 5 twice more, instrumented (not the measured run):
    once with a host clock and a synchronise around every prefill and tick,
    once under ``torch.profiler`` for the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(model, params, num_slots=4, max_len=8192, device=DEV)
    spans = {"prefill": [], "tick": []}

    def timed(kind, fn, label):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spans[kind].append((label(*args), time.perf_counter() - t0))
            return out
        return run
    eng._admit = timed("prefill", eng._admit, lambda req, slot: len(req.prompt))
    eng.step = timed("tick", eng.step, lambda: None)
    t0 = time.perf_counter()
    eng.run(make_requests(cfg))
    wall = time.perf_counter() - t0
    pre = ", ".join(f"{n}: {1e3 * t:.1f}" for n, t in sorted(spans["prefill"]))
    ticks = [t for _, t in spans["tick"]]
    log(f"[profile] synchronised serve {wall:.3f} s; prefill ms by prompt "
        f"length {{{pre}}} (sum {1e3 * sum(t for _, t in spans['prefill']):.1f}); "
        f"{len(ticks)} ticks, median {1e3 * statistics.median(ticks):.2f} ms, "
        f"sum {1e3 * sum(ticks):.1f} ms  [{smi}]")

    eng = ServeEngine(model, params, num_slots=4, max_len=8192, device=DEV)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run(make_requests(cfg))
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows)
    log(f"[profile] device time by kernel under torch.profiler, "
        f"total {busy / 1e3:.1f} ms")
    for e in rows[:14]:
        if dev_us(e) > 0:
            log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


@torch.no_grad()
def phase_full(smi: str, with_profile: bool = False):
    cfg = get_config("gemma2-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.dtype, cfg.attn_impl) == \
        (26, 2304, "bfloat16", "cuda")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[full] gemma2-2b: {model.param_count() / 1e9:.3f} G parameters, "
        f"{cfg.num_layers} layers, bf16, init {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(model, params, num_slots=4, max_len=8192, device=DEV)

    # warm-up outside the measured run: library handles, allocator pools
    warm = torch.zeros((1, 64), dtype=torch.int64, device=DEV)
    _, wcache = model.prefill(params, {"tokens": warm}, 128)
    model.decode_step(params, wcache, warm[:, :1], 64)
    del wcache
    torch.cuda.synchronize()

    reqs = make_requests(cfg)

    k2.launches = k3.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": k2.launches, "decode_attention": k3.launches}

    for r in reqs:
        if r.finish_s is None or len(r.output) != NEW_TOKENS or \
                not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"full-width req {r.rid}: output {r.output}")
    want = {"flash_attention": len(reqs) * cfg.num_layers,
            "decode_attention": eng.ticks * cfg.num_layers}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # logits of the path are finite (after the counts are read)
    toks = torch.from_numpy(reqs[0].prompt.astype(np.int64))[None].to(DEV)
    logits, cache = model.prefill(params, {"tokens": toks}, 8192)
    step, _ = model.decode_step(params, cache, toks[:, :1], toks.shape[1])
    if logits.shape != (1, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all() & torch.isfinite(step).all()):
        raise AssertionError("full-width logits: wrong shape or not finite")

    toks_out = sum(len(r.output) for r in reqs)
    lats = [r.latency_s for r in reqs]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[full] {len(reqs)} requests (prompts {PROMPT_LENS}), {toks_out} new "
        f"tokens in {wall:.3f} s = {toks_out / wall:.2f} tok/s, "
        f"{eng.ticks} decode ticks, latency p50 {np.percentile(lats, 50):.3f} s "
        f"p95 {np.percentile(lats, 95):.3f} s, peak memory {peak:.2f} GiB, "
        f"launches {launches}  [{smi}]")
    if with_profile:
        profile_serve(model, params, cfg, smi)
    return launches


# ------------------------------------------------------------------ main

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--verbose", action="store_true",
                    help="print the compiler's per-kernel resource usage")
    ap.add_argument("--profile", action="store_true",
                    help="add an instrumented second pass of the full serve")
    args = ap.parse_args()
    t_start = time.perf_counter()
    torch.cuda.set_device(DEV)

    smi = phase_card()
    phase_build(args.verbose)
    gen = torch.Generator(device=DEV).manual_seed(0)
    flash = phase_flash(gen)
    decode = phase_decode(gen)
    torch.cuda.empty_cache()
    phase_reduced()
    launches = phase_full(smi, args.profile)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:82",
         "launches": launches["flash_attention"], **flash},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:62",
         "launches": launches["decode_attention"], **decode},
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
