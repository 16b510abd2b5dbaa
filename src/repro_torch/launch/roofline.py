"""Roofline analysis: the terms of each (arch × shape × mesh) from the dry-run.

The twin of ``src/repro/launch/roofline.py``, with an H100's figures:

    compute term    = counted_FLOPs_per_device / peak_FLOP/s        [s]
    memory term     = counted_bytes_per_device / HBM_bw             [s]
    collective term = collective_wire_bytes_per_device / LINK_BW    [s]

Sources: the port's dry-run records (``launch/dryrun.py``): FLOPs of the
matmul-like ops ``FlopCounterMode`` counts over the step on ``meta`` at full
depth, bytes each op reads and writes (the eager analogue of XLA's "bytes
accessed"), both divided by the mesh's devices (perfectly partitioned).
The wire bytes are the records' ``extrapolated.wire``: the step run as
DTensors over a fake process group of the mesh's size, each collective's
result bytes on rank 0 times the reference's ring factors.
MODEL_FLOPS (= 6·N_active·D analytics) / counted matmul FLOPs flags remat and
dispatch waste.  Hardware: ``launch/mesh.py`` — the H100 SXM data sheet's
989 TFLOP/s dense bf16, 3.35 TB/s HBM3 and 450 GB/s of NVLink each way
(one 8-card NVLink domain only; the table's header names the figure).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod16x16]
Writes ``experiments/roofline_torch.md`` and prints the table.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

from ..configs import ARCHITECTURES, SHAPES, get_config, get_shape
from ..models.transformer import stack_layout
from .dryrun import OUT_DIR
from .mesh import CARD, HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from .specs import SEAMLESS_PREFILL_PROMPT

MD_OUT = OUT_DIR.parent / "roofline_torch.md"


# ------------------------------------------------------------ analytic flops

def _matmul_params(cfg) -> Dict[str, float]:
    """Active matmul params per token, by component (MoE counts top-k only)."""
    D, H, KV, Dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    pat, reps, tail = stack_layout(cfg)
    blocks = list(pat) * reps + list(tail)
    attn_p = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
    if cfg.num_experts:
        mlp_p = (3 * D * cfg.moe_d_ff * cfg.top_k
                 + 3 * D * cfg.moe_d_ff * cfg.num_shared_experts
                 + D * cfg.num_experts)                     # router
    else:
        gated = cfg.act in ("silu", "geglu")
        mlp_p = (3 if gated else 2) * D * F
    mamba_p = 0.0
    if "mamba2" in blocks:
        Din, N = cfg.d_inner, cfg.ssm_state
        mamba_p = D * Din + D * (Din + 2 * N) + D * cfg.ssm_heads + Din * D
    rglru_p = 0.0
    if "rglru" in blocks:
        W = cfg.lru_width
        rglru_p = 2 * D * W + 2 * W * (W // max(cfg.num_heads, 1)) + W * D
    out = {"attn_proj": 0.0, "ffn": 0.0, "rec": 0.0, "enc": 0.0}
    for b in blocks:
        if b in ("global", "local", "enc", "xdec"):
            out["attn_proj"] += attn_p * (2 if b == "xdec" else 1)
            out["ffn"] += mlp_p
        elif b == "rglru":
            out["rec"] += rglru_p
            out["ffn"] += mlp_p
        elif b == "mamba2":
            out["rec"] += mamba_p
    if cfg.is_encoder_decoder:
        out["enc"] = (attn_p + mlp_p) * cfg.num_encoder_layers
    out["head"] = cfg.d_model * cfg.padded_vocab
    return out


def _attn_score_flops(cfg, S: int, kv_len: int, batch: int) -> float:
    """Softmax-path FLOPs (QK^T + PV) for one forward, all layers."""
    pat, reps, tail = stack_layout(cfg)
    blocks = list(pat) * reps + list(tail)
    H, Dh = cfg.num_heads, cfg.head_dim
    total = 0.0
    for b in blocks:
        if b in ("global", "xdec"):
            total += 4.0 * batch * S * kv_len * H * Dh
            if b == "xdec":
                total += 4.0 * batch * S * min(kv_len, 4096) * H * Dh
        elif b == "local":
            total += 4.0 * batch * S * min(cfg.window_size, kv_len) * H * Dh
    return total


def model_flops(arch: str, shape_name: str) -> float:
    """Global useful FLOPs per step: 6·N_active·tokens (+ attention)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    parts = _matmul_params(cfg)
    n_active = sum(parts.values())
    B, S = shape.global_batch, shape.seq_len
    H, Dh = cfg.num_heads, cfg.head_dim
    enc_attn = (4.0 * B * S * S * H * Dh * cfg.num_encoder_layers
                if cfg.is_encoder_decoder else 0.0)
    if shape.kind == "train":
        return (6.0 * n_active * B * S
                + 3.0 * (_attn_score_flops(cfg, S, S, B) + enc_attn))
    if shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            # encoder runs the full S frames; the decoder only prefills the
            # prompt (64 tokens) + cross-attends the encoder output
            DEC = SEAMLESS_PREFILL_PROMPT
            dec_p = n_active - parts["enc"] - parts["head"]
            attn = (enc_attn
                    + 4.0 * B * DEC * DEC * H * Dh * cfg.num_layers
                    + 4.0 * B * DEC * S * H * Dh * cfg.num_layers)
            return (2.0 * parts["enc"] * B * S + 2.0 * dec_p * B * DEC
                    + 2.0 * parts["head"] * B * DEC + attn)
        return 2.0 * n_active * B * S + _attn_score_flops(cfg, S, S, B)
    # decode: one token over a kv_len cache (the encoder does not run)
    dec_active = n_active - parts["enc"]
    return (2.0 * dec_active * B + _attn_score_flops(cfg, 1, S, B))


# ------------------------------------------------------------ table builder

def load_cell(arch: str, shape: str, mesh: str,
              out_dir: Optional[Path] = None) -> Optional[dict]:
    p = (OUT_DIR if out_dir is None else out_dir) / \
        f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def cell_terms(rec: dict) -> Optional[dict]:
    """Compute, memory and collective terms (s; the collective one at
    ``LINK_BW``), the dominant one, MODEL ÷ counted matmul FLOPs, and the
    per-device argument GB."""
    if not rec.get("runnable") or "extrapolated" not in rec:
        return None
    ex = rec["extrapolated"]
    nd = rec["num_devices"]
    t_c = ex["flops"] / PEAK_FLOPS_BF16
    t_m = ex["bytes"] / HBM_BW
    t_n = sum(ex["wire"].values()) / LINK_BW
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_n)),
              key=lambda kv: kv[1])[0]
    mf = model_flops(rec["arch"], rec["shape"]) / nd
    counted = max(ex["flops"], 1e-9)
    mem = rec.get("memory_analysis", {})
    hbm_gb = mem.get("argument_size_in_bytes", 0) / 1e9
    bound = max(t_c, t_m, t_n)
    return dict(t_compute=t_c, t_memory=t_m, t_collective=t_n, dominant=dom,
                model_flops_frac=mf / counted, hbm_gb=hbm_gb,
                roofline_frac=t_c / bound if bound > 0 else 0.0)


_ADVICE = {
    "compute": "compute-bound: cut redundant FLOPs (remat policy, causal-"
               "block skipping, MoE dispatch) or it is already near-roofline",
    "memory": "HBM-bound: raise arithmetic intensity — fuse attention into "
              "one hand-written kernel, int8/KV-cache quantisation, larger "
              "per-chunk tiles",
    "collective": "link-bound: reshard to cut all-gathers (bigger per-device "
                  "blocks), overlap collectives with compute, or compress "
                  "the gradient/activation wire format",
}


def build_table(mesh: str = "pod16x16", out_dir: Optional[Path] = None
                ) -> str:
    rows = []
    for arch in sorted(ARCHITECTURES):
        for shape in sorted(SHAPES):
            rec = load_cell(arch, shape, mesh, out_dir)
            if rec is None:
                continue
            if not rec.get("runnable"):
                rows.append((arch, shape, None, rec.get("skip_reason", "")))
                continue
            rows.append((arch, shape, cell_terms(rec), ""))

    md = [f"## Roofline — mesh {mesh} (per-device terms, seconds/step; "
          f"{CARD}: {PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM, {LINK_BW / 1e9:.0f} GB/s link "
          f"each way, one 8-card NVLink domain; FLOPs and bytes perfectly "
          f"partitioned, collectives of the partitioned step)\n",
          "| arch | shape | compute s | memory s | collective s | dominant |"
          " MODEL/counted matmul | args GB | next lever |",
          "|---|---|---|---|---|---|---|---|---|"]
    for arch, shape, t, skip in rows:
        if t is None:
            md.append(f"| {arch} | {shape} | — | — | — | skipped | — | — |"
                      f" {skip} |")
            continue
        md.append(
            f"| {arch} | {shape} | {t['t_compute']:.3e} | {t['t_memory']:.3e}"
            f" | {t['t_collective']:.3e} |"
            f" **{t['dominant']}** | {t['model_flops_frac']:.2f} |"
            f" {t['hbm_gb']:.1f} | {_ADVICE[t['dominant']]} |")
    return "\n".join(md) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    table = build_table(args.mesh)
    MD_OUT.parent.mkdir(parents=True, exist_ok=True)
    MD_OUT.write_text(table)
    print(table)
    print(f"written to {MD_OUT}")


if __name__ == "__main__":
    main()
