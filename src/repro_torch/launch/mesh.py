"""Production meshes, the rules that match them, and the card's figures.

The twin of ``src/repro/launch/mesh.py``.  The meshes are abstract
(:class:`~repro_torch.sharding.Mesh`: axis names and sizes, no devices): a
16×16 (data, model) pod, a 2×16×16 (pod, data, model) pair of pods, and the
degenerate (1, 1) host mesh.  On one card they describe layouts — the
dry-run's per-device bytes, the pipeline's stage count — and place nothing.

The roofline's hardware figures are an NVIDIA H100 SXM's data-sheet peaks
(dense bf16 on the tensor cores; HBM3), the figures ``PERF.md`` bounds every
kernel by.  ``chip_smoke.py`` phase 13 (c) measures the card's own matmul and
copy rates beside them.  The link figure, the roofline's collective term, is
the data sheet's NVLink rate: 900 GB/s a card in total, 450 GB/s each way.
It holds inside one 8-card NVLink domain only; the production meshes' 256 and
512 devices would span several, joined by a slower network.  A one-card
machine has no link, so it is not measured.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..sharding import Mesh, rules_multi_pod, rules_single_pod


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh() -> Mesh:
    """Degenerate 1-device mesh (every rule maps to nothing)."""
    return Mesh((1, 1), ("data", "model"))


def rules_for(mesh, *, batch_size: Optional[int] = None,
              kind: str = "train") -> Dict[str, object]:
    """Logical-axis rules matching a mesh; drops batch sharding when the
    global batch cannot be divided over the DP axes (e.g. long_500k B=1).

    ``kind='decode'`` uses the weight-stationary serving layout: batch
    activations replicate over the data axis while weights stay resident
    FSDP+TP-sharded; the KV cache keeps its own batch axis (``kv_batch``).
    ``kind='train_pp'`` on a mesh with ``pod``: the pod axis carries pipeline
    stages, so DP and FSDP stay inside a pod."""
    multi = "pod" in mesh.axis_names
    rules = rules_multi_pod() if multi else rules_single_pod()
    if kind == "decode":
        rules["batch"] = None
    elif kind == "train_pp" and multi:
        rules["batch"] = "data"
        rules["kv_batch"] = "data"
        rules["fsdp"] = "data"
    if batch_size is not None:
        dp = mesh.shape["data"] * (mesh.shape["pod"] if multi else 1)
        if batch_size % dp != 0:
            b = None if batch_size < dp else "data"
            if batch_size % mesh.shape["data"] != 0:
                b = None
            if kind != "decode":
                rules["batch"] = b
            rules["kv_batch"] = b
    # degenerate host mesh: keep annotations harmless
    if mesh.shape.get("model", 1) == 1 and mesh.shape.get("data", 1) == 1:
        rules = {k: None for k in rules}
    return rules


# Hardware figures for the roofline: NVIDIA H100 SXM5 80 GB data sheet -------
CARD = "NVIDIA H100 SXM5 80GB (data sheet)"
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
HBM_BYTES = 80e9                  # device memory, bytes
LINK_BW = 450e9                   # bytes/s each way, NVLink 4 (900 GB/s a
                                  # card in total); one 8-card domain only
