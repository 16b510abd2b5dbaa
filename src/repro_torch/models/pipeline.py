"""Pipeline parallelism: the GPipe schedule over the ``pod`` mesh axis.

The twin of ``src/repro/models/pipeline.py``, on one device.  The stacked
layer parameters' repeat axis is split into stages (stage s holds repeats
[s·R/P, (s+1)·R/P)), the batch into M microbatches, and the tick loop runs
M + P − 1 ticks in order: at tick t stage s applies its repeats to
microbatch t − s — the input microbatch for stage 0, the activation stage
s − 1 handed on at tick t − 1 otherwise — and the last stage's outputs are
collected in microbatch order.  The reference runs every stage on every tick
under a ``shard_map`` over ``pod`` and masks the bubble ticks' results out;
here a bubble tick is skipped, which gives the same result.  Autograd
differentiates through the schedule (the backward runs the ticks in
reverse).

Enabled via ``cfg.pipeline_stages > 1`` (``transformer.apply_stack``;
decoder stacks only, repeats % stages == 0).  The stage count comes from the
installed mesh's ``pod`` axis, and the batch must not be split over ``pod``:
see ``launch.mesh.rules_for(kind='train_pp')``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..sharding import current_mesh, logical_to_pspec, shard
from .params import tree_leaves, tree_map


def pipeline_stack(params_stack: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, one_repeat,
                   num_microbatches: int) -> torch.Tensor:
    """Run the stacked superblocks as a GPipe pipeline over ``pod``.

    ``one_repeat(x, param_slice) -> x`` applies one superblock (the body the
    plain stack uses).  Returns the stack output for the full batch."""
    mesh = current_mesh()
    if mesh is None or "pod" not in mesh.axis_names:
        raise ValueError("pipeline_stages > 1 needs a mesh with a 'pod' axis")
    stages = mesh.shape["pod"]
    reps = tree_leaves(params_stack)[0].shape[0]
    if reps % stages != 0:
        raise ValueError(f"repeats {reps} % stages {stages} != 0")
    B = x.shape[0]
    M = num_microbatches
    if B % M != 0:
        raise ValueError(f"batch {B} % microbatches {M} != 0")
    bspec = logical_to_pspec(["batch"])
    bax = bspec[0] if len(bspec) else None
    if bax == "pod" or (isinstance(bax, tuple) and "pod" in bax):
        raise ValueError("pipeline mode: batch must not shard over 'pod' "
                         "(use kind='train_pp')")

    per = reps // stages
    # the microbatches', the handed activations' and the outputs' batch
    # dimension on the data axis, as the reference pins its tick buffers
    baxes = [None, "batch"] + [None] * (x.ndim - 1)
    mb = shard(x.reshape(M, B // M, *x.shape[1:]), *baxes)

    def stage_fn(s: int, h: torch.Tensor) -> torch.Tensor:
        for r in range(s * per, (s + 1) * per):
            h = one_repeat(h, tree_map(lambda a: a[r], params_stack))
        return h

    handed = [None] * stages        # activation entering each stage
    outs = [None] * M
    for t in range(M + stages - 1):
        nxt = [None] * stages
        for s in range(stages):
            m = t - s
            if not 0 <= m < M:      # a bubble tick: nothing to compute
                continue
            y = stage_fn(s, mb[m] if s == 0 else handed[s])
            if s == stages - 1:
                outs[m] = y
            else:
                nxt[s + 1] = shard(y, *baxes[1:])
        handed = nxt
    return shard(torch.stack(outs), *baxes).reshape(B, *x.shape[1:])
