"""Batched serving engine: prefill + greedy decode with slot-based
continuous batching.

The twin of ``src/repro/serving/engine.py``.  The engine keeps a fixed number
of batch *slots*; requests are admitted into free slots, prefilled, and
decoded step by step; finished slots are recycled.  Slots decode at their OWN
positions (the model's decode path takes a per-slot position vector).  A slot
that holds no request still decodes (token 0 at position 0 before its first
request, its last token and position after one) and its output is ignored, as
in the reference.  Request arrivals can be driven by the DS3 job generator
(``repro_torch.core.jobgen``).  The cache is any tree the model makes (K/V
caches, ring buffers, recurrent conv and SSM states): admission writes a
request's prefill cache into its slot leaf by leaf.

Each decode tick takes ONE argmax over the (slots, vocab) logits on the device
and one transfer of the token ids (the reference syncs once per active slot);
the tokens are the same.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import Model
from ..models.params import tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    # filled by the engine:
    output: Optional[List[int]] = None
    finish_s: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finish_s is None else self.finish_s - self.arrival_s


class ServeEngine:
    def __init__(self, model: Model, params, num_slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 device="cuda"):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = resolve_device(device)
        self.S = num_slots
        self.max_len = max_len
        self.eos = eos_id
        self.cache = model.init_cache(num_slots, max_len, self.device)
        self.pos = np.zeros(num_slots, dtype=np.int64)    # next write position
        self.active: List[Optional[Request]] = [None] * num_slots
        self.last_tok = np.zeros(num_slots, dtype=np.int64)
        self.ticks = 0
        self._t0 = 0.0

    # ---------------------------------------------------------------- admit
    @torch.no_grad()
    def _admit(self, req: Request, slot: int):
        tokens = torch.as_tensor(np.asarray(req.prompt, dtype=np.int64)[None, :],
                                 device=self.device)
        logits, cache1 = self.model.prefill(self.params, {"tokens": tokens},
                                            self.max_len)
        for part, stacked in (("stack", True), ("tail", False)):
            tree_map(lambda buf, new: _scatter_slot(buf, new, slot, stacked),
                     self.cache[part], cache1[part])
        self.pos[slot] = len(req.prompt)
        nxt = int(torch.argmax(logits[0, -1]))
        req.output = [nxt]
        self.last_tok[slot] = nxt
        self.active[slot] = req

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self):
        """One decode tick for all active slots (per-slot positions)."""
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return
        toks = torch.as_tensor(self.last_tok[:, None], device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)    # (S,) per-slot
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    toks, pos)
        self.ticks += 1
        # lint: waive TX001 -- the one sync a tick: the host needs the tokens
        nxt_all = torch.argmax(logits[:, -1], dim=-1).tolist()
        # engine-relative monotonic clock
        now = time.perf_counter() - self._t0
        for i in act:
            r = self.active[i]
            nxt = nxt_all[i]
            r.output.append(nxt)
            self.last_tok[i] = nxt
            self.pos[i] += 1
            done = (len(r.output) >= r.max_new_tokens
                    or (self.eos is not None and nxt == self.eos)
                    or self.pos[i] >= self.max_len - 1)
            if done:
                r.finish_s = now
                self.active[i] = None

    # ---------------------------------------------------------------- run
    def run(self, requests: List[Request]) -> List[Request]:
        """Process requests to completion (arrival-ordered admission)."""
        pending = sorted(requests, key=lambda r: r.arrival_s)
        t0 = time.perf_counter()
        self._t0 = t0
        while pending or any(r is not None for r in self.active):
            now = time.perf_counter() - t0
            for i in range(self.S):
                if self.active[i] is None and pending and \
                        pending[0].arrival_s <= now:
                    self._admit(pending.pop(0), i)
            if any(r is not None for r in self.active):
                self.step()
            elif pending:
                time.sleep(min(0.001, pending[0].arrival_s - now))
        return requests


def _scatter_slot(buf: torch.Tensor, new: torch.Tensor, slot: int,
                  stacked: bool) -> torch.Tensor:
    """Write request-cache ``new`` (batch=1) into slot ``slot`` of ``buf``,
    in place.

    Stacked leaves are (R, B, ...) vs new (R, 1, ...); tail leaves are
    (B, ...) vs (1, ...)."""
    if stacked:
        buf[:, slot] = new[:, 0].to(buf.dtype)
    else:
        buf[slot] = new[0].to(buf.dtype)
    return buf
