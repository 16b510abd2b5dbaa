"""Deterministic synthetic LM data pipeline.

The twin of ``src/repro/data/pipeline.py``, numpy only and copied (the port
imports nothing of ``repro``): its batches equal the reference's array for
array, so a data state in a checkpoint means the same in both packages.

Production properties the trainer relies on:

* **Stateless addressing** — ``batch_at(step)`` is a pure function of
  (seed, step), so a restart resumes mid-epoch with zero drift and no
  replayed/skipped batches (the data state in a checkpoint is just
  ``{seed, step}``).
* **Host sharding** — each host materialises only its slice of the global
  batch (``host_index/host_count``), matching multi-host input loading.
* **Learnable structure** — tokens follow a Zipf marginal with a first-order
  Markov mixing kernel, so cross-entropy has headroom below uniform and a
  real model trains visibly in a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> Dict:
        return {"seed": int(self.seed), "step": int(self.step)}

    @classmethod
    def from_dict(cls, d: Dict) -> "DataState":
        return cls(int(d["seed"]), int(d["step"]))


class SyntheticLMPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 zipf_a: float = 1.2, markov_weight: float = 0.7):
        assert batch % host_count == 0
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.host_index = host_index
        self.host_count = host_count
        self.state = DataState(seed, 0)
        self.markov_weight = markov_weight
        # Zipf marginal over the vocab (heavy head, long tail)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._probs = p / p.sum()

    # -- pure addressing ----------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global-batch slice for this host at ``step`` (pure function)."""
        per_host = self.batch // self.host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step, self.host_index]))
        base = rng.choice(self.vocab, size=(per_host, self.seq + 1),
                          p=self._probs)
        # first-order Markov structure: with prob w, next token is a
        # deterministic mix of the previous one (learnable transitions)
        mix = rng.random((per_host, self.seq + 1)) < self.markov_weight
        shifted = (base[:, :-1] * 31 + 17) % self.vocab
        tokens = base.copy()
        tokens[:, 1:] = np.where(mix[:, 1:], shifted, base[:, 1:])
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    # -- iterator protocol ---------------------------------------------------
    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # -- checkpointing --------------------------------------------------------
    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def load_state_dict(self, d: Dict) -> None:
        self.state = DataState.from_dict(d)
