"""Synthetic instruction-tuning data — the port's copy of
``repro.data.synthetic`` (numpy only): in one process the port draws
the same prompts as the JAX package for the same domain, vocabulary and
seed (the domain's matrix is seeded from Python's per-process ``hash``).

Each domain has its own Markov transition matrix over the vocabulary,
so token sequences carry learnable structure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticDataset:
    domain: str
    vocab_size: int = 512
    seq_len: int = 64
    seed: int = 0
    branching: int = 7   # candidate next-tokens per token (lower=easier)

    def __post_init__(self):
        rng = np.random.default_rng(
            abs(hash((self.domain, self.seed))) % (2 ** 31))
        v, k = self.vocab_size, self.branching
        self.next_tokens = rng.integers(0, v, size=(v, k))
        self.next_probs = rng.dirichlet(np.ones(k) * 0.6, size=v)
        self._rng = np.random.default_rng(self.seed + 17)

    def sample_tokens(self, batch: int, rng: Optional[np.random.Generator]
                      = None) -> np.ndarray:
        rng = rng or self._rng
        out = np.zeros((batch, self.seq_len + 1), dtype=np.int32)
        out[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        for t in range(self.seq_len):
            cur = out[:, t]
            choice = np.array([
                rng.choice(self.next_tokens[c], p=self.next_probs[c])
                for c in cur])
            out[:, t + 1] = choice
        return out

    def batch(self, batch_size: int,
              rng: Optional[np.random.Generator] = None) -> Dict:
        """Training batch: tokens, next-token labels, mask."""
        toks = self.sample_tokens(batch_size, rng)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((batch_size, self.seq_len), np.float32),
        }
