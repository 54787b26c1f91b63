"""Deterministic synthetic data: the bigram-chain language model.

The port of ``repro.data.pipeline.SyntheticLM``. Real corpora are not
available offline, so the trainer learns a fixed random bigram table:
each token prefers ~8 successors, with 5 % noise tokens, so losses fall
measurably within a few hundred steps.

``batch_at(step)`` gives the JAX package's tokens and labels, bit for
bit: the successor table comes from the same ``np.random.default_rng``
draw and every random choice from the port's threefry (``core.prng``),
which draws ``jax.random``'s bits. The successor chain is a sequential
gather over the sequence, so it is built on the CPU; the caller moves
the batch to its device. ``make_batch_shapes`` / ``synthetic_batch``
(the dry-run shapes) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng


@dataclasses.dataclass
class SyntheticLM:
    """Bigram-chain synthetic language model data."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    order_temp: float = 1.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish bigram preference: each token prefers ~8 successors
        self.n_succ = 8
        self.succ = torch.from_numpy(
            rng.integers(0, self.vocab,
                         size=(self.vocab, self.n_succ)).astype(np.int32))

    def batch_at(self, step: int, key: Optional[torch.Tensor] = None
                 ) -> dict:
        """{"tokens", "labels"}: (batch, seq_len - 1) int32 CPU tensors."""
        key = key if key is not None else prng.PRNGKey(self.seed)
        k = prng.fold_in(key, step)
        k1, k2, k3 = prng.split(k, 3)
        first = prng.randint(k1, (self.batch,), 0, self.vocab)
        choices = prng.randint(k2, (self.batch, self.seq_len), 0,
                               self.n_succ)
        noise = prng.bernoulli(k3, 0.05, (self.batch, self.seq_len))
        rand_tok = prng.randint(prng.fold_in(k3, 1),
                                (self.batch, self.seq_len), 0, self.vocab)
        succ = self.succ.long()
        seq = torch.empty((self.batch, self.seq_len), dtype=torch.int32)
        tok = first.long()
        for t in range(self.seq_len):
            nxt = succ[tok, choices[:, t].long()]
            nxt = torch.where(noise[:, t], rand_tok[:, t].long(), nxt)
            seq[:, t] = nxt
            tok = nxt
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
