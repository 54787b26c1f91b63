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
the batch to its device.

``make_batch_shapes`` / ``synthetic_batch`` describe and fill one
global batch of an assigned input shape (``models.common.INPUT_SHAPES``,
the dry-run's ``input_specs``): the shapes are ``meta`` tensors,
PyTorch's counterpart of ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models.common import InputShape, ModelConfig


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


def make_batch_shapes(cfg: ModelConfig, shape: InputShape, *,
                      dtype=torch.bfloat16) -> dict:
    """``meta`` tensors (shape and dtype only) for one global batch.

    train/prefill: full-sequence inputs (+ labels for train). decode:
    one new token per sequence (the KV state is separate)."""
    b, s = shape.global_batch, shape.seq_len

    def sd(size, dt):
        return torch.empty(size, dtype=dt, device="meta")

    batch: dict[str, Any] = {}
    if shape.kind == "decode":
        if cfg.frontend == "token":
            batch["tokens"] = sd((b, 1), torch.int32)
        else:
            batch["embeddings"] = sd((b, 1, cfg.d_model), dtype)
        return batch
    if cfg.frontend == "token":
        batch["tokens"] = sd((b, s), torch.int32)
    else:
        batch["embeddings"] = sd((b, s, cfg.d_model), dtype)
        if cfg.rope_variant == "mrope":
            batch["positions3"] = sd((b, 3, s), torch.int32)
    if cfg.is_encdec:
        # frame-embedding memory from the stub frontend (src len = s)
        batch["src_embeddings"] = sd((b, s, cfg.d_model), dtype)
    if shape.kind == "train":
        batch["labels"] = sd((b, s), torch.int32)
    return batch


def synthetic_batch(cfg: ModelConfig, shape: InputShape, key, *,
                    dtype=torch.bfloat16, device=None) -> dict:
    """A concrete random batch matching ``make_batch_shapes`` (smoke
    runs), on ``device`` (``cuda`` unless the caller asks for the CPU).

    Each input is drawn under ``fold_in(key, hash(name) % 2**31)``, as
    the JAX package draws it: integer inputs uniform in [0, vocab) for
    tokens and labels (else [0, seq_len)), float inputs ``normal * 0.02``
    in ``dtype``. Python salts ``str`` hashes per process, so a batch
    equals the JAX package's only within one process, and differs from
    one process to the next unless ``PYTHONHASHSEED`` is set: a property
    of the reference, kept."""
    dev = resolve_device(device)
    out = {}
    for name, sd in make_batch_shapes(cfg, shape, dtype=dtype).items():
        k = prng.fold_in(key, hash(name) % (2**31))
        if sd.dtype == torch.int32:
            hi = cfg.vocab if name in ("tokens", "labels") else shape.seq_len
            out[name] = prng.randint(k, sd.shape, 0, hi, device=dev)
        else:
            out[name] = (prng.normal(k, sd.shape, device=dev) * 0.02
                         ).to(sd.dtype)
    return out
