"""Step factories: the serving pair (``make_serve_step``,
``make_bulk_prefill``).

The port of ``repro.train.steps``' serving step factories. Training steps
(``make_train_step`` with the flat codec, error feedback and AdamW) and
the full-sequence ``make_prefill_step`` come with the training slice.
Only the scanned layout (``transformer_scan``) exists in the port: the
factories are the JAX package's ``scan_layers=True`` ones.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer_scan
from repro_torch.models.common import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """decode: (params, decode_state, inputs) -> (next_token_logits,
    state). The state is updated in place."""

    def serve_step(params, decode_state, inputs):
        logits, state = transformer_scan.decode_step(params, cfg, inputs,
                                                     decode_state)
        return logits[:, -1], state

    return serve_step


def make_bulk_prefill(cfg: ModelConfig):
    """Bulk cache fill: (params, decode_state, tokens (B, S)) ->
    (last_logits (B, V), filled decode_state).

    A loop of ``decode_step`` over the prompt positions — the JAX
    package's ``lax.scan`` of the same step — so the filled cache and
    the logits are bit-identical to feeding the tokens one at a time,
    by construction."""
    if cfg.frontend != "token":
        raise ValueError(
            f"bulk prefill needs a token frontend, got '{cfg.frontend}'")

    def bulk_prefill(params, decode_state, tokens: torch.Tensor):
        logits = None
        for i in range(tokens.shape[1]):
            logits, decode_state = transformer_scan.decode_step(
                params, cfg, {"tokens": tokens[:, i:i + 1]}, decode_state)
        return logits[:, -1], decode_state

    return bulk_prefill
