"""Oracle for the flash-attention kernel: full-materialization
grouped-query SDPA with causal / sliding-window masking and logit
softcap. Delegates to ``repro_torch.models.attention.sdpa_reference``
(one source of truth), as the JAX package's ``ref.py`` does."""
from __future__ import annotations

import torch

from repro_torch.models.attention import make_mask, sdpa_reference


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D)."""
    s = q.shape[1]
    mask = make_mask(s, s, causal=causal, window=window,
                     device=q.device)[None]
    return sdpa_reference(q, k, v, mask, softcap=softcap)
