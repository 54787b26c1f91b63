"""Oracle for the WKV6 kernel: the model's own chunked scan
(``repro_torch.models.rwkv.wkv_chunked``, one source of truth, as the
JAX package's ``ref.py``), and the token-by-token recurrence that
cross-checks both."""
from __future__ import annotations

import torch

from repro_torch.models.rwkv import wkv_chunked, wkv_recurrent_step


def wkv6(r, k, v, log_w, u, *, state0=None, chunk: int = 64):
    """r, k, v, log_w: (B, S, H, K); u: (H, K)."""
    return wkv_chunked(r, k, v, log_w, u, chunk=chunk, state0=state0)


def wkv6_stepwise(r, k, v, log_w, u, *, state0=None):
    """Token-by-token recurrence (ground truth for both implementations).
    Returns (out (B, S, H, K), state (B, H, K, K))."""
    b, s, h, dk = r.shape
    state = (torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=r.device) if state0 is None else state0)
    outs = []
    for t in range(s):
        out, state = wkv_recurrent_step(r[:, t], k[:, t], v[:, t],
                                        log_w[:, t], u, state)
        outs.append(out)
    return torch.stack(outs, dim=1), state
