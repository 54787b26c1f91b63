"""The rq4 codec of the flat gradient message, plainly: stochastic
rounding to 4-bit codes per bucket and back (the paper's quantizer,
Alistarh et al. QSGD-style bucketed min/max scaling), with the error
feedback residual around it.

The message is the gradient's leaves concatenated (``layout.flat_order``)
and cut into buckets of ``cap`` elements: ``cap`` is the bucket size
(4Mi elements) capped at the message and rounded up to a granule of
``pack * 512`` codes (two 4-bit codes a byte). Bucket b holds elements
[b cap, min((b + 1) cap, total)) and one (lo, scale) pair: lo and hi
its min and max, scale ``(hi - lo) * f32(1/15)`` (1 where hi == lo).
Its element i rounds x to ``floor(t) + [u_i < t - floor(t)]`` with
``t = (x - lo) / scale`` (a true fp32 division), clipped to [0, 15],
where u_i is the uniform of counter i under ``fold_in(key, b)``; it
decodes as ``code * scale + lo`` rounded once.
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry

BITS = 4
LEVELS = (1 << BITS) - 1
LANES = 512
BUCKET_ELEMS = 1 << 22


def geometry(total: int, bucket_elems: int = BUCKET_ELEMS
             ) -> tuple[int, int]:
    """(cap, n_buckets) of a message of ``total`` elements."""
    granule = (8 // BITS) * LANES
    cap = -(-min(bucket_elems, total) // granule) * granule
    return cap, -(-total // cap)


def qdq(flat: torch.Tensor, key: tuple[int, int], *,
        bucket_elems: int = BUCKET_ELEMS) -> torch.Tensor:
    """The quantized-dequantized message (a new fp32 tensor)."""
    total = flat.numel()
    cap, nb = geometry(total, bucket_elems)
    inv = float(np.float32(1.0 / LEVELS))
    out = torch.empty_like(flat)
    for b in range(nb):
        x = flat[b * cap:min((b + 1) * cap, total)]
        lo, hi = x.min(), x.max()
        scale = torch.where(hi > lo, (hi - lo) * inv, torch.ones_like(lo))
        u = threefry.uniform(threefry.fold_in(key, b), x.numel(),
                             x.device)
        t = (x - lo) / scale
        fl = torch.floor(t)
        code = torch.clamp(fl + (u < t - fl).float(), 0.0, float(LEVELS))
        out[b * cap:b * cap + x.numel()] = (
            code.double() * scale.double() + lo.double()).float()
    return out


def qdq_with_feedback(flat: torch.Tensor, residual: torch.Tensor,
                      key: tuple[int, int]) -> tuple:
    """(Q(g + e), the new residual g + e - Q(g + e))."""
    v = flat + residual
    q = qdq(v, key)
    return q, v - q
