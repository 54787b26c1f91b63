"""The WKV6 entry point, in the model code's layout.

Public layout as the JAX package's ``ops.wkv6``: r, k, v, log_w
(B, S, H, K); u (H, K). The wrapper moves the heads before the sequence
(contiguous (B, H, S, K) tiles), pads S to the chunk with k = 0 and
log_w = 0 (a padded step is the identity on the state), calls
``kernel.wkv6_bhsk`` (K7 for CUDA tensors, the plain version for CPU
ones), and folds a nonzero entry state in afterwards in plain torch:
the kernel scans from S_0 = 0 and the recurrence is linear in the state.

The kernel is forward-only, like the Pallas kernel it replaces: the
call sits in a ``torch.autograd.Function`` whose backward raises
``NotImplementedError``, on both devices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import kernel

CHUNK = kernel.CHUNK


class _Forward(torch.autograd.Function):
    """The kernel call on (B, H, S, K) tensors; no backward pass."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, chunk):
        return kernel.wkv6_bhsk(r, k, v, log_w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the WKV6 kernel is forward-only (the JAX package's Pallas "
            "kernel has no backward pass either); an rwkv model trains "
            "through the chunked scan, which models.rwkv.wkv_scan_for "
            "picks whenever autograd records")


def wkv6(r, k, v, log_w, u, *, state0=None, chunk: int = CHUNK) -> tuple:
    """r, k, v, log_w: (B, S, H, K); u: (H, K); state0: optional
    (B, H, K, K). Returns (out (B, S, H, K) fp32, state (B, H, K, K))."""
    s = r.shape[1]
    pad = (-s) % chunk

    def prep(x):
        x = x.transpose(1, 2).float()                 # (B, H, S, K)
        return (F.pad(x, (0, 0, 0, pad)) if pad else x).contiguous()

    rp, kp, vp, lwp = prep(r), prep(k), prep(v), prep(log_w)
    out, state = _Forward.apply(rp, kp, vp, lwp, u.float().contiguous(),
                                chunk)
    if state0 is not None:
        # out_t += (r_t * prod_{s<t} w_s) @ S0; S += prod w * S0
        lw_cum = torch.cumsum(lwp, dim=2)
        q_in = rp * torch.exp(lw_cum - lwp)
        out = out + torch.einsum("bhsk,bhkv->bhsv", q_in, state0)
        state = state + torch.exp(lw_cum[:, :, -1])[..., None] * state0
    return out.transpose(1, 2)[:, :s], state
