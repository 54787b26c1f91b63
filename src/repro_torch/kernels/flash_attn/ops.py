"""The flash-attention entry point, in the model code's layout.

Public layout as the JAX package's ``ops.flash_attention``: q
(B, S, Hq, D); k, v (B, S, Hkv, D). The wrapper moves the heads before
the sequence (contiguous (B, H, S, D) tiles), picks the blocks and pads
S to a block multiple as the JAX wrapper does, and calls
``kernel.flash_attention_bhsd`` (K6 for CUDA tensors, the plain version
for CPU ones).

The call is a ``torch.autograd.Function`` with a backward pass, which
the JAX package's Pallas kernel lacks (its training differentiates the
plain attention instead): when autograd records the call, the forward
also keeps the row log-sum-exp and saves q, k, v, out and it, and the
backward runs ``kernel.flash_attention_bwd_bhsd`` (K6b on the card,
its plain version on the CPU) inside a ``flash_attn.backward`` span.
A call that autograd does not record (no grad mode, or no input that
requires grad) saves nothing and launches K6 as a prefill does. The
backward covers no logit softcap, and on the card only fp32 at head dim
64 or 128 (``covers_backward``): a gradient through any other call
raises ``NotImplementedError``, which saves nothing either, as does a
gradient through a call with its own ``scale`` or a v head dim other
than q's (multi-head latent attention's K6 at (192, 128)).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import kernel
from repro_torch.obs import flight as obs_flight

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 128


def covers_backward(q: torch.Tensor, softcap: float) -> bool:
    """Whether the backward covers a call on q: no logit softcap, and on
    the card fp32 at a head dim in ``kernel.BACKWARD_HEAD_DIMS``."""
    return not softcap > 0 and (
        not q.is_cuda or (q.dtype == torch.float32
                          and q.shape[-1] in kernel.BACKWARD_HEAD_DIMS))


class _Attention(torch.autograd.Function):
    """The kernel call on (B, H, S, D) tensors, and its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kw, record):
        ctx.covered = (record and covers_backward(q, kw["softcap"])
                       and kw["scale"] is None
                       and v.shape[-1] == q.shape[-1])
        if not ctx.covered:
            return kernel.flash_attention_bhsd(q, k, v, **kw)
        out, lse = kernel.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        if not ctx.covered:
            raise NotImplementedError(
                "flash attention's backward covers no logit softcap, and "
                "on the card only float32 at head_dim in "
                f"{kernel.BACKWARD_HEAD_DIMS}, the default scale and v at "
                "q's head dim; train with use_flash=False")
        kw = ctx.kw
        q, k, v, out, lse = ctx.saved_tensors
        with obs_flight.kernel_scope("flash_attn.backward"):
            dq, dk, dv = kernel.flash_attention_bwd_bhsd(
                q, k, v, out, dout.contiguous(), lse, causal=kw["causal"],
                window=kw["window"], s_valid=kw["s_valid"])
        return dq, dk, dv, None, None


@obs_flight.kernel_annotation("flash_attn.forward")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    skip: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, S, Hq, D); k (B, S, Hkv, D), v (B, S, Hkv, DV) ->
    (B, S, Hq, DV). ``skip=False`` runs every (q-block, k-block) tile,
    masking inside it — the non-skipping baseline, bit-identical to
    ``skip=True``. ``scale``: the softmax scale (1/sqrt(D) when None)."""
    b, s, hq, d = q.shape
    block_q = min(block_q, max(8, 1 << (s - 1).bit_length()))
    block_k = min(block_k, block_q)
    pad = (-s) % max(block_q, block_k)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if pad:
        qt, kt, vt = (F.pad(t, (0, 0, 0, pad)) for t in (qt, kt, vt))
    kw = dict(causal=causal, window=window, softcap=softcap,
              block_q=block_q, block_k=block_k, s_valid=s, skip=skip,
              scale=scale)
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    out = _Attention.apply(qt.contiguous(), kt.contiguous(),
                           vt.contiguous(), kw, record)
    out = out.transpose(1, 2)
    return out[:, :s] if pad else out
