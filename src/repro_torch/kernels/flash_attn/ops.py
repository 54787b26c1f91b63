"""The flash-attention entry point, in the model code's layout.

Public layout as the JAX package's ``ops.flash_attention``: q
(B, S, Hq, D); k, v (B, S, Hkv, D). The wrapper moves the heads before
the sequence (contiguous (B, H, S, D) tiles), picks the blocks and pads
S to a block multiple as the JAX wrapper does, and calls
``kernel.flash_attention_bhsd`` (K6 for CUDA tensors, the plain version
for CPU ones).

The kernel is forward-only, like the Pallas kernel it replaces: the
call sits in a ``torch.autograd.Function`` whose backward raises
``NotImplementedError``, on both devices. Without it a K6 launch would
return a tensor with no ``grad_fn`` (gradients upstream of it silently
missing), and the CPU plain version would give gradients the JAX
package refuses to give.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import kernel
from repro_torch.obs import flight as obs_flight

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 128


class _Forward(torch.autograd.Function):
    """The kernel call on (B, H, S, D) tensors; no backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        return kernel.flash_attention_bhsd(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash attention is forward-only (the JAX package's Pallas "
            "kernel has no backward pass either); train with "
            "use_flash=False")


@obs_flight.kernel_annotation("flash_attn.forward")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    skip: bool = True) -> torch.Tensor:
    """q (B, S, Hq, D); k, v (B, S, Hkv, D) -> (B, S, Hq, D).
    ``skip=False`` runs every (q-block, k-block) tile, masking inside
    it — the non-skipping baseline, bit-identical to ``skip=True``."""
    b, s, hq, d = q.shape
    block_q = min(block_q, max(8, 1 << (s - 1).bit_length()))
    block_k = min(block_k, block_q)
    pad = (-s) % max(block_q, block_k)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if pad:
        qt, kt, vt = (F.pad(t, (0, 0, 0, pad)) for t in (qt, kt, vt))
    kw = dict(causal=causal, window=window, softcap=softcap,
              block_q=block_q, block_k=block_k, s_valid=s, skip=skip)
    out = _Forward.apply(qt.contiguous(), kt.contiguous(), vt.contiguous(),
                         kw)
    out = out.transpose(1, 2)
    return out[:, :s] if pad else out
