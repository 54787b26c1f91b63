"""The RWKV6 chunked scan on (B, H, S, K) tensors: the plain PyTorch
version and the ctypes wrapper of the hand-written CUDA kernel K7
(``repro_torch/csrc/wkv6.cu``), which replaces the JAX package's Pallas
``wkv6_bhsk`` (``repro/kernels/wkv6/kernel.py:77``).

r, k, v, log_w: (B, H, S, K) fp32, S a multiple of the chunk; u: (H, K)
fp32. Returns (out (B, H, S, K), final state (B, H, K, K)), the scan
started from a zero state. Per chunk of C = 64 steps, in order:

    cum       = inclusive cumsum of log_w over the chunk
    q_in      = r * exp(cum - log_w)
    out       = q_in @ S + tril_{s<t}(q_in @ (k * exp(-cum))^T) @ v
                + sum(r * u * k) * v
    S         = exp(cum[-1]) * S + (k * exp(cum[-1] - cum))^T @ v

Dispatch follows the tensor: a CPU tensor takes the plain version; a
CUDA tensor launches K7 on PyTorch's current stream or raises — there
is no fallback. K7 takes C = 64 and K in {32, 64}. ``wkv6_bhsk.launches``
counts K7's calls (one a call, whatever the CUDA launches of its three
passes; ``reset_launches`` zeroes it). K7 runs a two-level chunk scan:
groups of ``GROUP_CHUNKS`` chunks scan from zero, an elementwise scan
over the groups gives each group's entry state, and the groups compute
their outputs from it; its products run on the tensor cores as 3xTF32,
its cumsum as a warp-shuffle scan. It sums in another order than the
plain version: the two agree to rounding, not bit for bit.

The library is built by ``kernels.nvcc`` at first use, never at import.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc

CHUNK = 64
HEAD_DIMS = (32, 64)
# chunks a group of K7's two-level scan holds (16 beat 4 and 8 in the
# probes on the card, PERF.md)
GROUP_CHUNKS = 16
SOURCE = nvcc.CSRC / "wkv6.cu"
LIBRARY = nvcc.BUILD_DIR / "libwkv6.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(*, force: bool = False) -> Path:
    """Compile ``wkv6.cu`` into ``libwkv6.so`` unless an up-to-date build
    exists. Raises with the compiler's output."""
    return nvcc.build(SOURCE, LIBRARY, force=force)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.wkv6_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ll,
                                     i, ll, i, i, vp]
            lib.wkv6_fwd.restype = ctypes.c_int
            _lib = lib
        return _lib


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor, *, chunk: int
               ) -> tuple:
    """The Pallas kernel's body per chunk, in its order, batched over
    (B, H): a loop over the chunks carries the (K, K) state."""
    b, h, s, dk = r.shape
    state = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    uu = u[None, :, None, :]
    out = torch.empty_like(r)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        rc, kc, vc, lw = r[:, :, sl], k[:, :, sl], v[:, :, sl], log_w[:, :, sl]
        cum = torch.cumsum(lw, dim=2)                     # (B, H, C, K)
        q_in = rc * torch.exp(cum - lw)
        out_inter = q_in @ state
        kd = kc * torch.exp(-cum)
        att = torch.where(strict, q_in @ kd.transpose(-1, -2), 0.0)
        out_intra = att @ vc
        bonus = (rc * uu * kc).sum(-1, keepdim=True)
        out[:, :, sl] = out_inter + out_intra + bonus * vc
        total = cum[:, :, -1]                             # (B, H, K)
        k_carry = kc * torch.exp(total[:, :, None] - cum)
        state = (torch.exp(total)[..., None] * state
                 + k_carry.transpose(-1, -2) @ vc)
    return out, state


def _check_inputs(r, k, v, log_w, u, chunk: int) -> None:
    if r.dim() != 4 or any(tuple(t.shape) != tuple(r.shape)
                           for t in (k, v, log_w)):
        raise ValueError(f"wkv6: need r, k, v, log_w of one (B, H, S, K) "
                         f"shape, got {[tuple(t.shape) for t in (r, k, v, log_w)]}")
    b, h, s, dk = r.shape
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"wkv6: u {tuple(u.shape)} is not (H, K) = "
                         f"{(h, dk)}")
    if s % chunk:
        raise ValueError(f"wkv6: S={s} is not a multiple of the chunk "
                         f"{chunk}")
    if any(t.device != r.device for t in (k, v, log_w, u)):
        raise ValueError("wkv6: r, k, v, log_w, u on different devices")
    if any(t.dtype != torch.float32 for t in (r, k, v, log_w, u)):
        raise TypeError(f"wkv6: dtypes "
                        f"{[t.dtype for t in (r, k, v, log_w, u)]}, need "
                        "float32")


def wkv6_bhsk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = CHUNK
              ) -> tuple:
    """K7: r, k, v, log_w (B, H, S, K) fp32, u (H, K) fp32 -> (out
    (B, H, S, K), state (B, H, K, K))."""
    _check_inputs(r, k, v, log_w, u, chunk)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, log_w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    b, h, s, dk = r.shape
    if dk not in HEAD_DIMS:
        raise ValueError(f"wkv6: head_dim {dk} not in {HEAD_DIMS}")
    if chunk != CHUNK:
        raise ValueError(f"wkv6: K7 takes chunk {CHUNK}, got {chunk}")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("u", u)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wkv6: {name} must be contiguous and 16-byte "
                             "aligned")
    group = GROUP_CHUNKS
    n_groups = -(-(s // CHUNK) // group)
    out = torch.empty_like(r)
    state = torch.empty((b, h, dk, dk), dtype=torch.float32, device=r.device)
    # the groups' local states (then entry states) and decays
    lstate = torch.empty((b, h, n_groups, dk, dk), dtype=torch.float32,
                         device=r.device)
    dec = torch.empty((b, h, n_groups, dk), dtype=torch.float32,
                      device=r.device)
    err = _load().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), out.data_ptr(), state.data_ptr(), lstate.data_ptr(),
        dec.data_ptr(), b, h, s, dk, group,
        torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6: CUDA launch failed with error {err}")
    wkv6_bhsk.launches += 1
    return out, state


def scratch_bytes(b: int, h: int, s: int, dk: int,
                  group: Optional[int] = None) -> int:
    """Bytes of the scratch K7 allocates for one call: the groups' K x K
    states and K decays, fp32."""
    n_groups = -(-(s // CHUNK) // (group or GROUP_CHUNKS))
    return b * h * n_groups * (dk * dk + dk) * 4


def reset_launches() -> None:
    wkv6_bhsk.launches = 0


reset_launches()
