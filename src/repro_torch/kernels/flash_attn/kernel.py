"""GQA flash attention: the host ``skip_grid`` table, the plain PyTorch
versions, and the ctypes wrappers of the hand-written CUDA kernels in
``repro_torch/csrc/flash_attn.cu``: the forward K6, which replaces the
JAX package's Pallas ``flash_attention_bhsd``
(``repro/kernels/flash_attn/kernel.py:143``), and the backward K6b,
which replaces nothing (the Pallas kernel has no gradient; the port
computes the gradient of the same function, which the JAX package gets
by differentiating its plain attention).

Layout (B, H, S, D), head-major, as the Pallas kernel takes it: q
(B, Hq, S, D), k and v (B, Hkv, S, D), fp32 or bf16; fp32 math
(online softmax with fp32 running max, rescale and denominator), output
in q's dtype. K6 computes both products on the tensor cores: fp32 as
3xTF32 (each operand split into two TF32 parts, three products, fp32
accumulation), bf16 as bf16 products with P rounded to bf16 for P.v. Masks: causal, a sliding window (a key is seen iff
``q - window < k <= q``) and the padded tail (keys ``k >= s_valid``
are never attended); optional tanh softcap.

Dispatch follows the tensor: a CPU tensor takes the plain version; a
CUDA tensor launches K6 on PyTorch's current stream or raises — there
is no fallback. ``flash_attention_bhsd.launches`` counts K6's launches,
``flash_attention_bwd_bhsd.launches`` K6b's calls (three launches
each: the row sums, the dK/dV pass, the dQ pass; ``reset_launches``
zeroes both).

``with_lse=True`` also returns the row log-sum-exp ``lse = m + log(l)``
(B, Hq, S) in fp32, on the logits as scaled, capped and masked (-inf on
a row that attends nothing); on the card only where K6b covers the
backward (fp32, D in {64, 128}). The backward recomputes the probabilities
from it, ``P = exp(logits - lse)``, and takes q, k, v, out, dout and
lse to dq, dk, dv (fp32, D in {64, 128} on the card, no softcap):
``delta = rowsum(dout * out)``, ``dP = dout . v``, ``dS = P * (dP -
delta)``, ``dv = P^T . dout``, ``dk = dS^T . (q * scale)``, ``dq =
scale * dS . k``, the GQA group summed into dk and dv.

``block_q`` / ``block_k`` keep the JAX package's meaning for the plain
version and for ``skip_grid``: the plain version walks the same
(q-block, k-block) tiles, in the same order per q-block, as the Pallas
kernel's pair table. K6 takes its own tiles and ignores them: a block
of 128 rows (64 at D = 256) serves ``rows // group`` queries of every
q-head of one KV head (``group = Hq / Hkv``; ``rows`` heads at a time
above that), with 64-key tiles (32 at D = 256) of K and V in shared
memory, and computes its own k range from the masks (with
``skip=False``, every k-tile). Because the tiles and the products
differ, K6 and the plain version agree to rounding (rtol = atol = 2e-5
in fp32), not bit for bit; ``skip=True`` and ``skip=False`` are
bit-identical on each side, since a fully masked tile adds exactly
nothing.

v may have another head dim than q and k (``DV``): the output is then
(B, Hq, S, DV). K6 builds that only for fp32 at the pairs
``MLA_HEAD_DIMS`` (multi-head latent attention: q.k at 192 = 128 + 64,
p.v at 128), forward only. ``scale`` replaces the softmax scale
1/sqrt(D) (YaRN's MLA scale); the backward takes the default only.

The library is built by ``kernels.nvcc`` at first use, never at import.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import nvcc

NEG_INF = -2.0**30
HEAD_DIMS = (32, 64, 128, 256)
BACKWARD_HEAD_DIMS = (64, 128)
MLA_HEAD_DIMS = ((192, 128),)        # (D of q and k, DV of v), fp32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SOURCE = nvcc.CSRC / "flash_attn.cu"
LIBRARY = nvcc.BUILD_DIR / "libflash_attn.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(*, force: bool = False) -> Path:
    """Compile ``flash_attn.cu`` into ``libflash_attn.so`` unless an
    up-to-date build exists. Raises with the compiler's output."""
    return nvcc.build(SOURCE, LIBRARY, force=force)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_float)
            lib.flash_attn_fwd.argtypes = [vp, vp, vp, vp, vp, i, ll, i, i,
                                           ll, i, i, ll, i, i, f, f, f, i,
                                           vp]
            lib.flash_attn_fwd.restype = ctypes.c_int
            lib.flash_attn_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                           vp, vp, ll, i, i, ll, i, ll, i,
                                           i, f, vp]
            lib.flash_attn_bwd.restype = ctypes.c_int
            _lib = lib
        return _lib


def skip_grid(s_pad: int, block_q: int, block_k: int, *, causal: bool,
              window: int, s_valid: int) -> np.ndarray:
    """Static (4, n_pairs) int32 table of surviving (q-block, k-block)
    tiles, the Pallas kernel's scalar-prefetched grid.

    Row 0: q-block index, row 1: k-block index, row 2: 1 iff the pair is
    the first k-step of its q-block, row 3: 1 iff it is the last. Pairs
    are q-block-major. A pair is dropped iff every (q_pos, k_pos) in its
    tile is masked:
      * tail:   k_pos >= s_valid for the whole tile,
      * causal: min k_pos > max q_pos,
      * window: max k_pos <= min q_pos - window.
    """
    n_q = -(-s_pad // block_q)
    n_k = -(-s_pad // block_k)
    qi_l, ki_l, first_l, last_l = [], [], [], []
    for qi in range(n_q):
        q_lo, q_hi = qi * block_q, qi * block_q + block_q - 1
        kis = []
        for ki in range(n_k):
            k_lo, k_hi = ki * block_k, ki * block_k + block_k - 1
            if k_lo >= s_valid:
                continue
            if causal and k_lo > q_hi:
                continue
            if window > 0 and k_hi <= q_lo - window:
                continue
            kis.append(ki)
        for j, ki in enumerate(kis):
            qi_l.append(qi)
            ki_l.append(ki)
            first_l.append(1 if j == 0 else 0)
            last_l.append(1 if j == len(kis) - 1 else 0)
    return np.asarray([qi_l, ki_l, first_l, last_l], dtype=np.int32)


def _q_block_runs(maps: np.ndarray, n_k: int) -> list:
    """For each k-block, the q-blocks [qa, qb) whose pair survives (a
    contiguous run: each mask drops a prefix or a suffix of q-blocks),
    or None when no q-block takes it."""
    runs = []
    for ki in range(n_k):
        qis = maps[0][maps[1] == ki]
        if not qis.size:
            runs.append(None)
            continue
        qa, qb = int(qis.min()), int(qis.max()) + 1
        if qb - qa != qis.size:
            raise AssertionError(f"k-block {ki}: q-blocks {qis} not a run")
        runs.append((qa, qb))
    return runs


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int, softcap: float,
                          block_q: int, block_k: int, s_valid: int,
                          skip: bool = True, with_lse: bool = False,
                          scale: Optional[float] = None):
    """The Pallas kernel's arithmetic in PyTorch, in its order: q scaled
    before the dot, softcap as ``cap * tanh(logits * (1/cap))``, masked
    logits set to NEG_INF and their probabilities zeroed after the exp,
    fp32 running max, ``alpha`` rescale and denominator, output
    ``acc / max(l, 1e-30)`` in q's dtype (and ``with_lse``: the row
    log-sum-exp ``m + log(l)``, (B, Hq, S) fp32). Batched over q-blocks and
    heads (heads folded per KV head, as the TPU tile folds them), with a
    loop over the k-blocks: each k-block updates the run of q-blocks
    whose pair the skip table keeps (``skip=False``: every q-block,
    masking inside the tile). v's head dim may differ from q's (the
    output takes v's); ``scale`` defaults to 1/sqrt(D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    dv = v.shape[-1]
    group = hq // hkv
    if s % block_q or s % block_k:
        raise ValueError(f"flash plain: S={s} is not a multiple of the "
                         f"blocks ({block_q}, {block_k})")
    n_q, n_k = s // block_q, s // block_k
    gbq = group * block_q
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    maps = (skip_grid(s, block_q, block_k, causal=causal, window=window,
                      s_valid=s_valid) if skip else
            skip_grid(s, block_q, block_k, causal=False, window=0,
                      s_valid=s))
    dev = q.device
    # (B, nQ, Hkv, group * BQ, D): row r of a tile is q-head
    # kv * group + r // BQ at query position qi * BQ + r % BQ
    qf = (q.float() * scale).reshape(b, hkv, group, n_q, block_q, d) \
        .permute(0, 3, 1, 2, 4, 5).reshape(b, n_q, hkv, gbq, d)
    kf = k.float().reshape(b, hkv, n_k, block_k, d)
    vf = v.float().reshape(b, hkv, n_k, block_k, dv)
    m = torch.full((b, n_q, hkv, gbq, 1), NEG_INF, device=dev)
    l_ = torch.zeros((b, n_q, hkv, gbq, 1), device=dev)
    acc = torch.zeros((b, n_q, hkv, gbq, dv), device=dev)
    row = torch.arange(gbq, device=dev) % block_q
    q_pos = (torch.arange(n_q, device=dev)[:, None] * block_q
             + row[None])[:, None, :, None]               # (nQ, 1, gBQ, 1)
    col = torch.arange(block_k, device=dev)
    for ki, run in enumerate(_q_block_runs(maps, n_k)):
        if run is None:
            continue
        qa, qb = run
        logits = torch.matmul(qf[:, qa:qb], kf[:, None, :, ki]
                              .transpose(-1, -2))          # (B, n, Hkv, gBQ, BK)
        if softcap > 0:
            logits = softcap * torch.tanh(logits * (1.0 / softcap))
        k_pos = ki * block_k + col
        mask = k_pos < s_valid
        qp = q_pos[qa:qb]
        if causal:
            mask = mask & (k_pos <= qp)
        if window > 0:
            mask = mask & (k_pos > qp - window)
        logits = torch.where(mask, logits, NEG_INF)
        m_prev = m[:, qa:qb]
        m_new = torch.maximum(m_prev, logits.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(logits - m_new), 0.0)
        alpha = torch.exp(m_prev - m_new)
        l_[:, qa:qb] = alpha * l_[:, qa:qb] + p.sum(-1, keepdim=True)
        acc[:, qa:qb] = acc[:, qa:qb] * alpha + torch.matmul(
            p, vf[:, None, :, ki])
        m[:, qa:qb] = m_new
    out = acc / torch.clamp_min(l_, 1e-30)
    out = out.view(b, n_q, hkv, group, block_q, dv).permute(
        0, 2, 3, 1, 4, 5).reshape(b, hq, s, dv).to(q.dtype)
    if not with_lse:
        return out
    lse = (m + torch.log(l_)).view(b, n_q, hkv, group, block_q).permute(
        0, 2, 3, 1, 4).reshape(b, hq, s)
    return out, lse


def flash_attention_backward_plain(q, k, v, out, dout, lse, *, causal: bool,
                                   window: int, s_valid: int,
                                   q_chunk: int = 256) -> tuple:
    """K6b's arithmetic in PyTorch: the probabilities recomputed from
    the forward's row log-sum-exp, ``P = exp((q * scale) . k - lse)``
    where attended (0 elsewhere), ``delta = rowsum(dout * out)``, ``dS =
    P * (dout . v - delta)``; ``dv = P^T . dout`` and ``dk = dS^T . (q *
    scale)`` summed over the GQA group, ``dq = scale * dS . k``. fp32
    math, results in the inputs' dtypes. A loop over ``q_chunk`` query
    rows bounds the (chunk x S) logits; every query row, padded or not,
    is a row of the output and gets its gradient."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qs = (q.float() * scale).view(b, hkv, group, s, d)
    kf = k.float()[:, :, None]                        # (B, Hkv, 1, S, D)
    vf = v.float()[:, :, None]
    do = dout.float().view(b, hkv, group, s, d)
    delta = (do * out.float().view(b, hkv, group, s, d)).sum(
        -1, keepdim=True)
    lse = lse.float().view(b, hkv, group, s, 1)
    dq = torch.empty((b, hkv, group, s, d), device=dev)
    dk = torch.zeros((b, hkv, s, d), device=dev)
    dv = torch.zeros((b, hkv, s, d), device=dev)
    k_pos = torch.arange(s, device=dev)
    for c0 in range(0, s, q_chunk):
        c1 = min(s, c0 + q_chunk)
        q_pos = torch.arange(c0, c1, device=dev)[:, None]
        mask = k_pos < s_valid
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        logits = torch.matmul(qs[..., c0:c1, :], kf.transpose(-1, -2))
        p = torch.where(mask, torch.exp(logits - lse[..., c0:c1, :]), 0.0)
        dov = do[..., c0:c1, :]
        dv += torch.matmul(p.transpose(-1, -2), dov).sum(2)
        ds = p * (torch.matmul(dov, vf.transpose(-1, -2))
                  - delta[..., c0:c1, :])
        dq[..., c0:c1, :] = torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qs[..., c0:c1, :]).sum(2)
    return (dq.view(b, hq, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            tuple(k.shape[:3]) != tuple(v.shape[:3]):
        raise ValueError(f"flash_attention: need q (B, Hq, S, D), k "
                         f"(B, Hkv, S, D) and v (B, Hkv, S, DV), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, softcap: float,
                         block_q: int, block_k: int, s_valid: int,
                         skip: bool = True, with_lse: bool = False,
                         scale: Optional[float] = None):
    """K6: q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv, S, DV) ->
    (B, Hq, S, DV) in q's dtype, and with ``with_lse`` the row
    log-sum-exp (B, Hq, S) fp32. ``s_valid``: the real (unpadded)
    length; keys beyond it are masked. ``skip=False`` runs every k-tile
    (masks still applied). ``scale``: the softmax scale, 1/sqrt(D) by
    default. DV differs from D on the card only at ``MLA_HEAD_DIMS``,
    in fp32, without the lse."""
    _check_inputs(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, block_q=block_q,
                                     block_k=block_k, s_valid=s_valid,
                                     skip=skip, with_lse=with_lse,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, hq, s, d = q.shape
    dv = v.shape[-1]
    if dv == d and d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if dv != d and ((d, dv) not in MLA_HEAD_DIMS or q.dtype != torch.float32
                    or with_lse):
        raise ValueError(f"flash_attention: head dims ({d}, {dv}) need "
                         f"float32, no lse, and a pair in {MLA_HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, need float32 "
                        "or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned (K6 copies 16-byte chunks)")
    if not 0 < s_valid <= s:
        raise ValueError(f"flash_attention: s_valid {s_valid} outside "
                         f"(0, {s}]")
    if with_lse and (q.dtype != torch.float32
                     or d not in BACKWARD_HEAD_DIMS):
        raise ValueError("flash_attention: with_lse on the card needs "
                         f"float32 and head_dim in {BACKWARD_HEAD_DIMS}")
    out = q.new_empty((b, hq, s, dv))
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    cap = float(softcap) if softcap > 0 else 0.0
    err = _load().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, DTYPES[q.dtype], b, hq,
        k.shape[1], s, d, dv, s_valid, int(causal), int(window),
        float(scale), cap, 1.0 / cap if cap else 0.0, int(skip),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"error {err}")
    flash_attention_bhsd.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_bhsd(q, k, v, out, dout, lse, *, causal: bool,
                             window: int, s_valid: int) -> tuple:
    """K6b: the gradient of ``flash_attention_bhsd`` (no softcap) from
    its inputs, its output, the output's gradient ``dout`` and the row
    log-sum-exp -> (dq, dk, dv), shaped as q, k, v. On the card: fp32,
    D in ``BACKWARD_HEAD_DIMS``, every tensor contiguous and 16-byte
    aligned; the same inputs give the same bits on every call (no
    atomics)."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, out, dout, lse, causal=causal, window=window,
            s_valid=s_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, hq, s, d = q.shape
    if d not in BACKWARD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head_dim {d} not in "
                         f"{BACKWARD_HEAD_DIMS}")
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention backward: dtype {q.dtype}, need "
                        "float32")
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(
            q.shape) or tuple(lse.shape) != (b, hq, s):
        raise ValueError("flash_attention backward: out, dout or lse do "
                         "not match q")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"flash_attention backward: {name} must be "
                            "float32 on q's device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention backward: {name} must be "
                             "contiguous and 16-byte aligned")
    if not 0 < s_valid <= s:
        raise ValueError(f"flash_attention: s_valid {s_valid} outside "
                         f"(0, {s}]")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    err = _load().flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b, hq, k.shape[1], s, d, s_valid,
        int(causal), int(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward: CUDA launch failed "
                           f"with error {err}")
    flash_attention_bwd_bhsd.launches += 1
    return dq, dk, dv


def reset_launches() -> None:
    flash_attention_bhsd.launches = 0
    flash_attention_bwd_bhsd.launches = 0


reset_launches()
