"""GQA attention: the full-sequence train path, the encoder-decoder's
cross attention and the cached one-token decode path.

The port of ``repro.models.attention``'s parameter init, RoPE and
M-RoPE, the reference grouped-query SDPA (fp32 softmax), the q-chunked
exact path for long sequences, the full-sequence ``attention`` of
training, ``cross_attention`` over the encoder memory's K/V
(``memory_kv``, no RoPE; plain products, never the flash kernel, as in
JAX), and the KV cache (full, or a ring buffer of ``window`` slots), in
fp32 or bf16, or int8 with a per-(slot, head) fp32 scale
(``quantize=True``). ``use_flash=True`` routes the full-sequence path
through flash attention (``kernels.flash_attn``: K6 on the card, its
plain version on the CPU), whose gradient is the hand-written backward
(K6b on the card) that the JAX package's Pallas kernel lacks. Without
``use_flash`` the full-sequence path takes flash attention on its own
where autograd records a call on the card that K6b covers (fp32, head
dim 64 or 128, no softcap): training there runs no S^2 products. The
rest is plain torch, safe under autograd.

The JAX cache has a SCALAR cursor and the serve engine makes it per-slot
with ``jax.vmap``. Here the slot axis is a batch dimension written out:
``cursor`` is (B,), every row writes its own (ring) slot and masks its
own history. ``decode_attention`` updates the cache IN PLACE (the ring
buffers are the decode state's bulk; copying them per token buys
nothing) and returns it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist import sharding
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig

NEG_INF = -2.0**30


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
              dtype=torch.float32) -> dict:
    kw = dict(lead=lead, dtype=dtype)
    return {
        "q": layers.dense_init(gen, cfg.d_model, cfg.q_dim,
                               bias=cfg.qkv_bias, **kw),
        "k": layers.dense_init(gen, cfg.d_model, cfg.kv_dim,
                               bias=cfg.qkv_bias, **kw),
        "v": layers.dense_init(gen, cfg.d_model, cfg.kv_dim,
                               bias=cfg.qkv_bias, **kw),
        "o": layers.dense_init(gen, cfg.q_dim, cfg.d_model,
                               bias=cfg.out_bias, **kw),
    }


def _rotate(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    if cfg.rope_variant == "rope":
        return layers.apply_rope(x, positions, theta=cfg.rope_theta)
    if cfg.rope_variant == "mrope":
        return layers.apply_mrope(x, positions, theta=cfg.rope_theta,
                                  sections=cfg.mrope_sections)
    return x


def sdpa_reference(q, k, v, mask, *, softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention, fp32 softmax.

    q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); mask bool, broadcastable to
    (B, Sq, Sk), True = attend.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    # (B, Hkv, G, Sq, D) @ (B, Hkv, 1, D, Sk): batched matmuls, the
    # einsums "bqhgd,bkhd->bhgqk" / "bhgqk,bkhd->bqhgd" without
    # einsum's per-call planning on the host
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1).unsqueeze(2)
    logits = torch.matmul(qg, kt) / math.sqrt(d)
    logits = layers.softcap(logits, softcap)
    m = mask[:, None, None] if mask.dim() == 3 else mask
    logits = logits.masked_fill(~m, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v.float().permute(0, 2, 1, 3).unsqueeze(2))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


CHUNKED_THRESHOLD = 4096   # switch to q-chunked attention at/above this S
Q_CHUNK = 1024


def make_mask(sq: int, sk: int, *, causal: bool, window: int = 0,
              q_offset: int = 0, device=None) -> torch.Tensor:
    """(sq, sk) bool mask; q position i attends to k position j."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def chunked_sdpa(q, k, v, *, causal: bool, window: int, softcap: float,
                 q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Memory-bounded exact attention: a loop over query chunks, each
    with the exact softmax over all keys (O(q_chunk * S) logits).

    q (B, S, H, D) with the full q heads; k, v (B, S, H, D) already
    repeated to the q-head count. Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    if s % q_chunk:
        raise ValueError(f"seq {s} is not a multiple of q_chunk {q_chunk}")
    scale = 1.0 / math.sqrt(d)
    qt = q.float().transpose(1, 2)                 # (B, H, S, D)
    kt = k.float().permute(0, 2, 3, 1)             # (B, H, D, S)
    vt = v.float().transpose(1, 2)
    outs = []
    for c0 in range(0, s, q_chunk):
        logits = torch.matmul(qt[:, :, c0:c0 + q_chunk], kt) * scale
        logits = layers.softcap(logits, softcap)
        m = make_mask(q_chunk, s, causal=causal, window=window,
                      q_offset=c0, device=q.device)
        logits = logits.masked_fill(~m, NEG_INF)
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), vt))
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def flash_trains(cfg: ModelConfig, q, k, v) -> bool:
    """Whether a full-sequence call takes flash attention unasked: q on
    the card, autograd recording the call, and K6b covering it (fp32,
    head dim 64 or 128, no softcap)."""
    return (q.is_cuda and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)
            and flash_ops.covers_backward(q, cfg.logit_softcap))


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0, use_flash: bool = False) -> torch.Tensor:
    """Train/prefill path. x: (B, S, d); positions: (B, S).

    The JAX package's selection: the flash-attention kernel when
    ``use_flash``, else the q-chunked exact path for S >= 4096 (a
    multiple of 1024), else the full-S^2 reference; on the card, a call
    that autograd records and K6b covers (``flash_trains``) takes flash
    attention at any S. Under remat the checkpoint is non-reentrant, so
    the forward and its recompute see the same grad mode and route."""
    s = x.shape[1]
    q = sharding.split_heads(layers.dense(p["q"], x),
                             cfg.n_heads, cfg.head_dim)
    k = sharding.split_heads(layers.dense(p["k"], x),
                             cfg.n_kv_heads, cfg.head_dim)
    v = sharding.split_heads(layers.dense(p["v"], x),
                             cfg.n_kv_heads, cfg.head_dim)
    q = _rotate(cfg, q, positions)
    k = _rotate(cfg, k, positions)
    if use_flash or flash_trains(cfg, q, k, v):
        out = sharding.heads_local(flash_ops.flash_attention, q, k, v,
                                   causal=causal, window=window,
                                   softcap=cfg.logit_softcap)
    elif s >= CHUNKED_THRESHOLD and s % Q_CHUNK == 0:
        group = cfg.n_heads // cfg.n_kv_heads
        kf = k.repeat_interleave(group, dim=2)  # full q-head kv
        vf = v.repeat_interleave(group, dim=2)
        q, kf, vf = (sharding.constrain_heads(t) for t in (q, kf, vf))
        # on a mesh each device attends its own rows and heads
        out = sharding.heads_local(chunked_sdpa, q, kf, vf, causal=causal,
                                   window=window, softcap=cfg.logit_softcap)
    else:
        mask = make_mask(s, s, causal=causal, window=window,
                         device=x.device)[None]
        out = sharding.heads_local(sdpa_reference, q, k, v, mask,
                                   softcap=cfg.logit_softcap)
    return layers.dense(p["o"], sharding.merge_heads(out))


def cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    memory_kv: tuple) -> torch.Tensor:
    """Enc-dec cross attention of x (B, S, d) over every position of the
    encoder memory; ``memory_kv`` = (k, v), precomputed by ``memory_kv``."""
    s = x.shape[1]
    q = sharding.split_heads(layers.dense(p["q"], x),
                             cfg.n_heads, cfg.head_dim)
    k, v = memory_kv
    mask = torch.ones((1, s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = sharding.heads_local(sdpa_reference, q, k, v, mask,
                               softcap=cfg.logit_softcap)
    return layers.dense(p["o"], sharding.merge_heads(out))


def memory_kv(p: dict, cfg: ModelConfig, memory: torch.Tensor) -> tuple:
    """The cross-attention K/V of the encoder output (B, S, d), no RoPE,
    in the dtype the product gives (the params' and memory's)."""
    k = sharding.split_heads(layers.dense(p["k"], memory),
                             cfg.n_kv_heads, cfg.head_dim)
    v = sharding.split_heads(layers.dense(p["v"], memory),
                             cfg.n_kv_heads, cfg.head_dim)
    return k, v


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               window: int = 0, dtype=torch.bfloat16, device=None,
               lead: tuple = (), quantize: bool = False) -> dict:
    """window > 0 -> ring buffer of ``window`` slots; else seq_len slots.
    ``lead`` prepends stacking dims (the scanned layers' n_rep).
    ``quantize`` stores int8 K/V with a per-(slot, head) fp32 scale
    (``k_scale`` / ``v_scale``, (..., slots, H_kv, 1)): the paper's
    quantization applied to serving memory, half the bytes of bf16."""
    slots = min(window, seq_len) if window > 0 else seq_len
    shape = lead + (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if quantize else dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        # absolute position held by each slot (-1 = empty)
        "slot_pos": torch.full(lead + (batch, slots), -1, dtype=torch.long,
                               device=device),
        # next absolute position, per row
        "cursor": torch.zeros(lead + (batch,), dtype=torch.long,
                              device=device),
        "window": window if window > 0 else 0,
    }
    if quantize:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                      device=device)
    return cache


# 1/127 as XLA folds ``max|kv| / 127.0`` under jit: a multiply by the
# constant's fp32 reciprocal (JAX serves through the jitted step)
_INV_127 = float(np.float32(1.0 / 127.0))


def _quantize_kv(kv: torch.Tensor) -> tuple:
    """(B, 1, H, D) -> int8 codes and the per-(slot, head) fp32 scale
    (symmetric max-abs). The scale is the jitted form's reciprocal
    multiply; the codes a true division, rounded half to even."""
    kf = kv.float()
    scale = (kf.abs().amax(-1, keepdim=True) * _INV_127).clamp_min(1e-8)
    q = torch.clamp(torch.round(kf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype
                   ) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict) -> tuple:
    """One-token decode. x: (B, 1, d). Writes the cache in place and
    returns (out, cache). M-RoPE rotates at text positions (the three
    axes at the cursor), as JAX's decode does."""
    pos = cache["cursor"]                                     # (B,)
    positions = pos[:, None]
    if cfg.rope_variant == "mrope":
        positions = layers.text_mrope_positions(positions)
    q = sharding.split_heads(layers.dense(p["q"], x),
                             cfg.n_heads, cfg.head_dim)
    k = sharding.split_heads(layers.dense(p["k"], x),
                             cfg.n_kv_heads, cfg.head_dim)
    v = sharding.split_heads(layers.dense(p["v"], x),
                             cfg.n_kv_heads, cfg.head_dim)
    q = _rotate(cfg, q, positions)
    k = _rotate(cfg, k, positions)

    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    slots = ck.shape[1]
    window = cache["window"]
    slot = pos % slots if window > 0 else pos.clamp(max=slots - 1)
    rows = torch.arange(x.shape[0], device=x.device)
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            codes, scale = _quantize_kv(t)
            sharding.write_rows(cache[name], rows, slot, codes[:, 0])
            sharding.write_rows(cache[name + "_scale"], rows, slot,
                               scale[:, 0])
        k_eff = _dequantize_kv(ck, cache["k_scale"], q.dtype)
        v_eff = _dequantize_kv(cv, cache["v_scale"], q.dtype)
    else:
        sharding.write_rows(ck, rows, slot, k[:, 0].to(ck.dtype))
        sharding.write_rows(cv, rows, slot, v[:, 0].to(cv.dtype))
        k_eff, v_eff = ck.to(q.dtype), cv.to(q.dtype)
    sharding.write_rows(spos, rows, slot, pos)

    # valid slots: filled AND (no window OR within window of pos)
    valid = spos >= 0
    if window > 0:
        valid &= spos > (pos - window)[:, None]
    out = sharding.heads_local(sdpa_reference, q, k_eff, v_eff,
                               valid[:, None, :], softcap=cfg.logit_softcap)
    pos += 1
    return layers.dense(p["o"], sharding.merge_heads(out)), cache
