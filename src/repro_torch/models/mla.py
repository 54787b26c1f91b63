"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of ``repro.models.mla``. K/V are compressed to a shared latent
c_kv of rank ``kv_lora_rank``; queries split into a no-RoPE part
(against up-projected keys) and a RoPE part (against one shared rotary
key). ``mla_attention`` is the full-sequence form with the (S, S)
logits, as JAX's (which does not route MLA to flash attention); with
``use_flash`` on the card it runs on K6 instead, at the MLA head dims
``kernel.MLA_HEAD_DIMS`` (q.k over [nope, rope], p.v over v_head_dim).
YaRN (``cfg.rope_scaling``) scales the rope frequencies and the softmax
(``_scale``). The
decode cache stores only (c_kv, k_rope) and decodes through the
"absorbed" matmuls (attention in the latent space), so a step costs
O(rank) per cached token instead of O(heads * head_dim).

The cache has a per-row ``cursor`` (B,) and ``slot_pos`` (B, slots),
as the port's attention cache has (the JAX engine's vmapped scalar
cursor, written out as a batch axis), a ring buffer of ``window``
slots when ``window`` > 0; ``decode_attention`` writes it in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import sharding
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig

NEG_INF = -2.0**30


def mla_init(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
             dtype=torch.float32) -> dict:
    m = cfg.mla
    h = cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(lead=lead, dtype=dtype)
    return {
        "q_proj": layers.dense_init(gen, cfg.d_model, h * qk_dim, **kw),
        "kv_down": layers.dense_init(gen, cfg.d_model,
                                     m.kv_lora_rank + m.qk_rope_head_dim,
                                     **kw),
        "kv_norm": layers.norm_init(m.kv_lora_rank, "rmsnorm", lead=lead,
                                    dtype=dtype, device=gen.device),
        "k_up": layers.dense_init(gen, m.kv_lora_rank,
                                  h * m.qk_nope_head_dim, **kw),
        "v_up": layers.dense_init(gen, m.kv_lora_rank, h * m.v_head_dim,
                                  **kw),
        "o": layers.dense_init(gen, h * m.v_head_dim, cfg.d_model, **kw),
    }


def _queries(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> tuple:
    """q_nope (B, S, H, Dn) and the rotated q_rope (B, S, H, Dr)."""
    m = cfg.mla
    b, s, _ = x.shape
    q = layers.dense(p["q_proj"], x).view(
        b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, layers.apply_rope(q_rope, positions, theta=cfg.rope_theta,
                                     scaling=cfg.rope_scaling)


def _latent(p: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor) -> tuple:
    """The normed latent c_kv (B, S, rank) and the rotated shared key
    k_rope (B, S, 1, Dr)."""
    m = cfg.mla
    kvd = layers.dense(p["kv_down"], x)
    c_kv = layers.apply_norm(p["kv_norm"], kvd[..., :m.kv_lora_rank],
                             kind="rmsnorm", eps=cfg.norm_eps)
    k_rope = layers.apply_rope(kvd[..., m.kv_lora_rank:][:, :, None],
                               positions, theta=cfg.rope_theta,
                               scaling=cfg.rope_scaling)
    return c_kv, k_rope


def _scale(cfg: ModelConfig) -> float:
    """The softmax scale: 1/sqrt(qk head dim), times YaRN's
    ``yarn_mscale(factor, mscale_all_dim)`` squared under YaRN (as
    DeepSeek-V2's attention sets ``softmax_scale``)."""
    scale = 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim
                            + cfg.mla.qk_rope_head_dim)
    ys = cfg.rope_scaling
    if ys is not None and ys.mscale_all_dim:
        scale *= layers.yarn_mscale(ys.factor, ys.mscale_all_dim) ** 2
    return scale


def mla_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  use_flash: bool = False) -> torch.Tensor:
    """Train/prefill path. x: (B, S, d); positions (B, S). ``use_flash``
    on the card: K6 over q = [q_nope, q_rope] and k = [k_nope, k_rope
    broadcast over the heads], v at v_head_dim. K6 builds the (qk, v)
    head dims ``kernel.MLA_HEAD_DIMS`` and raises at any other; the CPU
    keeps the plain path; a call that autograd records raises in its
    backward, which no kernel covers at these dims
    (``flash_ops.covers_backward``)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latent(p, cfg, x, positions)
    k_nope = layers.dense(p["k_up"], c_kv).view(b, s, h, m.qk_nope_head_dim)
    v = layers.dense(p["v_up"], c_kv).view(b, s, h, m.v_head_dim)
    if use_flash and x.is_cuda:
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)],
                      dim=-1)
        out = flash_ops.flash_attention(q, k, v, causal=causal,
                                        scale=_scale(cfg))
        return layers.dense(p["o"], out.reshape(b, s, h * m.v_head_dim))

    # (B, H, Sq, D) @ (B, H, D, Sk); the rotary key is shared by the heads
    logits = (torch.matmul(q_nope.float().transpose(1, 2),
                           k_nope.float().permute(0, 2, 3, 1))
              + torch.matmul(q_rope.float().transpose(1, 2),
                             k_rope.float().permute(0, 2, 3, 1))
              ) * _scale(cfg)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v.float().transpose(1, 2)).transpose(1, 2)
    out = out.reshape(b, s, h * m.v_head_dim).to(x.dtype)
    return layers.dense(p["o"], out)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               window: int = 0, dtype=torch.bfloat16, device=None,
               lead: tuple = ()) -> dict:
    """window > 0 -> ring buffer of ``window`` slots; else seq_len slots.
    ``lead`` prepends stacking dims (the scanned layers' n_rep)."""
    m = cfg.mla
    slots = min(window, seq_len) if window > 0 else seq_len
    z = lambda *shape: torch.zeros(lead + shape, dtype=dtype,  # noqa: E731
                                   device=device)
    return {
        "c_kv": z(batch, slots, m.kv_lora_rank),
        "k_rope": z(batch, slots, m.qk_rope_head_dim),
        "slot_pos": torch.full(lead + (batch, slots), -1, dtype=torch.long,
                               device=device),
        "cursor": torch.zeros(lead + (batch,), dtype=torch.long,
                              device=device),
        "window": window if window > 0 else 0,
    }


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict) -> tuple:
    """One-token decode with the latent cache. x: (B, 1, d). Writes the
    cache in place and returns (out, cache)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    pos = cache["cursor"]                                    # (B,)
    positions = pos[:, None]
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_new, kr_new = _latent(p, cfg, x, positions)

    c_kv, k_rope, spos = cache["c_kv"], cache["k_rope"], cache["slot_pos"]
    slots = c_kv.shape[1]
    window = cache["window"]
    slot = pos % slots if window > 0 else pos.clamp(max=slots - 1)
    rows = torch.arange(b, device=x.device)
    sharding.write_rows(c_kv, rows, slot, c_new[:, 0].to(c_kv.dtype))
    sharding.write_rows(k_rope, rows, slot,
                        kr_new[:, 0, 0].to(k_rope.dtype))
    sharding.write_rows(spos, rows, slot, pos)

    # absorbed attention: q_nope into the latent space through k_up^T
    w_kup = p["k_up"]["w"].view(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         w_kup.float())                      # (B, H, rank)
    ckv = c_kv.float()
    logits = (torch.matmul(q_lat, ckv.transpose(1, 2))
              + torch.matmul(q_rope[:, 0].float(),
                             k_rope.float().transpose(1, 2))) * _scale(cfg)
    valid = spos >= 0
    if window > 0:
        valid &= spos > (pos - window)[:, None]
    logits = logits.masked_fill(~valid[:, None], NEG_INF)   # (B, H, slots)
    w = torch.softmax(logits, dim=-1)
    # attend in the latent space, then up-project once per step
    ctx_lat = torch.matmul(w, ckv)                           # (B, H, rank)
    w_vup = p["v_up"]["w"].view(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", ctx_lat, w_vup.float())
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    pos += 1
    return layers.dense(p["o"], out), cache
