"""The plain fp32 forward pass and loss of a pre-norm decoder with
grouped-query attention, RoPE, a SwiGLU MLP and a tied head (the blocks
of Qwen1.5 and of Granite Code, as their papers and ``config.json``
describe them): for each layer

    h = x + Wo . attn(rope(RMSNorm(x) Wq + bq), rope(.. Wk + bk), .. Wv + bv)
    x = h + W_down (silu(RMSNorm(h) W_gate) * (RMSNorm(h) W_up))

with RMSNorm(x) = x / sqrt(mean(x^2) + eps) * scale, causal softmax
attention over 1/sqrt(D)-scaled products in fp32, q head j reading kv
head j // (Hq / Hkv), and RoPE rotating the two halves of each head by
``pos * theta^(-2i/D)`` (frequencies and angles in fp32). The logits
are RMSNorm(x) E^T.

Every matmul goes through ``mm``, so the control can run the same
arithmetic with its operands rounded to TF32 (``tf32``). The attention
runs over blocks of queries (``q_block``) so that a long prompt fits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (to nearest, ties to even),
    kept in fp32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """TF32 rounding that passes gradients through unchanged."""
    if not x.requires_grad:
        return _round_tf32(x)
    return x + (_round_tf32(x.detach()) - x.detach())


def make_mm(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "tf32":
        return lambda a, b: torch.matmul(tf32(a), tf32(b))
    raise ValueError(f"unknown precision '{precision}'")


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), pos (S,)."""
    d = x.shape[-1]
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device),
                          torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = (pos.float()[:, None] * inv)[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, mm, q_block: int) -> torch.Tensor:
    """Causal GQA attention. q (B, S, Hq, D), k, v (B, S, Hkv, D)."""
    b, s, hq, d = q.shape
    group = hq // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(group, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(d)
    outs = []
    for c0 in range(0, s, q_block):
        c1 = min(s, c0 + q_block)
        logits = mm(qt[:, :, c0:c1], kt[:, :, :c1].transpose(-1, -2)) * scale
        qi = torch.arange(c0, c1, device=q.device)[:, None]
        kj = torch.arange(c1, device=q.device)[None, :]
        logits = logits.masked_fill(kj > qi, float("-inf"))
        outs.append(mm(torch.softmax(logits, dim=-1), vt[:, :, :c1]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def hidden(W: dict, m: dict, tokens: torch.Tensor, *, mm=torch.matmul,
           q_block: int = 1024) -> torch.Tensor:
    """The last layer's output (B, S, d) for int tokens (B, S)."""
    b, s = tokens.shape
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    pos = torch.arange(s, device=tokens.device)
    x = W["embed"][tokens.long()]
    for i in range(m["n_layers"]):
        h = rms_norm(x, W["ln1"][i], eps)
        q, k, v = (mm(h, W[w][i]) for w in ("wq", "wk", "wv"))
        if m["qkv_bias"]:
            q, k, v = q + W["bq"][i], k + W["bk"][i], v + W["bv"][i]
        q = rope(q.view(b, s, hq, hd), pos, theta)
        k = rope(k.view(b, s, hkv, hd), pos, theta)
        a = attention(q, k, v.view(b, s, hkv, hd), mm, q_block)
        x = x + mm(a.reshape(b, s, hq * hd), W["wo"][i])
        h = rms_norm(x, W["ln2"][i], eps)
        x = x + mm(F.silu(mm(h, W["w_gate"][i])) * mm(h, W["w_up"][i]),
                   W["w_down"][i])
    return x


def logits_of(W: dict, m: dict, x: torch.Tensor, mm=torch.matmul):
    return mm(rms_norm(x, W["final_norm"], m["norm_eps"]),
              W["embed"].transpose(0, 1))


@torch.no_grad()
def last_logits(W: dict, m: dict, tokens: torch.Tensor, *,
                precision: str = "fp32", q_block: int = 1024
                ) -> torch.Tensor:
    """(B, V) logits of the last position."""
    mm = make_mm(precision)
    x = hidden(W, m, tokens, mm=mm, q_block=q_block)
    return logits_of(W, m, x[:, -1], mm)


def loss_sum(W: dict, m: dict, tokens: torch.Tensor, labels: torch.Tensor,
             *, precision: str = "fp32") -> torch.Tensor:
    """The summed token cross entropy of a block of rows."""
    mm = make_mm(precision)
    x = hidden(W, m, tokens, mm=mm, q_block=tokens.shape[1])
    logits = logits_of(W, m, x, mm)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum")
