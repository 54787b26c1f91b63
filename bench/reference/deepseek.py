"""The plain fp32 forward pass of DeepSeek-V2-Lite (arXiv:2405.04434;
its ``config.json`` and ``modeling_deepseek.py``): for each layer

    h = x + Wo . attn(q, k, v)
    x = h + FFN(RMSNorm(h))

with, from a = RMSNorm(x) (every RMSNorm x / sqrt(mean(x^2) + eps) *
scale, eps the config's):

    q = a Wq, split per head into q_nope (128) and q_rope (64)
    [c, k_rope] = a W_kv_a;  c = RMSNorm(c) (rank 512)
    k_nope = c W_kb, v = c W_vb (per head 128 and 128)
    q = [q_nope, rope(q_rope)], k = [k_nope, rope(k_rope)] (k_rope shared
    by the heads); causal softmax attention in fp32 over the products
    times ``softmax_scale``

and FFN the dense SwiGLU W_down (silu(a W_gate) * (a W_up)) on the first
``first_k_dense`` layers, elsewhere the MoE layer: router probabilities
softmax(a W_router) in fp32, the greedy top-k experts of each token,
gates the probabilities themselves (renormalised over the k when
``norm_topk_prob``), y = sum_k gate_k SwiGLU_k(a) + the shared SwiGLU
experts, every choice computed (no capacity); a loop over the experts.
The logits are RMSNorm(x) W_head (untied).

RoPE is YaRN's (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` over
the 64 rope dims): inverse frequencies ``inter * ramp + extra * (1 -
ramp)``, extra = theta^(-2i/D), inter = 1 / (factor theta^(2i/D)), the
ramp linear from ``floor(c(beta_fast))`` to ``ceil(c(beta_slow))``
with c(r) = D ln(L0 / (2 pi r)) / (2 ln theta), L0 the original
context; cos and sin times mscale(factor, mscale) / mscale(factor,
mscale_all_dim), mscale(s, m) = 0.1 m ln s + 1; and softmax_scale =
(qk head dim)^-0.5 * mscale(factor, mscale_all_dim)^2. Departure (also
the program's): the rope rotates halves (i, i + D/2), where DeepSeek
rotates interleaved pairs, a fixed permutation of the rope columns of
Wq and W_kv_a, the same model on random weights.

Every matmul goes through ``mm``, so the control runs the same
arithmetic with its operands rounded to TF32 (``model.make_mm``). The
attention runs over blocks of queries (``q_block``). Nothing here
imports the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import make_mm, rms_norm


def yarn_mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def softmax_scale(m: dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    ys = m.get("rope_scaling")
    if ys and ys["mscale_all_dim"]:
        scale *= yarn_mscale(ys["factor"], ys["mscale_all_dim"]) ** 2
    return scale


def yarn_inv_freq(m: dict, device) -> torch.Tensor:
    """(D/2,) inverse frequencies of the rope dims (plain RoPE without
    ``rope_scaling``)."""
    dim, base = m["qk_rope_head_dim"], m["rope_theta"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    ys = m.get("rope_scaling")
    if not ys:
        return extra
    inter = 1.0 / (ys["factor"] * base ** exps)

    def corr(rot):
        return (dim * math.log(ys["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(ys["beta_fast"])), 0)
    high = min(math.ceil(corr(ys["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def cos_sin(m: dict, s: int, device) -> tuple:
    """cos, sin (S, D/2) of positions 0 .. S - 1."""
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
        * yarn_inv_freq(m, device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    ys = m.get("rope_scaling")
    if ys:
        k = (yarn_mscale(ys["factor"], ys["mscale"])
             / yarn_mscale(ys["factor"], ys["mscale_all_dim"]))
        cos, sin = cos * k, sin * k
    return cos, sin


def rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x (B, S, H, D) rotated in halves; cos, sin (S, D/2)."""
    c, s_ = cos[None, :, None], sin[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s_, x1 * s_ + x2 * c], dim=-1)


def attention(q, k, v, mm, q_block: int, scale: float) -> torch.Tensor:
    """Causal attention, q, k (B, S, H, Dqk), v (B, S, H, Dv)."""
    s = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    outs = []
    for c0 in range(0, s, q_block):
        c1 = min(s, c0 + q_block)
        logits = mm(qt[:, :, c0:c1], kt[:, :, :c1].transpose(-1, -2)) * scale
        qi = torch.arange(c0, c1, device=q.device)[:, None]
        kj = torch.arange(c1, device=q.device)[None, :]
        logits = logits.masked_fill(kj > qi, float("-inf"))
        outs.append(mm(torch.softmax(logits, dim=-1), vt[:, :, :c1]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def swiglu(x, gate, up, down, mm):
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def moe(W: dict, m: dict, a: torch.Tensor, j: int, mm, stats=None):
    """MoE layer ``j`` (counted from the first MoE layer) of a (T, d).
    ``stats``: a list that gets, for the last token, its top-k expert ids
    and the gap between its k-th and (k+1)-th probabilities."""
    k, e = m["top_k"], m["n_experts"]
    probs = torch.softmax(mm(a, W["router"][j]), dim=-1)
    top = torch.topk(probs, min(k + 1, e), dim=-1)
    gates, ids = top.values[:, :k], top.indices[:, :k]
    if stats is not None:
        stats.append((sorted(ids[-1].tolist()),
                      float(top.values[-1, k - 1] - top.values[-1, k])
                      if k < e else float("inf")))
    if m["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(a)
    for e in range(m["n_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(a[tok], W["experts_gate"][j, e], W["experts_up"][j, e],
                       W["experts_down"][j, e], mm)
            out.index_add_(0, tok, y * gates[tok, slot, None])
    for i in range(m["n_shared"]):
        out = out + swiglu(a, W["shared_gate"][i, j], W["shared_up"][i, j],
                           W["shared_down"][i, j], mm)
    return out


def hidden(W: dict, m: dict, tokens: torch.Tensor, *, mm=torch.matmul,
           q_block: int = 1024, stats=None) -> torch.Tensor:
    """The last layer's output (B, S, d) for int tokens (B, S)."""
    b, s = tokens.shape
    h, eps = m["n_heads"], m["norm_eps"]
    r, dn, dr, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                     m["qk_rope_head_dim"], m["v_head_dim"])
    nd = m["first_k_dense"]
    cos, sin = cos_sin(m, s, tokens.device)
    scale = softmax_scale(m)
    x = W["embed"][tokens.long()]
    for i in range(m["n_layers"]):
        a = rms_norm(x, W["ln1"][i], eps)
        q = mm(a, W["wq"][i]).view(b, s, h, dn + dr)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], dim=-1)
        kv = mm(a, W["w_kv_a"][i])
        c = rms_norm(kv[..., :r], W["kv_norm"][i], eps)
        k_rope = rope(kv[..., r:][:, :, None], cos, sin)
        k = torch.cat([mm(c, W["wk_b"][i]).view(b, s, h, dn),
                       k_rope.expand(b, s, h, dr)], dim=-1)
        v = mm(c, W["wv_b"][i]).view(b, s, h, dv)
        o = attention(q, k, v, mm, q_block, scale)
        x = x + mm(o.reshape(b, s, h * dv), W["wo"][i])
        a = rms_norm(x, W["ln2"][i], eps)
        if i < nd:
            x = x + swiglu(a, W["dense_gate"][i], W["dense_up"][i],
                           W["dense_down"][i], mm)
        else:
            x = x + moe(W, m, a.reshape(b * s, -1), i - nd, mm,
                        stats).view(b, s, -1)
    return x


@torch.no_grad()
def last_logits(W: dict, m: dict, tokens: torch.Tensor, *,
                precision: str = "fp32", q_block: int = 1024, stats=None
                ) -> torch.Tensor:
    """(B, V) logits of the last position (``stats``: see ``moe``)."""
    mm = make_mm(precision)
    x = hidden(W, m, tokens, mm=mm, q_block=q_block, stats=stats)
    return mm(rms_norm(x[:, -1], W["final_norm"], m["norm_eps"]),
              W["lm_head"])
