"""The benchmark's counts for DeepSeek-V2-Lite's prefill, from shapes
alone (peaks from ``yardstick``: fp32-accurate 3xTF32 at 165 TFLOP/s,
HBM at 3.35 TB/s).

Active model FLOPs of one prompt of S tokens to the last position's
logits: 2 per multiply-add of each weight a token uses (MLA's
projections in every layer, the dense FFN of the first layers, the
router, the shared experts and ``top_k`` routed experts of each MoE
layer), plus 2 (Dqk + Dv) per attended causal (head, query, key)
(q.k over Dqk = nope + rope, p.v over Dv), plus the head on the last
position.
"""
from __future__ import annotations

import yardstick

PEAK_FP32_FLOPS = yardstick.PEAK_FP32_FLOPS
HBM_BYTES_PER_S = yardstick.HBM_BYTES_PER_S

# K6's instantiation at MLA's head dims (q.k 192, p.v 128), by the
# profiler's kernel name; the square D 64/128 instantiations do not match
MLA_KERNEL = r"\bflash_fwd<\s*float,\s*192\b"


def head_dims(m: dict) -> tuple:
    return m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"]


def active_params(m: dict) -> int:
    """Weights in a token's matmuls, the head apart."""
    d, h, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    qk, dv = head_dims(m)
    mla = (d * h * qk + d * (r + m["qk_rope_head_dim"])
           + r * h * m["qk_nope_head_dim"] + r * h * dv + h * dv * d)
    nd = m["first_k_dense"]
    expert = 3 * d * m["d_ff_expert"]
    moe = d * m["n_experts"] + (m["n_shared"] + m["top_k"]) * expert
    return (m["n_layers"] * mla + nd * 3 * d * m["d_ff"]
            + (m["n_layers"] - nd) * moe)


def attention_flops(m: dict, s: int) -> float:
    """One prompt of length s, every layer."""
    qk, dv = head_dims(m)
    return (2.0 * (qk + dv) * yardstick.causal_pairs(s) * m["n_heads"]
            * m["n_layers"])


def prefill_flops(m: dict, s: int) -> float:
    return (2.0 * active_params(m) * s + 2.0 * m["d_model"] * m["vocab"]
            + attention_flops(m, s))


def mla_bound_s(m: dict, s: int) -> float:
    """K6 at MLA's head dims, one layer of one prompt: the larger of its
    flops at the fp32 peak and q, k (Dqk) and v, out (Dv) moved once."""
    qk, dv = head_dims(m)
    h = m["n_heads"]
    flops = 2.0 * (qk + dv) * yardstick.causal_pairs(s) * h
    nbytes = 4.0 * s * h * (2 * qk + 2 * dv)
    return max(flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
