"""The benchmark's own counts: the chip's peaks and the operations and
bytes that a step, a prefill or a kernel needs, from shapes alone.

Peaks (NVIDIA H100 SXM data sheet, dense): TF32 495 TFLOP/s, HBM3
3.35 TB/s. The cells run fp32 with TF32 off; the fastest fp32-accurate
route on the tensor cores takes three TF32 products a product (3xTF32,
what K6 runs), so the fp32 peak here is 495 / 3 = 165 TFLOP/s.

Model FLOPs: 2 per multiply-add of every weight that enters a matmul
(``layout.MATMUL``, and the tied head once) per token that needs it,
plus 4 D per attended (q head, query, key) pair of the forward, causal
pairs S (S + 1) / 2 a sequence; training counts 3x the forward (the
backward twice), recompute not counted.
"""
from __future__ import annotations

from reference import layout, quant

PEAK_FP32_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12


def matmul_params(m: dict) -> int:
    """Parameters of the layers' matmuls (the head apart)."""
    shp = layout.shapes(m)
    n = 0
    for name in layout.MATMUL:
        size = 1
        for d in shp[name]:
            size *= d
        n += size
    return n


def head_params(m: dict) -> int:
    return m["vocab"] * m["d_model"]


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_fwd_flops(m: dict, s: int) -> float:
    """One sequence of length s, every layer, forward."""
    return (4.0 * m["head_dim"] * causal_pairs(s) * m["n_heads"]
            * m["n_layers"])


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    tokens = batch * seq
    n = matmul_params(m) + head_params(m)
    return 6.0 * n * tokens + 3.0 * batch * attention_fwd_flops(m, seq)


def prefill_flops(m: dict, s: int) -> float:
    """One prompt of length s to the last position's logits: the head on
    that position alone."""
    return (2.0 * matmul_params(m) * s + 2.0 * head_params(m)
            + attention_fwd_flops(m, s))


def k6_bound_s(m: dict, s: int) -> float:
    """K6's least time for one layer of one prompt: the larger of its
    forward flops at the fp32 peak and q, k, v, o moved once."""
    flops = 4.0 * m["head_dim"] * causal_pairs(s) * m["n_heads"]
    nbytes = 4.0 * s * m["head_dim"] * (2 * m["n_heads"]
                                        + 2 * m["n_kv_heads"])
    return max(flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def k4_bytes(total: int) -> float:
    """K4 over a flat message of ``total`` elements: x read and written
    once (4 B each), each bucket's (lo, scale) read once."""
    _, nb = quant.geometry(total)
    return 8.0 * total + 8.0 * nb


def k5_hop_bytes(total: int, n: int) -> float:
    """One hop of the rq4 ring on one rank: the incoming partition message
    (codes at 4 bits and 8 B of (lo, scale) a bucket) read, its own
    fp32 slice read, the outgoing message written."""
    granule = (8 // quant.BITS) * quant.LANES
    part = -(-(-(-total // n)) // granule) * granule
    _, nb = quant.geometry(part)
    message = part * quant.BITS / 8 + 8.0 * nb
    return 2.0 * message + 4.0 * part


def param_count(m: dict) -> int:
    size = 0
    for shape in layout.shapes(m).values():
        n = 1
        for d in shape:
            n *= d
        size += n
    return size


# The program's kernels by the profiler's names (regular expressions)
K1_KERNEL = r"\bminmax_kernel\b"
K4_KERNEL = r"\bqdq_kernel\b"
K6_KERNEL = r"\bflash_fwd\b"
K5_KERNEL = r"\bhop_kernel\b"
GEMM_KERNELS = r"gemm|gemv|splitkreduce"
