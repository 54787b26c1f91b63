"""Plain PyTorch versions of the codec kernels (the CPU path and the
yardstick ``chip_smoke.py`` holds the CUDA kernels against).

Bit-for-bit equal to the JAX package's jitted reference
(``repro.kernels.quant.ref`` under XLA) given the same uniforms, which
takes three choices that a literal transcription gets wrong:

  * scale = ``(hi - lo) * f32(1 / levels)``: XLA compiles the division
    by the constant ``levels`` as a multiply by its fp32 reciprocal;
  * decode = ``code * scale + lo`` with ONE rounding: XLA contracts it
    into a fused multiply-add. In float64 the product is exact (a code
    has at most 8 bits, scale 24), so rounding the float64 sum once to
    float32 matches the FMA (in all but sums that need more than 53
    bits, i.e. a bucket whose range is a few ulps of its offset);
  * encode = a true fp32 division ``(x - lo) / scale``.

Layouts follow ``repro.kernels.quant``: a bucket of pack * R * 512
elements is pack contiguous (R, 512) segments, and payload byte (r, c)
packs ``code_k << k * bits`` over the segments k.

K2, K4 and K5 draw their uniforms themselves, so their plain versions
(``encode_packed_keyed``, ``qdq_keyed``, ``decode_add_encode_hop``) take
the keys, draw with ``core.prng`` and run the literal form of the TPU
kernel that takes the uniforms as an input (``encode_packed_bucketed``,
``qdq_bucketed``, ``decode_add_encode_bucketed``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng


def levels_of(bits: int) -> int:
    return (1 << bits) - 1


def minmax_bucketed(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket (lo, hi) of a (B, cap) view; NaN propagates."""
    x2 = x2.reshape(x2.shape[0], -1).float()
    return x2.amin(dim=1), x2.amax(dim=1)


def scale_of(lo: torch.Tensor, hi: torch.Tensor, bits: int) -> torch.Tensor:
    """``where(hi > lo, (hi - lo) * f32(1/levels), 1)``, the jitted form."""
    inv = float(np.float32(1.0 / levels_of(bits)))
    return torch.where(hi > lo, (hi - lo) * inv, torch.ones_like(lo))


def _bcast(v: torch.Tensor) -> torch.Tensor:
    """(B,) per-bucket param -> broadcastable against (B, pack, R, C)."""
    return v.reshape(-1, 1, 1, 1)


def encode(x: torch.Tensor, u: torch.Tensor, lo, scale, *,
           bits: int) -> torch.Tensor:
    """Stochastic round to b-bit codes (uint8). A NaN code becomes 0, as
    XLA's float -> uint8 cast makes it (the kernels do the same)."""
    norm = (x.float() - lo) / scale
    floor = torch.floor(norm)
    q = floor + (u < (norm - floor)).float()
    q = torch.nan_to_num(q, nan=0.0)
    return torch.clamp(q, 0.0, float(levels_of(bits))).to(torch.uint8)


def decode(codes: torch.Tensor, lo, scale) -> torch.Tensor:
    """``codes * scale + lo`` rounded once (see the module note)."""
    lo = lo.double() if isinstance(lo, torch.Tensor) else float(lo)
    scale = scale.double() if isinstance(scale, torch.Tensor) \
        else float(scale)
    return (codes.double() * scale + lo).float()


def pack_codes(codes: torch.Tensor, *, bits: int) -> torch.Tensor:
    """(..., pack, R, C) codes -> (..., R, C) uint8 payload: byte (r, c)
    holds ``code_k << k * bits`` over the segments k."""
    pack = codes.shape[-3]
    if pack != 8 // bits:
        raise ValueError(f"pack {pack} does not match bits {bits}")
    acc = torch.zeros(codes.shape[:-3] + codes.shape[-2:], dtype=torch.int32,
                      device=codes.device)
    for k in range(pack):
        acc |= codes.select(-3, k).to(torch.int32) << (k * bits)
    return acc.to(torch.uint8)


def unpack_codes(payload: torch.Tensor, *, bits: int) -> torch.Tensor:
    """(..., R, C) uint8 payload -> (..., pack, R, C) codes."""
    pack = 8 // bits
    shifts = (torch.arange(pack, dtype=torch.int32, device=payload.device)
              * bits).reshape(pack, 1, 1)
    return (payload.to(torch.int32).unsqueeze(-3) >> shifts) \
        & levels_of(bits)


def qdq(x: torch.Tensor, u: torch.Tensor, lo, scale, *,
        bits: int) -> torch.Tensor:
    """Quantize and dequantize, fused: ``decode(encode(...))`` for finite
    inputs (the codes are small exact integers), with the codes kept in
    fp32 instead of uint8 so that a NaN stays NaN, as in the reference's
    ``clip``; one rounding for ``q * scale + lo`` (see the module note)."""
    norm = (x.float() - lo) / scale
    floor = torch.floor(norm)
    q = floor + (u < (norm - floor)).float()
    return decode(torch.clamp(q, 0.0, float(levels_of(bits))), lo, scale)


def encode_packed_bucketed(x4: torch.Tensor, u4: torch.Tensor,
                           lo: torch.Tensor, scale: torch.Tensor, *,
                           bits: int) -> torch.Tensor:
    """(B, pack, R, C) segments + per-bucket (B,) params -> (B, R, C)."""
    return pack_codes(encode(x4, u4, _bcast(lo), _bcast(scale), bits=bits),
                      bits=bits)


def qdq_bucketed(x4: torch.Tensor, u4: torch.Tensor, lo: torch.Tensor,
                 scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """(B, pack, R, C) segments + per-bucket (B,) params -> the same
    shape, quantized and dequantized (``qdq`` per bucket)."""
    return qdq(x4, u4, _bcast(lo), _bcast(scale), bits=bits)


def fold_keys(key, first: int, n: int) -> list:
    """The keys of buckets first .. first + n - 1 of a flat buffer drawn
    under ``key``: ``fold_in(key, b)`` each."""
    return [prng.fold_in(key, first + b) for b in range(n)]


def keyed_uniforms(keys, shape, *, device) -> torch.Tensor:
    """(len(keys), *shape) fp32: row b is ``prng.uniform(keys[b],
    shape)``, drawn once for a key that repeats."""
    u = torch.empty((len(keys),) + tuple(shape), dtype=torch.float32,
                    device=device)
    drawn: dict = {}
    for i, key in enumerate(keys):
        words = prng.key_words(key)
        if words in drawn:
            u[i] = u[drawn[words]]
        else:
            u[i] = prng.uniform(key, tuple(shape), device=device)
            drawn[words] = i
    return u


def encode_packed_keyed(x4: torch.Tensor, keys, lo: torch.Tensor,
                        scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """K2's plain version: bucket (or leaf) b of the (B, pack, R, C) x4
    against ``prng.uniform(keys[b], (pack, R, C))`` -> (B, R, C)."""
    u4 = keyed_uniforms(keys, x4.shape[1:], device=x4.device)
    return encode_packed_bucketed(x4, u4, lo, scale, bits=bits)


def qdq_keyed(x4: torch.Tensor, keys, lo: torch.Tensor, scale: torch.Tensor,
              *, bits: int) -> torch.Tensor:
    """K4's plain version: ``qdq_bucketed`` of x4 against the uniforms of
    ``keys`` (one a bucket or leaf), as ``encode_packed_keyed`` draws
    them."""
    u4 = keyed_uniforms(keys, x4.shape[1:], device=x4.device)
    return qdq_bucketed(x4, u4, lo, scale, bits=bits)


def decode_packed_bucketed(payload: torch.Tensor, lo: torch.Tensor,
                           scale: torch.Tensor, *,
                           bits: int) -> torch.Tensor:
    """(B, R, C) payload + per-bucket (B,) params -> (B, pack, R, C)."""
    return decode(unpack_codes(payload, bits=bits), _bcast(lo),
                  _bcast(scale))


# ---------------------------------------------------------------------------
# The per-leaf forms (one message per leaf, one (lo, scale) over the whole
# leaf): the JAX package's ``ref.quant_params`` .. ``quantize_dequantize``.
# The uniforms ``u`` come in the caller's view of the zero-padded leaf.
# ---------------------------------------------------------------------------


def quant_params(x: torch.Tensor, bits: int) -> tuple:
    """(lo, scale) over the whole of ``x`` (NaN propagates into both)."""
    lo, hi = minmax_bucketed(x.reshape(1, -1))
    return lo[0], scale_of(lo, hi, bits)[0]


def encode_packed(x3: torch.Tensor, u3: torch.Tensor, lo, scale, *,
                  bits: int) -> torch.Tensor:
    """(pack, R, C) segments -> (R, C) uint8 payload."""
    return pack_codes(encode(x3, u3, lo, scale, bits=bits), bits=bits)


def decode_packed(payload: torch.Tensor, lo, scale, *,
                  bits: int) -> torch.Tensor:
    """(R, C) uint8 payload -> (pack, R, C) dequantized fp32 segments."""
    return decode(unpack_codes(payload, bits=bits), lo, scale)


def quantize_dequantize(x: torch.Tensor, u: torch.Tensor, *,
                        bits: int) -> torch.Tensor:
    """``qdq`` under the leaf's own (lo, scale), cast back to x's dtype."""
    lo, scale = quant_params(x, bits)
    return qdq(x, u, lo, scale, bits=bits).to(x.dtype)


def decode_add_encode_bucketed(payload: torch.Tensor, params: torch.Tensor,
                               x4: torch.Tensor, u4: torch.Tensor, *,
                               bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused ring hop, plainly: decode the (B, R, C) payload with its
    (B, 2) params, add the (B, pack, R, C) addend, take each bucket's
    range and scale, and re-encode against u4 -> ((B, R, C) uint8,
    (B, 2) [lo, scale]). The literal composition of the JAX package's
    ``ops._dae_ref`` (the TPU kernel's function, fed its uniforms)."""
    summed = decode_packed_bucketed(payload, params[:, 0], params[:, 1],
                                    bits=bits) + x4
    lo, hi = minmax_bucketed(summed)
    scale = scale_of(lo, hi, bits)
    out = encode_packed_bucketed(summed, u4, lo, scale, bits=bits)
    return out, torch.stack([lo, scale], dim=1)


def decode_add_encode_keyed(payload: torch.Tensor, params: torch.Tensor,
                            local: torch.Tensor, key, *, bits: int,
                            rows_b: int, rt: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One partition's ring hop with its own uniforms: the (rows, C)
    payload and (nb, 2) params of the incoming message, the local
    (pack * rows * C,) fp32 slice, nb - 1 full buckets of ``rows_b`` rows
    and a tail bucket of ``rt``; bucket b re-encodes against
    ``prng.uniform(fold_in(key, b), (pack, R, C))`` -> ((rows, C) uint8,
    (nb, 2) [lo, scale]). The JAX package's ``decode_add_encode_flat`` on
    a granule-aligned buffer: its draws, then the TPU kernel's function
    on the full buckets and on the tail as B = 1."""
    pack, nb, lanes = 8 // bits, params.shape[0], payload.shape[1]
    head_rows = (nb - 1) * rows_b
    head_elems = head_rows * pack * lanes
    parts = []
    if nb > 1:
        u4 = keyed_uniforms(fold_keys(key, 0, nb - 1), (pack, rows_b, lanes),
                            device=local.device)
        parts.append(decode_add_encode_bucketed(
            payload[:head_rows].view(nb - 1, rows_b, lanes), params[:nb - 1],
            local[:head_elems].view(nb - 1, pack, rows_b, lanes), u4,
            bits=bits))
        del u4
    u3 = keyed_uniforms(fold_keys(key, nb - 1, 1), (pack, rt, lanes),
                        device=local.device)
    parts.append(decode_add_encode_bucketed(
        payload[head_rows:].view(1, rt, lanes), params[nb - 1:],
        local[head_elems:].view(1, pack, rt, lanes), u3, bits=bits))
    return (torch.cat([o.reshape(-1, lanes) for o, _ in parts]),
            torch.cat([p for _, p in parts]))


def decode_add_encode_hop(payloads, params, locals_, keys, *, bits: int,
                          rows_b: int, rt: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: ``decode_add_encode_keyed`` of each worker's
    (payload, params, local, key), stacked -> ((N, rows, C) uint8,
    (N, nb, 2))."""
    outs = [decode_add_encode_keyed(p, q, x, k, bits=bits, rows_b=rows_b,
                                    rt=rt)
            for p, q, x, k in zip(payloads, params, locals_, keys)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([p for _, p in outs]))
