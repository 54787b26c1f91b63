"""The codec's geometry and kernel dispatch: the per-leaf
tier (one message per leaf) and the bucketed flat-buffer tier.

The port of ``repro.kernels.quant.ops``: the per-leaf
``quantize_dequantize`` / ``encode`` / ``decode`` (see their section
below), and the bucketed tier on the checkpoint wire's path
(``encode_flat`` / ``decode_flat`` and their geometry), on the training
step's (``qdq_flat``) and on the ring AllReduce's
(``partition_geometry``, the fused hop ``decode_add_encode_flat`` and
its N-worker form ``decode_add_encode_partitions``). The bucketed wire
layout is the JAX package's, byte for byte:

  * the flat fp32 buffer is cut into buckets of ``cap`` elements (a
    granule-aligned cap on ``bucket_elems``); bucket b owns elements
    [b*cap, (b+1)*cap) and one [lo, scale] params row;
  * the buffer is edge-padded ONCE to n_buckets * cap by repeating its
    last REAL element, so the pad never moves a bucket's (lo, hi);
  * full buckets are segment-packed as (pack, Rb, 512) views and go to
    ONE bucketed kernel launch; the last (tail) bucket is padded only to
    the pack*512 granule, gets its own Rt = ceil(t / granule) rows, and
    goes as a B = 1 launch of the same kernel;
  * bucket b draws its uniforms under ``fold_in(key, b)`` (the JAX
    package's ``bucket_key``) with the port's threefry, which gives the JAX
    package's bits — so the published payload equals JAX's, and
    ``qdq_flat`` equals ``decode_flat(encode_flat(...))`` bit for bit. K2,
    K4 and K5 draw them on the card themselves from the root key and the
    bucket's index; on the CPU their plain versions draw with
    ``core.prng``. No uniform tensor is made on the card.

Dispatch follows the tensor's device (see ``kernel.py``): the CUDA
kernels for a CUDA buffer, the plain versions for a CPU one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.quant import kernel, ref
from repro_torch.obs import flight as obs_flight

LANES = 512

# Elements per quantization bucket (4Mi elements = 16 MiB fp32 per
# bucket); one [lo, scale] params row each. repro_torch.core.compression
# re-exports it.
DEFAULT_BUCKET_ELEMS = 1 << 22


def _align_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flat_geometry(total: int, *, bits: int,
                  bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """Static bucket geometry for a flat buffer of ``total`` elements.

    Returns (pack, cap, n_buckets, rows_per_bucket, rows_kept):
      cap             elements per full bucket (granule-aligned cap on
                      ``bucket_elems``, shrunk for small buffers);
      rows_per_bucket payload rows each full bucket contributes;
      rows_kept       total payload rows on the wire — Rb per full bucket
                      plus the tail bucket's granule-aligned Rt.
    """
    if total <= 0:
        raise ValueError(f"empty flat buffer (total={total})")
    pack = 8 // bits
    granule = pack * LANES
    cap = _align_up(min(bucket_elems, total), granule)
    n_buckets = -(-total // cap)
    rows_b = cap // granule
    tail = total - (n_buckets - 1) * cap
    rows_kept = (n_buckets - 1) * rows_b + -(-tail // granule)
    return pack, cap, n_buckets, rows_b, rows_kept


def leaf_payload_rows(n: int, *, bits: int) -> int:
    """Payload rows of ONE leaf of ``n`` elements in the per-leaf packed
    format (one message per leaf, params (1, 2)): the leaf is zero-padded
    to the pack*512 granule and packs ``pack`` codes a byte, so it takes
    ceil(n / granule) rows of 512 bytes."""
    return -(-int(n) // ((8 // bits) * LANES))


# ---------------------------------------------------------------------------
# The per-leaf tier: one message per leaf, the JAX package's
# ``quantize_dequantize`` / ``encode`` / ``decode``. Its geometry is not the
# fused tier's:
#   * the leaf is ZERO-padded to a multiple of pack*512 (``_to_2d``), not
#     edge-padded;
#   * (lo, scale) come from the UNPADDED leaf, the scale as ``ref.scale_of``;
#   * ONE draw ``uniform(key, (pack * R, 512))``, whose flat order is both
#     qdq's (R*pack, 512) view and encode's (pack, R, 512) view, so
#     decode(encode(x, k)) == quantize_dequantize(x, k) bit for bit; K4
#     and K2 draw it themselves, from the leaf's key.
# The ``*_rows`` forms take one leaf of each of N stacked workers (a leading
# dim N, one key each) and launch ONE kernel over the N leaf messages, as N
# buckets of the bucketed kernel with a params row each; the single-leaf
# forms are N = 1.
# ---------------------------------------------------------------------------


def leaf_params(x2: torch.Tensor, *, bits: int) -> torch.Tensor:
    """(N, 2) [lo, scale] of each row of an (N, n) fp32 view, over its n
    real elements. The JAX package takes them outside any Pallas kernel
    (``ref.quant_params``, a jnp reduction), so they come from one
    ``torch.aminmax`` pass here, on either device; NaN propagates into
    lo and hi, as ``jnp.minimum``'s reduction propagates it."""
    lo, hi = torch.aminmax(x2, dim=1)
    return torch.stack([lo, ref.scale_of(lo, hi, bits)], dim=1)


def _leaf_rows(x_w: torch.Tensor, keys, *, bits: int):
    """A stacked leaf (N, ...) -> x4 (N, pack, R, 512), each row
    zero-padded, in fp32, and (N, 2) params from the unpadded rows; the
    kernels draw each row's uniforms under its key."""
    nw = x_w.shape[0]
    if len(keys) != nw:
        raise ValueError(f"{nw} rows but {len(keys)} keys")
    n = x_w[0].numel()
    pack = 8 // bits
    rows = leaf_payload_rows(n, bits=bits)
    x4 = torch.zeros((nw, pack, rows, LANES), dtype=torch.float32,
                     device=x_w.device)
    xf = x4.view(nw, -1)
    xf[:, :n] = x_w.reshape(nw, n)
    return x4, leaf_params(xf[:, :n], bits=bits)


def _leaf_out(out4: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    """(N, pack, R, 512) fp32 -> (N, *shape) in ``dtype``, pad dropped."""
    nw = out4.shape[0]
    n = math.prod(shape)
    return out4.reshape(nw, -1)[:, :n].reshape((nw,) + tuple(shape)).to(
        dtype)


@obs_flight.kernel_annotation("quant.qdq")
def quantize_dequantize_rows(x_w: torch.Tensor, keys, *, bits: int = 8
                             ) -> torch.Tensor:
    """Per-leaf stochastic quantize -> dequantize of each row of a
    stacked leaf (N, ...) under its key: ONE K4 launch (``leaf_qdq``)
    over the N leaf messages. Same shape and dtype as ``x_w``."""
    x4, params = _leaf_rows(x_w, keys, bits=bits)
    out = kernel.leaf_qdq(x4, keys, params, bits=bits, out=x4)
    return _leaf_out(out, tuple(x_w.shape[1:]), x_w.dtype)


@obs_flight.kernel_annotation("quant.encode")
def encode_rows(x_w: torch.Tensor, keys, *, bits: int = 8):
    """Per-leaf encode of each row of a stacked leaf: ONE K2 launch
    (``leaf_encode_packed``) -> (payload (N, R, 512) uint8, params
    (N, 2))."""
    x4, params = _leaf_rows(x_w, keys, bits=bits)
    return kernel.leaf_encode_packed(x4, keys, params, bits=bits), params


@obs_flight.kernel_annotation("quant.decode")
def decode_rows(payload: torch.Tensor, params: torch.Tensor, *,
                shape: tuple, bits: int = 8, dtype=torch.float32
                ) -> torch.Tensor:
    """Inverse of ``encode_rows``: ONE K3 launch (``leaf_decode_packed``)
    over the (N, R, 512) payloads -> (N, *shape) in ``dtype``."""
    rows = leaf_payload_rows(math.prod(shape), bits=bits)
    if payload.dim() != 3 or tuple(payload.shape[1:]) != (rows, LANES):
        raise ValueError(f"payload {tuple(payload.shape)} does not hold a "
                         f"leaf of shape {tuple(shape)} at bits={bits}: "
                         f"need (N, {rows}, {LANES})")
    out = kernel.leaf_decode_packed(payload, params, bits=bits)
    return _leaf_out(out, tuple(shape), dtype)


def quantize_dequantize(x: torch.Tensor, key, *, bits: int = 8
                        ) -> torch.Tensor:
    """Fused per-leaf Q(x) with stochastic rounding (JAX's
    ``ops.quantize_dequantize``); same shape and dtype as x."""
    return quantize_dequantize_rows(x[None], [key], bits=bits)[0]


def encode(x: torch.Tensor, key, *, bits: int = 8):
    """-> (payload uint8 (R, 512), params (1, 2)), JAX's ``ops.encode``.
    Wire bytes = payload.nbytes + params.nbytes."""
    payload, params = encode_rows(x[None], [key], bits=bits)
    return payload[0], params


def decode(payload: torch.Tensor, params: torch.Tensor, *, shape: tuple,
           bits: int = 8, dtype=torch.float32) -> torch.Tensor:
    """Unpack + dequantize a per-leaf payload back to ``shape``."""
    return decode_rows(payload[None], params.reshape(1, 2), shape=shape,
                       bits=bits, dtype=dtype)[0]


def partition_geometry(total: int, n_parts: int, *, bits: int,
                       bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """Equal, granule-aligned N-way partition view of a flat buffer (the
    ring AllReduce's reduce-scatter / all-gather unit).

    Returns (part_elems, nb_p, rows_p): each of the n_parts partitions
    owns part_elems contiguous elements of the (edge-padded to
    n_parts * part_elems) flat buffer and has its own bucket rows: nb_p
    [lo, scale] params rows and rows_p payload rows. Per-partition wire
    bytes = rows_p * LANES + nb_p * 8.
    """
    if n_parts <= 0:
        raise ValueError(f"need n_parts >= 1, got {n_parts}")
    granule = (8 // bits) * LANES
    part_elems = _align_up(max(1, -(-total // n_parts)), granule)
    _, _, nb_p, _, rows_p = flat_geometry(part_elems, bits=bits,
                                          bucket_elems=bucket_elems)
    return part_elems, nb_p, rows_p


def edge_pad(flat: torch.Tensor, padded_len: int) -> torch.Tensor:
    """``flat`` followed by copies of its last element, ``padded_len``
    long (``flat`` itself when no pad is needed)."""
    n = flat.shape[0]
    if padded_len == n:
        return flat
    out = torch.empty((padded_len,), dtype=flat.dtype, device=flat.device)
    out[:n] = flat
    out[n:] = flat[n - 1]
    return out


def bucket_params(x2: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Per-bucket (n_buckets, 2) [lo, scale] rows from ONE read of the
    (n_buckets, cap) view (K1), scale finalized in plain torch."""
    nb, cap = x2.shape
    mm = kernel.minmax_bucketed(x2.reshape(nb, cap // LANES, LANES))
    lo, hi = mm[:, 0], mm[:, 1]
    return torch.stack([lo, ref.scale_of(lo, hi, bits)], dim=1)


def _bucket_views(padded: torch.Tensor, total: int, *, bits: int,
                  bucket_elems: int):
    """Head/tail segment views of an edge-padded buffer and the
    per-bucket params; the kernels draw bucket b's uniforms under
    ``fold_in(key, b)``."""
    pack, cap, nb, rows_b, _ = flat_geometry(total, bits=bits,
                                             bucket_elems=bucket_elems)
    if padded.shape != (nb * cap,) or padded.dtype != torch.float32:
        raise ValueError(f"need an edge-padded ({nb * cap},) fp32 buffer, "
                         f"got {tuple(padded.shape)} {padded.dtype}")
    granule = pack * LANES
    head_elems = (nb - 1) * cap
    rt = -(-(total - head_elems) // granule)
    params = bucket_params(padded.view(nb, cap), bits=bits)
    x4 = None
    if nb > 1:
        x4 = padded[:head_elems].view(nb - 1, pack, rows_b, LANES)
    x3 = padded[head_elems:head_elems + rt * granule].view(1, pack, rt,
                                                           LANES)
    return x4, x3, params, (nb, rows_b, rt)


def encode_padded(padded: torch.Tensor, total: int, key, *, bits: int = 8,
                  bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """``encode_flat`` of a buffer already edge-padded to n_buckets * cap
    (what ``FlatLayout.flatten(tree, padded=True)`` produces)."""
    x4, x3, params, (nb, rows_b, rt) = _bucket_views(
        padded, total, bits=bits, bucket_elems=bucket_elems)
    head_rows = (nb - 1) * rows_b
    payload = torch.empty((head_rows + rt, LANES), dtype=torch.uint8,
                          device=padded.device)
    if nb > 1:
        kernel.encode_packed(x4, key, params[:nb - 1], bits=bits,
                             out=payload[:head_rows].view(nb - 1, rows_b,
                                                          LANES))
    kernel.encode_packed(x3, key, params[nb - 1:], bits=bits,
                         first_bucket=nb - 1,
                         out=payload[head_rows:].view(1, rt, LANES))
    return payload, params


@obs_flight.kernel_annotation("quant.encode_flat")
def encode_flat(flat: torch.Tensor, key, *, bits: int = 8,
                bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """Bucketed encode of a flat fp32 buffer.

    Returns (payload uint8 (rows_kept, 512), params fp32 (n_buckets, 2)).
    Wire bytes = payload.nbytes + params.nbytes."""
    flat = flat.reshape(-1).float()
    total = flat.shape[0]
    _, cap, nb, _, _ = flat_geometry(total, bits=bits,
                                     bucket_elems=bucket_elems)
    return encode_padded(edge_pad(flat, nb * cap), total, key, bits=bits,
                         bucket_elems=bucket_elems)


@obs_flight.kernel_annotation("quant.decode_flat")
def decode_flat(payload: torch.Tensor, params: torch.Tensor, *, total: int,
                bits: int = 8, bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unpack + dequantize a bucketed wire payload to (total,) fp32 (into
    ``out`` when given): the full buckets decode straight into the
    output, the tail through a Rt-row temporary trimmed to its t real
    elements."""
    pack, cap, nb, rows_b, rows_kept = flat_geometry(
        total, bits=bits, bucket_elems=bucket_elems)
    if tuple(payload.shape) != (rows_kept, LANES) or \
            tuple(params.shape) != (nb, 2):
        raise ValueError(
            f"wire shapes {tuple(payload.shape)}, {tuple(params.shape)} do "
            f"not match total={total} bits={bits} bucket_elems="
            f"{bucket_elems}: expected ({rows_kept}, {LANES}), ({nb}, 2)")
    head_rows = (nb - 1) * rows_b
    head_elems = (nb - 1) * cap
    rt = rows_kept - head_rows
    if out is None:
        out = torch.empty((total,), dtype=torch.float32,
                          device=payload.device)
    if tuple(out.shape) != (total,) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous ({total},) buffer, got "
                         f"{tuple(out.shape)}")
    if nb > 1:
        kernel.decode_packed(
            payload[:head_rows].view(nb - 1, rows_b, LANES), params[:nb - 1],
            bits=bits, out=out[:head_elems].view(nb - 1, pack, rows_b, LANES))
    tail = kernel.decode_packed(payload[head_rows:].view(1, rt, LANES),
                                params[nb - 1:], bits=bits)
    out[head_elems:] = tail.reshape(-1)[:total - head_elems]
    return out


@obs_flight.kernel_annotation("quant.qdq_flat")
def qdq_flat(flat: torch.Tensor, key, *, bits: int = 8,
             bucket_elems: int = DEFAULT_BUCKET_ELEMS,
             donate: bool = False) -> torch.Tensor:
    """Fused per-bucket stochastic quantize -> dequantize of a flat fp32
    buffer (the training step's gradient compression): the full buckets
    in ONE K4 launch, the tail bucket as a B = 1 launch, with the
    draws and params of ``encode_flat`` — so the result equals
    ``decode_flat(encode_flat(flat, key))`` bit for bit.

    K4 writes over the edge-padded buffer when the pad made one (it is
    this function's own), and over ``flat`` itself when ``donate`` is
    set and no pad was needed; otherwise into a new buffer. The tail
    launch writes in place too, so nothing else of a bucket's size is
    made. Returns a (total,) fp32 tensor."""
    flat = flat.reshape(-1).float()
    total = flat.shape[0]
    _, cap, nb, _, _ = flat_geometry(total, bits=bits,
                                     bucket_elems=bucket_elems)
    padded = edge_pad(flat, nb * cap)
    x4, x3, params, _ = _bucket_views(
        padded, total, bits=bits, bucket_elems=bucket_elems)
    out = padded if (padded is not flat or donate) \
        else torch.empty_like(padded)
    head_elems = (nb - 1) * cap
    if nb > 1:
        kernel.qdq_bucketed(x4, key, params[:nb - 1], bits=bits,
                            out=out[:head_elems].view(x4.shape))
    kernel.qdq_bucketed(x3, key, params[nb - 1:], bits=bits,
                        first_bucket=nb - 1,
                        out=out[head_elems:head_elems + x3.numel()].view(
                            x3.shape))
    return out[:total]


@obs_flight.kernel_annotation("quant.decode_add_encode_flat")
def decode_add_encode_flat(payload: torch.Tensor, params: torch.Tensor,
                           local: torch.Tensor, key, *, bits: int = 8,
                           bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """ONE fused ring hop over a flat message: decode the packed payload,
    add the ``local`` fp32 buffer and re-encode under ``key`` -> (payload
    (rows_kept, 512) uint8, params (n_buckets, 2)). Bit-identical to

        encode_flat(decode_flat(payload, params, total=local.numel())
                    + local, key)

    A granule-aligned buffer (every ring partition, by
    ``partition_geometry``) goes to K5 as a hop of one worker: one call
    over the full buckets and the tail, drawing the uniforms of
    ``encode_flat`` itself. Other sizes take that sequential composition,
    as the JAX package does: K5 does not reproduce the edge pad of a
    short tail."""
    total = local.numel()
    pack = 8 // bits
    flat = local.reshape(-1).float()
    if total % (pack * LANES):
        dec = decode_flat(payload, params, total=total, bits=bits,
                          bucket_elems=bucket_elems)
        return encode_flat(dec.add_(flat), key, bits=bits,
                           bucket_elems=bucket_elems)
    out, out_params = decode_add_encode_partitions(
        [payload], [params], [flat], [key], bits=bits,
        bucket_elems=bucket_elems)
    return out[0], out_params[0]


def decode_add_encode_partitions(payloads, params, locals_, keys, *,
                                 bits: int = 8,
                                 bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                                 out: Optional[torch.Tensor] = None,
                                 params_out: Optional[torch.Tensor] = None):
    """One reduce-scatter hop of the partitioned ring for N workers at
    once (K5, one call): worker w decodes ``payloads[w]`` /
    ``params[w]``, adds its granule-aligned (part_elems,) slice
    ``locals_[w]`` and re-encodes under ``keys[w]`` -> (payloads (N,
    rows_p, 512) uint8, params (N, nb_p, 2)), into ``out`` /
    ``params_out`` when given. Worker w's result equals
    ``decode_add_encode_flat(payloads[w], params[w], locals_[w],
    keys[w])``. The inputs may be views (another worker's message, a
    window of the stacked gradient); the outputs may not overlap them."""
    part = locals_[0].numel()
    pack, _, nb, rows_b, rows_kept = flat_geometry(
        part, bits=bits, bucket_elems=bucket_elems)
    if part % (pack * LANES):
        raise ValueError(f"a ring partition is granule-aligned: {part} "
                         f"elements is not a multiple of {pack * LANES}")
    return kernel.decode_add_encode_bucketed(
        payloads, params, [t.reshape(-1) for t in locals_], keys, bits=bits,
        rows_b=rows_b, rt=rows_kept - (nb - 1) * rows_b, out=out,
        params_out=params_out)
