"""Bucketed flat-buffer codec: geometry, uniform draws and kernel dispatch.

The port of the parts of ``repro.kernels.quant.ops`` on the checkpoint
wire's path (``encode_flat`` / ``decode_flat`` and their geometry), on
the training step's (``qdq_flat``) and on the ring AllReduce's
(``partition_geometry``, the fused hop ``decode_add_encode_flat`` and
its N-worker form ``decode_add_encode_partitions``). The wire layout is
the JAX package's, byte for byte:

  * the flat fp32 buffer is cut into buckets of ``cap`` elements (a
    granule-aligned cap on ``bucket_elems``); bucket b owns elements
    [b*cap, (b+1)*cap) and one [lo, scale] params row;
  * the buffer is edge-padded ONCE to n_buckets * cap by repeating its
    last REAL element, so the pad never moves a bucket's (lo, hi);
  * full buckets are segment-packed as (pack, Rb, 512) views and go to
    ONE bucketed kernel launch; the last (tail) bucket is padded only to
    the pack*512 granule, gets its own Rt = ceil(t / granule) rows, and
    goes as a B = 1 launch of the same kernel;
  * bucket b draws its uniforms under ``bucket_key(key, b)`` =
    ``fold_in(key, b)`` with the port's threefry (K5 hashes the same
    counters on the card itself), which gives the JAX package's bits — so the published payload equals JAX's, and
    ``qdq_flat`` equals ``decode_flat(encode_flat(...))`` bit for bit.

Dispatch follows the tensor's device (see ``kernel.py``): the CUDA
kernels for a CUDA buffer, the plain versions for a CPU one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import prng
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
    ceil(n / granule) rows of 512 bytes. Only the size is ported: the
    per-leaf encode itself is not."""
    return -(-int(n) // ((8 // bits) * LANES))


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


def bucket_key(key, b: int):
    """Bucket b's uniform-draw key: fold_in(key, b)."""
    return prng.fold_in(key, b)


def bucket_params(x2: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Per-bucket (n_buckets, 2) [lo, scale] rows from ONE read of the
    (n_buckets, cap) view (K1), scale finalized in plain torch."""
    nb, cap = x2.shape
    mm = kernel.minmax_bucketed(x2.reshape(nb, cap // LANES, LANES))
    lo, hi = mm[:, 0], mm[:, 1]
    return torch.stack([lo, ref.scale_of(lo, hi, bits)], dim=1)


def _bucket_views(padded: torch.Tensor, total: int, key, *, bits: int,
                  bucket_elems: int):
    """Head/tail segment views of an edge-padded buffer, their uniforms
    and the per-bucket params."""
    pack, cap, nb, rows_b, _ = flat_geometry(total, bits=bits,
                                             bucket_elems=bucket_elems)
    if padded.shape != (nb * cap,) or padded.dtype != torch.float32:
        raise ValueError(f"need an edge-padded ({nb * cap},) fp32 buffer, "
                         f"got {tuple(padded.shape)} {padded.dtype}")
    granule = pack * LANES
    head_elems = (nb - 1) * cap
    t = total - head_elems
    rt = -(-t // granule)
    dev = padded.device
    params = bucket_params(padded.view(nb, cap), bits=bits)
    x4 = u4 = None
    if nb > 1:
        x4 = padded[:head_elems].view(nb - 1, pack, rows_b, LANES)
        u4 = _head_uniforms(key, nb, pack, rows_b, dev)
    x3 = padded[head_elems:head_elems + rt * granule].view(1, pack, rt,
                                                           LANES)
    u3 = prng.uniform(bucket_key(key, nb - 1), (1, pack, rt, LANES),
                      device=dev)
    return x4, u4, x3, u3, params, (nb, rows_b, rt)


def encode_padded(padded: torch.Tensor, total: int, key, *, bits: int = 8,
                  bucket_elems: int = DEFAULT_BUCKET_ELEMS):
    """``encode_flat`` of a buffer already edge-padded to n_buckets * cap
    (what ``FlatLayout.flatten(tree, padded=True)`` produces)."""
    x4, u4, x3, u3, params, (nb, rows_b, rt) = _bucket_views(
        padded, total, key, bits=bits, bucket_elems=bucket_elems)
    head_rows = (nb - 1) * rows_b
    payload = torch.empty((head_rows + rt, LANES), dtype=torch.uint8,
                          device=padded.device)
    if nb > 1:
        kernel.encode_packed(x4, u4, params[:nb - 1], bits=bits,
                             out=payload[:head_rows].view(nb - 1, rows_b,
                                                          LANES))
    kernel.encode_packed(x3, u3, params[nb - 1:], bits=bits,
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
    uniforms and params of ``encode_flat`` — so the result equals
    ``decode_flat(encode_flat(flat, key))`` bit for bit.

    K4 writes over the edge-padded buffer when the pad made one (it is
    this function's own), and over ``flat`` itself when ``donate`` is
    set and no pad was needed; otherwise into a new buffer. Returns a
    (total,) fp32 tensor."""
    flat = flat.reshape(-1).float()
    total = flat.shape[0]
    _, cap, nb, _, _ = flat_geometry(total, bits=bits,
                                     bucket_elems=bucket_elems)
    padded = edge_pad(flat, nb * cap)
    x4, u4, x3, u3, params, _ = _bucket_views(
        padded, total, key, bits=bits, bucket_elems=bucket_elems)
    out = padded if (padded is not flat or donate) \
        else torch.empty_like(padded)
    head_elems = (nb - 1) * cap
    if nb > 1:
        kernel.qdq_bucketed(x4, u4, params[:nb - 1], bits=bits,
                            out=out[:head_elems].view(x4.shape))
    tail = kernel.qdq_bucketed(x3, u3, params[nb - 1:], bits=bits)
    out[head_elems:total] = tail.reshape(-1)[:total - head_elems]
    return out[:total]


def _head_uniforms(key, nb: int, pack: int, rows_b: int, device):
    """The (nb - 1, pack, Rb, 512) uniforms of the full buckets, bucket b
    drawn under ``bucket_key(key, b)``."""
    u4 = torch.empty((nb - 1, pack, rows_b, LANES), dtype=torch.float32,
                     device=device)
    for b in range(nb - 1):
        u4[b] = prng.uniform(bucket_key(key, b), (pack, rows_b, LANES),
                             device=device)
    return u4


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
