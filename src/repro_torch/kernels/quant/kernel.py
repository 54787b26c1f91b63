"""ctypes wrappers for the codec's hand-written CUDA kernels
(``repro_torch/csrc/quant.cu``), with their plain versions beside them.

  K1 ``minmax_bucketed``  per-bucket [lo, hi]       (B, R, 512) f32 -> (B, 2)
  K2 ``encode_packed``    quantize + bit-pack       (B, pack, R, 512) -> (B, R, 512) u8
  K3 ``decode_packed``    unpack + dequantize       (B, R, 512) u8 -> (B, pack, R, 512)
  K4 ``qdq_bucketed``     quantize -> dequantize    (B, pack, R, 512) -> same shape
  K5 ``decode_add_encode_bucketed``  one ring hop of N workers:
                                     N x ((rows, 512) u8 + (pack * rows * 512,) f32)
                                     -> (N, rows, 512) u8

K2, K4 and K5 draw their stochastic rounding's uniforms themselves, on
the card (``csrc/threefry.cuh``), the bits ``core.prng.uniform`` gives
JAX's ``jax.random.uniform``: K2 and K4 take a key, not a uniform
tensor. K2-K4 each replace a pair of the JAX package's Pallas kernels,
with the draw beside it: the bucketed form (the full buckets of the flat
tier, bucket b drawing under ``fold_in(key, b)``, and its tail bucket as
B = 1 from ``first_bucket`` nb - 1) and the per-leaf form, launched
through ``leaf_encode_packed``, ``leaf_decode_packed`` and ``leaf_qdq``
on B leaf messages (a leaf of each of B stacked workers, drawing under
its own key) and counted apart. K5 replaces the fused ring hop and the
draws beside it, for every worker's full buckets and tail in one call;
its plain version is ``ref.decode_add_encode_hop``.

Dispatch follows the tensor: a CPU tensor takes the plain version in
``ref.py``; a CUDA tensor launches the kernel on PyTorch's current
stream or raises — there is no fallback. Each wrapper counts its CUDA
launches in ``<wrapper>.launches`` (``reset_launches`` zeroes them).

The library is compiled by the port's builder (``kernels.nvcc``) for
``sm_90a`` at first use into ``build/repro_torch/libquant.so`` under the
checkout (rebuilt when the source is newer), never at import: importing
this module needs no compiler and no card.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import nvcc
from repro_torch.kernels.quant import ref

LANES = 512
# One K5 launch's limits (csrc/quant.cu kHopMaxWorkers, kHopMaxKeys): its
# workers, and their (worker, bucket) keys in the launch's argument block
HOP_MAX_WORKERS = 8
HOP_MAX_KEYS = 256
# The own keys one K2 or K4 launch carries (csrc/quant.cu kMaxRowKeys): a
# per-leaf launch of more rows is cut into several
ROW_MAX_KEYS = 256
# K2 and K4 hash counters below 2**32 (threefry::bits): their wrappers
# raise for a bucket or leaf message of more elements
MAX_ROW_ELEMS = (1 << 32) - 1
SOURCE = nvcc.CSRC / "quant.cu"
LIBRARY = nvcc.BUILD_DIR / "libquant.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_ticket_bufs: dict = {}


def build(*, force: bool = False) -> Path:
    """Compile ``quant.cu`` into ``libquant.so`` unless an up-to-date
    build exists. Raises with the compiler's output on failure."""
    return nvcc.build(SOURCE, LIBRARY, force=force)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.quant_minmax_bucketed.argtypes = [vp, vp, vp, vp, ll, ll, i,
                                                  vp]
            lib.quant_k1_blocks.argtypes = [ll, ll]
            lib.quant_encode_packed.argtypes = [vp, vp, vp, ll, ll, i, vp, i,
                                                ctypes.c_uint, vp]
            lib.quant_decode_packed.argtypes = [vp, vp, vp, ll, ll, i, vp]
            lib.quant_qdq_bucketed.argtypes = [vp, vp, vp, ll, ll, i, vp, i,
                                               ctypes.c_uint, vp]
            lib.quant_decode_add_encode_hop.argtypes = [vp, vp, vp, vp, i, i,
                                                        ll, ll, i, vp]
            lib.quant_hop_slices.argtypes = [i, i, ll, ll, i]
            lib.quant_hop_slices.restype = ll
            lib.quant_threefry.argtypes = [ctypes.c_uint, ctypes.c_uint,
                                           ctypes.c_uint, ll, vp, i, vp]
            for fn in (lib.quant_minmax_bucketed, lib.quant_k1_blocks,
                       lib.quant_encode_packed, lib.quant_decode_packed,
                       lib.quant_qdq_bucketed,
                       lib.quant_decode_add_encode_hop, lib.quant_threefry):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one, else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
             device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The byte range [start, end) that t's elements occupy."""
    start = t.data_ptr()
    if t.numel() == 0:
        return start, start
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return start, start + (last + 1) * t.element_size()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device:
        return False
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def _bits_ok(bits: int) -> int:
    if bits not in (8, 4, 2):
        raise ValueError(f"bits must be 8, 4 or 2, got {bits}")
    return 8 // bits


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """K1's and K5's per-bucket ticket counters on ``device``, at least ``n``:
    zeroed when made, and left zeroed by every K1 and K5 launch (the last
    block of a bucket resets the bucket's counter)."""
    with _lock:
        t = _ticket_bufs.get(device)
        if t is None or t.numel() < n:
            t = torch.zeros((n,), dtype=torch.int32, device=device)
            _ticket_bufs[device] = t
        return t


def minmax_bucketed(x3: torch.Tensor) -> torch.Tensor:
    """K1: (B, R, 512) fp32 bucket view -> (B, 2) fp32 [lo, hi]. One
    CUDA launch; a CUDA input must be 16-byte aligned."""
    if x3.dim() != 3 or x3.shape[2] != LANES:
        raise ValueError(f"minmax_bucketed: need (B, R, {LANES}), got "
                         f"{tuple(x3.shape)}")
    if not _on_cuda(x3, "minmax_bucketed"):
        lo, hi = ref.minmax_bucketed(x3)
        return torch.stack([lo, hi], dim=1)
    b, r, _ = x3.shape
    _require(x3, "minmax_bucketed x", torch.float32, (b, r, LANES), x3.device)
    if x3.data_ptr() % 16:
        raise ValueError("minmax_bucketed x: must be 16-byte aligned")
    lib = _load()
    cap = r * LANES
    nblk = lib.quant_k1_blocks(b, cap)
    partial = torch.empty((b, nblk, 2), dtype=torch.float32,
                          device=x3.device)
    out = torch.empty((b, 2), dtype=torch.float32, device=x3.device)
    _check(lib.quant_minmax_bucketed(x3.data_ptr(), partial.data_ptr(),
                                     _tickets(x3.device, b).data_ptr(),
                                     out.data_ptr(), b, cap, nblk,
                                     _stream()), "minmax_bucketed")
    minmax_bucketed.launches += 1
    return out


def _check_keys(x4: torch.Tensor, what: str, first_bucket: int,
                keys) -> None:
    """Raise where a row's counters or the buckets pass 32 bits, or
    ``keys`` (the per-leaf forms' one key a row) is not one a row."""
    b, row = x4.shape[0], math.prod(x4.shape[1:])
    if row > MAX_ROW_ELEMS:
        raise ValueError(f"{what}: {row} elements a row; the card's "
                         "Threefry counts below 2**32")
    if keys is None and not (0 <= first_bucket
                             and first_bucket + b <= 1 << 32):
        raise ValueError(f"{what}: buckets {first_bucket} .. "
                         f"{first_bucket + b - 1} outside 32 bits")
    if keys is not None and len(keys) != b:
        raise ValueError(f"{what}: {b} rows but {len(keys)} keys")


def _plain_keys(b: int, key, first_bucket: int, keys) -> list:
    """The row keys the plain versions draw under: ``keys``, or bucket
    b's ``fold_in(key, first_bucket + b)``."""
    return list(keys) if keys is not None else \
        ref.fold_keys(key, first_bucket, b)


def _key_words(keys) -> np.ndarray:
    """(len(keys), 2) uint32 words of the keys, on the host."""
    return np.array([prng.key_words(k) for k in keys],
                    dtype=np.uint32).reshape(-1, 2)


def _launch_rows(launch, b: int, key, first_bucket: int, keys) -> None:
    """Run ``launch(rows, key_words, fold, first)`` over the b rows: one
    launch for the bucketed forms (``keys`` None: the root key, folded
    with the bucket on the card), launches of at most ROW_MAX_KEYS rows
    for the per-leaf forms (their keys in each launch's argument
    block)."""
    if keys is None:
        launch(slice(0, b), _key_words([key]), 1, first_bucket)
        return
    words = _key_words(keys)
    for r0 in range(0, b, ROW_MAX_KEYS):
        rows = slice(r0, min(b, r0 + ROW_MAX_KEYS))
        launch(rows, np.ascontiguousarray(words[rows]), 0, 0)


def _encode_packed(count, x4: torch.Tensor, params: torch.Tensor, bits: int,
                   out: Optional[torch.Tensor], key=None,
                   first_bucket: int = 0, keys=None) -> torch.Tensor:
    """K2's dispatch; a call is counted on ``count``."""
    what = count.__name__
    pack = _bits_ok(bits)
    if x4.dim() != 4 or x4.shape[1] != pack or x4.shape[3] != LANES:
        raise ValueError(f"{what}: need (B, {pack}, R, {LANES}) for "
                         f"bits={bits}, got {tuple(x4.shape)}")
    b, _, r, _ = x4.shape
    _check_keys(x4, what, first_bucket, keys)
    if not _on_cuda(x4, what):
        res = ref.encode_packed_keyed(
            x4, _plain_keys(b, key, first_bucket, keys), params[:, 0],
            params[:, 1], bits=bits)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = x4.device
    _require(x4, f"{what} x", torch.float32, (b, pack, r, LANES), dev)
    _require(params, f"{what} params", torch.float32, (b, 2), dev)
    if out is None:
        out = torch.empty((b, r, LANES), dtype=torch.uint8, device=dev)
    _require(out, f"{what} out", torch.uint8, (b, r, LANES), dev)
    if x4.data_ptr() % 16 or out.data_ptr() % 4:
        raise ValueError(f"{what}: x must be 16-byte aligned and out 4-byte "
                         "aligned")
    lib = _load()

    def launch(rows, words, fold, first):
        _check(lib.quant_encode_packed(
            x4[rows].data_ptr(), params[rows].data_ptr(),
            out[rows].data_ptr(), rows.stop - rows.start, r, bits,
            words.ctypes.data, fold, first, _stream()), what)

    _launch_rows(launch, b, key, first_bucket, keys)
    count.launches += 1
    return out


def encode_packed(x4: torch.Tensor, key, params: torch.Tensor, *,
                  bits: int, first_bucket: int = 0,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: x4 (B, pack, R, 512) fp32 + params (B, 2) [lo, scale] ->
    (B, R, 512) uint8 payload (into ``out`` when given), bucket b
    rounded against ``prng.uniform(fold_in(key, first_bucket + b),
    (pack, R, 512))``, drawn on the card."""
    return _encode_packed(encode_packed, x4, params, bits, out, key=key,
                          first_bucket=first_bucket)


def _decode_packed(count, payload: torch.Tensor, params: torch.Tensor,
                   bits: int, out: Optional[torch.Tensor]) -> torch.Tensor:
    """K3's dispatch; a launch is counted on ``count``."""
    what = count.__name__
    pack = _bits_ok(bits)
    if payload.dim() != 3 or payload.shape[2] != LANES:
        raise ValueError(f"{what}: need (B, R, {LANES}), got "
                         f"{tuple(payload.shape)}")
    b, r, _ = payload.shape
    if not _on_cuda(payload, what):
        res = ref.decode_packed_bucketed(payload, params[:, 0],
                                         params[:, 1], bits=bits)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = payload.device
    _require(payload, f"{what} payload", torch.uint8, (b, r, LANES), dev)
    _require(params, f"{what} params", torch.float32, (b, 2), dev)
    if out is None:
        out = torch.empty((b, pack, r, LANES), dtype=torch.float32,
                          device=dev)
    _require(out, f"{what} out", torch.float32, (b, pack, r, LANES), dev)
    _check(_load().quant_decode_packed(payload.data_ptr(), params.data_ptr(),
                                       out.data_ptr(), b, r, bits,
                                       _stream()), what)
    count.launches += 1
    return out


def decode_packed(payload: torch.Tensor, params: torch.Tensor, *, bits: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: (B, R, 512) uint8 + params (B, 2) [lo, scale] ->
    (B, pack, R, 512) fp32 (into ``out`` when given)."""
    return _decode_packed(decode_packed, payload, params, bits, out)


def _qdq(count, x4: torch.Tensor, params: torch.Tensor, bits: int,
         out: Optional[torch.Tensor], key=None, first_bucket: int = 0,
         keys=None) -> torch.Tensor:
    """K4's dispatch; a call is counted on ``count``."""
    what = count.__name__
    pack = _bits_ok(bits)
    if x4.dim() != 4 or x4.shape[1] != pack or x4.shape[3] != LANES:
        raise ValueError(f"{what}: need (B, {pack}, R, {LANES}) for "
                         f"bits={bits}, got {tuple(x4.shape)}")
    b, _, r, _ = x4.shape
    _check_keys(x4, what, first_bucket, keys)
    if not _on_cuda(x4, what):
        res = ref.qdq_keyed(x4, _plain_keys(b, key, first_bucket, keys),
                            params[:, 0], params[:, 1], bits=bits)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = x4.device
    shape = (b, pack, r, LANES)
    _require(x4, f"{what} x", torch.float32, shape, dev)
    _require(params, f"{what} params", torch.float32, (b, 2), dev)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    _require(out, f"{what} out", torch.float32, shape, dev)
    if x4.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{what}: x and out must be 16-byte aligned")
    lib = _load()

    def launch(rows, words, fold, first):
        _check(lib.quant_qdq_bucketed(
            x4[rows].data_ptr(), params[rows].data_ptr(),
            out[rows].data_ptr(), rows.stop - rows.start, pack * r * LANES,
            bits, words.ctypes.data, fold, first, _stream()), what)

    _launch_rows(launch, b, key, first_bucket, keys)
    count.launches += 1
    return out


def qdq_bucketed(x4: torch.Tensor, key, params: torch.Tensor, *, bits: int,
                 first_bucket: int = 0, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """K4: x4 (B, pack, R, 512) fp32 + params (B, 2) [lo, scale] -> the
    stochastically quantized and dequantized x4, same shape, fp32 (into
    ``out`` when given; ``out`` may be ``x4`` itself), bucket b rounded
    against ``prng.uniform(fold_in(key, first_bucket + b), (pack, R,
    512))``, drawn on the card."""
    return _qdq(qdq_bucketed, x4, params, bits, out, key=key,
                first_bucket=first_bucket)


# The per-leaf forms: the same kernels launched on B leaf messages (one
# zero-padded leaf of each of B workers, one [lo, scale] row and one key
# each), the ported forms of the JAX package's per-leaf Pallas calls with
# their draws, counted apart from the bucketed launches above. More than
# ROW_MAX_KEYS leaves take several launches, one count.


def leaf_qdq(x4: torch.Tensor, keys, params: torch.Tensor, *, bits: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 as the per-leaf ``qdq`` (``repro/kernels/quant/kernel.py:77``):
    B leaves, each (pack, R, 512) with its own params row, leaf w
    rounded against ``prng.uniform(keys[w], (pack, R, 512))``."""
    return _qdq(leaf_qdq, x4, params, bits, out, keys=keys)


def leaf_encode_packed(x4: torch.Tensor, keys, params: torch.Tensor, *,
                       bits: int, out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K2 as the per-leaf ``encode_packed`` (``kernel.py:96``): B leaves
    -> B (R, 512) payloads, leaf w drawing under ``keys[w]``."""
    return _encode_packed(leaf_encode_packed, x4, params, bits, out,
                          keys=keys)


def leaf_decode_packed(payload: torch.Tensor, params: torch.Tensor, *,
                       bits: int, out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K3 as the per-leaf ``decode_packed`` (``kernel.py:117``): B (R,
    512) payloads -> B (pack, R, 512) leaves."""
    return _decode_packed(leaf_decode_packed, payload, params, bits, out)


def hop_keys(keys, n_buckets: int) -> np.ndarray:
    """K5's key table: ``fold_in(keys[w], b)`` for each worker w and
    bucket b, as (N, n_buckets, 2) uint32 words, computed on the host
    with Python ints (``prng.fold_in`` per bucket)."""
    words = []
    for key in keys:
        k0, k1 = prng.key_words(key)
        words.extend(prng.threefry2x32(k0, k1, 0, b)
                     for b in range(n_buckets))
    return np.array(words, dtype=np.uint32).reshape(len(keys), n_buckets, 2)


def hop_chunks(n_workers: int, n_buckets: int) -> list:
    """K5's launches for a hop of ``n_workers`` partitions of
    ``n_buckets`` buckets: (first worker, end worker, first bucket, end
    bucket) of each, in order. Each launch holds at most HOP_MAX_WORKERS
    workers and HOP_MAX_KEYS (worker, bucket) keys; the launches together
    cover every bucket of every worker once. A hop within both limits is
    one launch."""
    per = min(n_buckets, HOP_MAX_KEYS)
    chunks = []
    for b0 in range(0, n_buckets, per):
        b1 = min(n_buckets, b0 + per)
        group = min(HOP_MAX_WORKERS, HOP_MAX_KEYS // (b1 - b0))
        chunks.extend((w0, min(n_workers, w0 + group), b0, b1)
                      for w0 in range(0, n_workers, group))
    return chunks


def decode_add_encode_bucketed(payloads, params, locals_, keys, *,
                               bits: int, rows_b: int, rt: int,
                               out: Optional[torch.Tensor] = None,
                               params_out: Optional[torch.Tensor] = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5, one ring hop of N workers in one call. Worker w's incoming
    message -- ``payloads[w]`` (rows, 512) uint8 with ``params[w]``
    (nb, 2) [lo, scale] -- decoded, plus its local fp32 slice
    ``locals_[w]`` (pack * rows * 512,), re-encoded per bucket against
    uniforms drawn on the card from ``fold_in(keys[w], b)`` -> (out
    (N, rows, 512) uint8, params_out (N, nb, 2)), into ``out`` /
    ``params_out`` when given. A partition has nb - 1 full buckets of
    ``rows_b`` rows and a tail bucket of ``rt`` (rows = (nb - 1) * rows_b
    + rt). Bit-identical to ``ref.decode_add_encode_hop``, the JAX
    package's draws and ``decode_add_encode_bucketed`` per worker; the
    sum and the uniforms never reach memory.

    The inputs are any views (worker w's message may be another
    worker's output, its slice a window of a larger buffer); ``out`` and
    ``params_out`` share no memory with an input or with each other, or
    it raises on either device. On the card every payload, slice and
    output row is 16-byte aligned, or it raises. A hop of more than
    HOP_MAX_WORKERS workers or HOP_MAX_KEYS (worker, bucket) keys, which
    one launch's argument block holds, is cut into launches of whole
    buckets (``hop_chunks``): still one call and one count."""
    what = "decode_add_encode_bucketed"
    pack = _bits_ok(bits)
    n = len(payloads)
    if n < 1 or not n == len(params) == len(locals_) == len(keys):
        raise ValueError(f"{what}: need as many payloads, params, locals_ "
                         "and keys (at least one)")
    if params[0].dim() != 2:
        raise ValueError(f"{what}: params[0] {tuple(params[0].shape)}, "
                         "need (nb, 2)")
    nb = params[0].shape[0]
    if not 1 <= rt <= rows_b:
        raise ValueError(f"{what}: need 1 <= rt <= rows_b, got rt={rt}, "
                         f"rows_b={rows_b}")
    rows = (nb - 1) * rows_b + rt
    dev = payloads[0].device
    on_card = _on_cuda(payloads[0], what)
    inputs = []
    for w in range(n):
        for name, t, dtype, shape in (
                ("payloads", payloads[w], torch.uint8, (rows, LANES)),
                ("params", params[w], torch.float32, (nb, 2)),
                ("locals_", locals_[w], torch.float32,
                 (pack * rows * LANES,))):
            _require(t, f"{what} {name}[{w}]", dtype, shape, dev)
            inputs.append((f"{name}[{w}]", t))
    if out is None:
        out = torch.empty((n, rows, LANES), dtype=torch.uint8, device=dev)
    if params_out is None:
        params_out = torch.empty((n, nb, 2), dtype=torch.float32,
                                 device=dev)
    _require(out, f"{what} out", torch.uint8, (n, rows, LANES), dev)
    _require(params_out, f"{what} params_out", torch.float32, (n, nb, 2),
             dev)
    for name, t, others in (("out", out, inputs + [("params_out",
                                                    params_out)]),
                            ("params_out", params_out, inputs)):
        for other, o in others:
            if _overlaps(t, o):
                raise ValueError(f"{what}: {name} overlaps {other}")
    if not on_card:
        res, res_p = ref.decode_add_encode_hop(
            payloads, params, locals_, keys, bits=bits, rows_b=rows_b, rt=rt)
        out.copy_(res)
        params_out.copy_(res_p)
        return out, params_out
    for name, t in [(f"payloads[{w}]", payloads[w]) for w in range(n)] + \
            [(f"locals_[{w}]", locals_[w]) for w in range(n)] + \
            [(f"out[{w}]", out[w]) for w in range(n)]:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} {name}: must be 16-byte aligned")
    lib = _load()
    table = hop_keys(keys, nb)
    chunks = hop_chunks(n, nb)
    geometry = [(w1 - w0, b1 - b0, rt if b1 == nb else rows_b)
                for w0, w1, b0, b1 in chunks]
    partial = torch.empty(
        (max(lib.quant_hop_slices(m, nbc, rows_b, rtc, bits)
             for m, nbc, rtc in geometry), 2),
        dtype=torch.float32, device=dev)
    tickets = _tickets(dev, max(m * nbc for m, nbc, _ in geometry))
    bucket = rows_b * LANES          # payload bytes, x elements / pack
    for (w0, w1, b0, b1), (m, nbc, rtc) in zip(chunks, geometry):
        ws = range(w0, w1)
        ptrs = (ctypes.c_ulonglong * (5 * m))(
            *[payloads[w].data_ptr() + b0 * bucket for w in ws],
            *[params[w].data_ptr() + b0 * 8 for w in ws],
            *[locals_[w].data_ptr() + b0 * pack * bucket * 4 for w in ws],
            *[out[w].data_ptr() + b0 * bucket for w in ws],
            *[params_out[w].data_ptr() + b0 * 8 for w in ws])
        keys_c = np.ascontiguousarray(table[w0:w1, b0:b1])
        _check(lib.quant_decode_add_encode_hop(
            ptrs, keys_c.ctypes.data, partial.data_ptr(),
            tickets.data_ptr(), m, nbc, rows_b, rtc, bits, _stream()), what)
    decode_add_encode_bucketed.launches += 1
    return out, params_out


def threefry(key, offset: int, count: int, *,
             device: Union[str, torch.device], unit: bool = False
             ) -> torch.Tensor:
    """The Threefry K5 draws with (``csrc/threefry.cuh``), alone, on the
    card: the 32 random bits of counters offset .. offset + count - 1
    under ``key`` (uint32 values in int64, as ``prng.random_bits``), or
    their [0, 1) uniforms with ``unit``. For holding the card's draws
    against ``core.prng``; no path of the port calls it, and it has no
    plain version (that is ``prng.threefry2x32``): it raises off the
    card."""
    if offset < 0 or count < 1 or offset + count > 1 << 32:
        raise ValueError(f"threefry: counters [{offset}, {offset + count}) "
                         "outside [0, 2**32)")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry: the card's hash needs a CUDA device, "
                         f"got {device}; prng.threefry2x32 is its plain "
                         "version")
    k0, k1 = prng.key_words(key)
    out = torch.empty((count,), dtype=torch.int32, device=device)
    _check(_load().quant_threefry(k0, k1, offset, count, out.data_ptr(),
                                  2 if unit else 1, _stream()), "threefry")
    return out.view(torch.float32) if unit else out.to(torch.int64) & prng.M32


KERNELS = (minmax_bucketed, encode_packed, decode_packed, qdq_bucketed,
           decode_add_encode_bucketed, leaf_qdq, leaf_encode_packed,
           leaf_decode_packed)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launches()
