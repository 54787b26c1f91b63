"""ctypes wrappers for the codec's hand-written CUDA kernels
(``repro_torch/csrc/quant.cu``), with their plain versions beside them.

  K1 ``minmax_bucketed``  per-bucket [lo, hi]       (B, R, 512) f32 -> (B, 2)
  K2 ``encode_packed``    quantize + bit-pack       (B, pack, R, 512) -> (B, R, 512) u8
  K3 ``decode_packed``    unpack + dequantize       (B, R, 512) u8 -> (B, pack, R, 512)
  K4 ``qdq_bucketed``     quantize -> dequantize    (B, pack, R, 512) -> same shape
  K5 ``decode_add_encode_bucketed``  the ring hop   (B, R, 512) u8 + (B, pack, R, 512) -> (B, R, 512) u8

K1-K4 each replace a pair of the JAX package's Pallas kernels: the
bucketed form on the full buckets, and the per-leaf form as B = 1 on the
tail. K5 replaces the fused ring hop, bucketed, with its tail as B = 1.

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
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.quant import ref

LANES = 512
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
            lib.quant_minmax_blocks.argtypes = [ll, ll]
            lib.quant_encode_packed.argtypes = [vp, vp, vp, vp, ll, ll, i,
                                                vp]
            lib.quant_decode_packed.argtypes = [vp, vp, vp, ll, ll, i, vp]
            lib.quant_qdq_bucketed.argtypes = [vp, vp, vp, vp, ll, ll, i, vp]
            lib.quant_decode_add_encode.argtypes = [vp, vp, vp, vp, vp, vp,
                                                    vp, ll, ll, i, i, vp]
            for fn in (lib.quant_minmax_bucketed, lib.quant_k1_blocks,
                       lib.quant_minmax_blocks,
                       lib.quant_encode_packed, lib.quant_decode_packed,
                       lib.quant_qdq_bucketed, lib.quant_decode_add_encode):
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
    """K1's per-bucket ticket counters on ``device``, at least ``n``:
    zeroed when made, and left zeroed by every K1 launch (its last block
    of a bucket resets the bucket's counter)."""
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


def encode_packed(x4: torch.Tensor, u4: torch.Tensor, params: torch.Tensor,
                  *, bits: int, out: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """K2: x4, u4 (B, pack, R, 512) fp32 + params (B, 2) [lo, scale] ->
    (B, R, 512) uint8 payload (into ``out`` when given)."""
    pack = _bits_ok(bits)
    if x4.dim() != 4 or x4.shape[1] != pack or x4.shape[3] != LANES:
        raise ValueError(f"encode_packed: need (B, {pack}, R, {LANES}) for "
                         f"bits={bits}, got {tuple(x4.shape)}")
    b, _, r, _ = x4.shape
    if not _on_cuda(x4, "encode_packed"):
        res = ref.encode_packed_bucketed(x4, u4, params[:, 0], params[:, 1],
                                         bits=bits)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = x4.device
    _require(x4, "encode_packed x", torch.float32, (b, pack, r, LANES), dev)
    _require(u4, "encode_packed u", torch.float32, (b, pack, r, LANES), dev)
    _require(params, "encode_packed params", torch.float32, (b, 2), dev)
    if out is None:
        out = torch.empty((b, r, LANES), dtype=torch.uint8, device=dev)
    _require(out, "encode_packed out", torch.uint8, (b, r, LANES), dev)
    _check(_load().quant_encode_packed(x4.data_ptr(), u4.data_ptr(),
                                       params.data_ptr(), out.data_ptr(), b,
                                       r, bits, _stream()), "encode_packed")
    encode_packed.launches += 1
    return out


def decode_packed(payload: torch.Tensor, params: torch.Tensor, *, bits: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: (B, R, 512) uint8 + params (B, 2) [lo, scale] ->
    (B, pack, R, 512) fp32 (into ``out`` when given)."""
    pack = _bits_ok(bits)
    if payload.dim() != 3 or payload.shape[2] != LANES:
        raise ValueError(f"decode_packed: need (B, R, {LANES}), got "
                         f"{tuple(payload.shape)}")
    b, r, _ = payload.shape
    if not _on_cuda(payload, "decode_packed"):
        res = ref.decode_packed_bucketed(payload, params[:, 0],
                                         params[:, 1], bits=bits)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = payload.device
    _require(payload, "decode_packed payload", torch.uint8, (b, r, LANES),
             dev)
    _require(params, "decode_packed params", torch.float32, (b, 2), dev)
    if out is None:
        out = torch.empty((b, pack, r, LANES), dtype=torch.float32,
                          device=dev)
    _require(out, "decode_packed out", torch.float32, (b, pack, r, LANES),
             dev)
    _check(_load().quant_decode_packed(payload.data_ptr(), params.data_ptr(),
                                       out.data_ptr(), b, r, bits,
                                       _stream()), "decode_packed")
    decode_packed.launches += 1
    return out


def qdq_bucketed(x4: torch.Tensor, u4: torch.Tensor, params: torch.Tensor,
                 *, bits: int, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """K4: x4, u4 (B, pack, R, 512) fp32 + params (B, 2) [lo, scale] ->
    the stochastically quantized and dequantized x4, same shape, fp32
    (into ``out`` when given; ``out`` may be ``x4`` itself)."""
    pack = _bits_ok(bits)
    if x4.dim() != 4 or x4.shape[1] != pack or x4.shape[3] != LANES:
        raise ValueError(f"qdq_bucketed: need (B, {pack}, R, {LANES}) for "
                         f"bits={bits}, got {tuple(x4.shape)}")
    b, _, r, _ = x4.shape
    if not _on_cuda(x4, "qdq_bucketed"):
        res = ref.qdq_bucketed(x4, u4, params[:, 0], params[:, 1],
                               bits=bits)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = x4.device
    shape = (b, pack, r, LANES)
    _require(x4, "qdq_bucketed x", torch.float32, shape, dev)
    _require(u4, "qdq_bucketed u", torch.float32, shape, dev)
    _require(params, "qdq_bucketed params", torch.float32, (b, 2), dev)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    _require(out, "qdq_bucketed out", torch.float32, shape, dev)
    _check(_load().quant_qdq_bucketed(x4.data_ptr(), u4.data_ptr(),
                                      params.data_ptr(), out.data_ptr(), b,
                                      pack * r * LANES, bits, _stream()),
           "qdq_bucketed")
    qdq_bucketed.launches += 1
    return out


def decode_add_encode_bucketed(payload: torch.Tensor, params: torch.Tensor,
                               x4: torch.Tensor, u4: torch.Tensor, *,
                               bits: int, out: Optional[torch.Tensor] = None,
                               params_out: Optional[torch.Tensor] = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5, the fused ring hop: the incoming payload (B, R, 512) uint8 with
    its params (B, 2) [lo, scale], decoded, plus the local addend x4
    (B, pack, R, 512) fp32, re-encoded per bucket against the uniforms u4
    -> (payload_out (B, R, 512) uint8, params_out (B, 2) [lo, scale]),
    into ``out`` / ``params_out`` when given. Bit-identical to
    ``encode(decode(payload) + x4)``; the sum never reaches memory.
    ``out`` and ``params_out`` must share no memory with an input or with
    each other (on the card the finalize launch writes ``params_out``
    before the encode launch reads the inputs again); on either device
    an overlap raises."""
    pack = _bits_ok(bits)
    if payload.dim() != 3 or payload.shape[2] != LANES:
        raise ValueError(f"decode_add_encode_bucketed: need (B, R, {LANES}), "
                         f"got {tuple(payload.shape)}")
    b, r, _ = payload.shape
    if tuple(x4.shape) != (b, pack, r, LANES):
        raise ValueError(f"decode_add_encode_bucketed: x4 {tuple(x4.shape)}, "
                         f"need {(b, pack, r, LANES)} for bits={bits}")
    given = [(n, t) for n, t in (("out", out), ("params_out", params_out))
             if t is not None]
    for i, (name, t) in enumerate(given):
        others = [("payload", payload), ("params", params), ("x4", x4),
                  ("u4", u4)] + given[i + 1:]
        for other, o in others:
            if _overlaps(t, o):
                raise ValueError(f"decode_add_encode_bucketed: {name} "
                                 f"overlaps {other}")
    if not _on_cuda(payload, "decode_add_encode_bucketed"):
        res, res_p = ref.decode_add_encode_bucketed(payload, params, x4, u4,
                                                    bits=bits)
        if out is not None:
            res = out.copy_(res)
        if params_out is not None:
            res_p = params_out.copy_(res_p)
        return res, res_p
    dev = payload.device
    _require(payload, "decode_add_encode_bucketed payload", torch.uint8,
             (b, r, LANES), dev)
    _require(params, "decode_add_encode_bucketed params", torch.float32,
             (b, 2), dev)
    _require(x4, "decode_add_encode_bucketed x", torch.float32,
             (b, pack, r, LANES), dev)
    _require(u4, "decode_add_encode_bucketed u", torch.float32,
             (b, pack, r, LANES), dev)
    if out is None:
        out = torch.empty((b, r, LANES), dtype=torch.uint8, device=dev)
    if params_out is None:
        params_out = torch.empty((b, 2), dtype=torch.float32, device=dev)
    _require(out, "decode_add_encode_bucketed out", torch.uint8,
             (b, r, LANES), dev)
    _require(params_out, "decode_add_encode_bucketed params_out",
             torch.float32, (b, 2), dev)
    lib = _load()
    nblk = lib.quant_minmax_blocks(b, r * LANES)
    partial = torch.empty((b, nblk, 2), dtype=torch.float32, device=dev)
    _check(lib.quant_decode_add_encode(
        payload.data_ptr(), params.data_ptr(), x4.data_ptr(), u4.data_ptr(),
        partial.data_ptr(), out.data_ptr(), params_out.data_ptr(), b, r, nblk,
        bits, _stream()), "decode_add_encode_bucketed")
    decode_add_encode_bucketed.launches += 1
    return out, params_out


KERNELS = (minmax_bucketed, encode_packed, decode_packed, qdq_bucketed,
           decode_add_encode_bucketed)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launches()
