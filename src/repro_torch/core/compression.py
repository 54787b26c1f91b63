"""Compression codecs of the checkpoint wire: the rq8/rq4/rq2 quantizers
of Section 3 of the paper, their fused flat-buffer wire object and its
CRC32 framing.

The port of the parts of ``repro.core.compression`` the serving path
and the training paths run: ``CompressionSpec``, ``FlatLayout``,
``FlatPacked``, ``QuantCodec``'s fused flat tier (``flat_encode`` /
``flat_decode`` / ``flat_qdq`` and their tree forms,
``tree_wire_bytes_flat``), the identity codec ``none``, the ``codec()``
registry and the wire-integrity helpers. The per-leaf ``Packed`` tier,
the partitioned ring view and the other qdq-only operators (sparsifiers,
sign, clipping) come with later slices.

A ``FlatLayout`` flattens a parameter tree onto ONE contiguous fp32
buffer in JAX's leaf order (dict keys sorted, ``core.pytree``), so the
offsets, the bucket boundaries and therefore the published bytes are the
JAX package's. The CRC stays host-side ``zlib.crc32`` over the payload
bytes, then the params bytes: equal bytes, equal CRC.
"""
from __future__ import annotations

import dataclasses
import zlib
from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import pytree
from repro_torch.core.registry import Registry
from repro_torch.kernels.quant import ops
from repro_torch.kernels.quant.ops import DEFAULT_BUCKET_ELEMS  # noqa: F401


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Static description of a compression operator.

    name:        registry key.
    unbiased:    whether E[Q(x)] = x (Assumption 3).
    bits_per_el: wire bits per *kept* element (payload).
    density:     fraction of elements kept (1.0 for quantizers).
    overhead_bytes: per-message header (scales, indices bookkeeping).
    """

    name: str
    unbiased: bool
    bits_per_el: float
    density: float = 1.0
    overhead_bytes: int = 8

    def compressed_bytes(self, n_elements: int) -> float:
        """Wire bytes for a message of n_elements (fp32 baseline = 4n)."""
        payload = n_elements * self.density * self.bits_per_el / 8.0
        if self.density < 1.0:
            # sparse formats also ship indices (4 bytes each)
            payload += n_elements * self.density * 4.0
        return payload + self.overhead_bytes


# ---------------------------------------------------------------------------
# The flat layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static offset table mapping a tree onto ONE contiguous fp32 buffer.

    Leaf i (in JAX's order) occupies flat[offsets[i] : offsets[i] +
    sizes[i]], reshaped to shapes[i] and cast back to dtypes[i] on
    unflatten. Frozen and hashable, like the JAX package's.
    """

    treedef: Any
    shapes: tuple
    dtypes: tuple
    offsets: tuple
    sizes: tuple
    total: int

    @classmethod
    def from_tree(cls, tree) -> "FlatLayout":
        leaves, treedef = pytree.tree_flatten(tree)
        shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        dtypes = tuple(leaf.dtype for leaf in leaves)
        return _cached_layout(treedef, shapes, dtypes)

    def flatten(self, tree, *, padded_len: Optional[int] = None
                ) -> torch.Tensor:
        """Tree -> one (total,) fp32 buffer, written leaf by leaf into a
        single allocation. ``padded_len`` > total edge-pads it (repeats
        the last real element), the codec's bucket padding, in place."""
        leaves = pytree.tree_leaves(tree)
        n = self.total if padded_len is None else padded_len
        out = torch.empty((n,), dtype=torch.float32,
                          device=leaves[0].device)
        for leaf, off, size in zip(leaves, self.offsets, self.sizes):
            out[off:off + size] = leaf.reshape(-1)
        if n > self.total:
            out[self.total:] = out[self.total - 1]
        return out

    def unflatten(self, flat: torch.Tensor):
        """(total,) buffer -> tree with the original shapes/dtypes (fp32
        leaves are views of ``flat``)."""
        leaves = [flat[o:o + n].view(shape).to(dtype)
                  for o, n, shape, dtype in zip(self.offsets, self.sizes,
                                                self.shapes, self.dtypes)]
        return pytree.tree_unflatten(self.treedef, leaves)


@lru_cache(maxsize=512)
def _cached_layout(treedef, shapes: tuple, dtypes: tuple) -> FlatLayout:
    sizes, offsets, off = [], [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        sizes.append(n)
        offsets.append(off)
        off += n
    return FlatLayout(treedef, shapes, dtypes, tuple(offsets), tuple(sizes),
                      off)


# ---------------------------------------------------------------------------
# The wire object
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlatPacked:
    """ONE compressed message for a whole tree (the fused wire object).

    payload: (rows_kept, 512) uint8 — the bucketed packed codes.
    params:  (n_buckets, 2) fp32 — one [lo, scale] row per bucket.
    layout:  the FlatLayout that unflattens the decode into the tree.
    codec / bucket_elems: static decode metadata.
    """

    payload: torch.Tensor
    params: torch.Tensor
    layout: FlatLayout
    codec: str
    bucket_elems: int

    @property
    def wire_bytes(self) -> int:
        """Measured size: payload bytes + header (params) bytes."""
        return int(self.payload.numel() * self.payload.element_size()
                   + self.params.numel() * self.params.element_size())


# ---------------------------------------------------------------------------
# The quantizer codec
# ---------------------------------------------------------------------------


class QuantCodec:
    """Randomized uniform quantization, Eq. (3.1) + Figure 3.1, with the
    packed sub-byte wire format of ``kernels.quant``: the CUDA kernels
    for tensors on the card, their plain versions on the CPU."""

    def __init__(self, bits: int):
        if bits not in (8, 4, 2):
            raise ValueError(f"bits must be 8, 4 or 2, got {bits}")
        self.bits = bits
        self.spec = CompressionSpec(f"rq{bits}", True, float(bits))

    @property
    def name(self) -> str:
        return self.spec.name

    def flat_encode(self, flat: torch.Tensor, key, layout: FlatLayout, *,
                    bucket_elems: int = DEFAULT_BUCKET_ELEMS) -> FlatPacked:
        payload, params = ops.encode_flat(flat, key, bits=self.bits,
                                          bucket_elems=bucket_elems)
        self._observe_buckets(params)
        return FlatPacked(payload, params, layout, self.name, bucket_elems)

    def flat_decode(self, packed: FlatPacked) -> torch.Tensor:
        return ops.decode_flat(packed.payload, packed.params,
                               total=packed.layout.total, bits=self.bits,
                               bucket_elems=packed.bucket_elems)

    def tree_encode_flat(self, tree, key, *,
                         bucket_elems: int = DEFAULT_BUCKET_ELEMS
                         ) -> FlatPacked:
        """Whole tree -> ONE FlatPacked, flattened straight into the
        edge-padded bucket buffer (one copy of the tree, not two)."""
        layout = FlatLayout.from_tree(tree)
        _, cap, nb, _, _ = ops.flat_geometry(layout.total, bits=self.bits,
                                             bucket_elems=bucket_elems)
        padded = layout.flatten(tree, padded_len=nb * cap)
        payload, params = ops.encode_padded(padded, layout.total, key,
                                            bits=self.bits,
                                            bucket_elems=bucket_elems)
        self._observe_buckets(params)
        return FlatPacked(payload, params, layout, self.name, bucket_elems)

    def tree_decode_flat(self, packed: FlatPacked):
        return packed.layout.unflatten(self.flat_decode(packed))

    def flat_qdq(self, flat: torch.Tensor, key, *,
                 bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                 donate: bool = False) -> torch.Tensor:
        """Fused per-bucket qdq of one flat fp32 buffer (K1 + K4),
        equal to ``flat_decode(flat_encode(flat, key))`` bit for bit.
        ``donate=True`` lets K4 write over ``flat``: pass it only when
        the caller's buffer is dead after the call."""
        return ops.qdq_flat(flat, key, bits=self.bits,
                            bucket_elems=bucket_elems, donate=donate)

    def tree_qdq_flat(self, tree, key, *,
                      bucket_elems: int = DEFAULT_BUCKET_ELEMS):
        """Whole-tree fused qdq through one flat buffer; the buffer is
        this call's own, so K4 writes over it."""
        layout = FlatLayout.from_tree(tree)
        return layout.unflatten(self.flat_qdq(
            layout.flatten(tree), key, bucket_elems=bucket_elems,
            donate=True))

    def tree_wire_bytes_flat(self, tree, *,
                             bucket_elems: int = DEFAULT_BUCKET_ELEMS
                             ) -> float:
        """Wire bytes of the ONE fused message for ``tree``, from the
        static geometry (payload rows x 512 + 8 bytes per bucket)."""
        layout = FlatLayout.from_tree(tree)
        _, _, nb, _, rows_kept = ops.flat_geometry(
            layout.total, bits=self.bits, bucket_elems=bucket_elems)
        b = float(rows_kept * ops.LANES + nb * 8)
        if obs.enabled("metrics"):
            obs.counter("compression.wire_bytes", codec=self.name,
                        tier="flat").inc(b)
            obs.counter("compression.sized_msgs", codec=self.name,
                        tier="flat").inc()
            obs.histogram("compression.ratio", codec=self.name).observe(
                4.0 * layout.total / b)
        return b

    def _observe_buckets(self, params: torch.Tensor) -> None:
        if obs.enabled("metrics"):
            levels = (1 << self.bits) - 1
            obs.observe_array("quant.bucket_range",
                              (params[:, 1] * levels).cpu(),
                              codec=self.name)


class IdentityCodec:
    """The ``none`` codec: no compression. The train step resolves it
    like any codec and skips the exchange; its fused qdq is the input
    itself and its wire cost the fp32 message."""

    spec = CompressionSpec("none", True, 32.0, overhead_bytes=0)
    name = "none"

    def flat_qdq(self, flat: torch.Tensor, key=None, *,
                 bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                 donate: bool = False) -> torch.Tensor:
        return flat

    def tree_wire_bytes_flat(self, tree, *,
                             bucket_elems: int = DEFAULT_BUCKET_ELEMS
                             ) -> float:
        return self.spec.compressed_bytes(FlatLayout.from_tree(tree).total)


CODECS: Registry = Registry("compression", {
    "none": IdentityCodec(),
    "rq8": QuantCodec(8),
    "rq4": QuantCodec(4),
    "rq2": QuantCodec(2),
})

# codecs of the JAX package that the port does not run yet (qdq-only
# operators without a packed wire format)
NOT_PORTED = ("clip16", "rand_sparse_10", "sign1", "topk_1")


def codec(name: str):
    if name in NOT_PORTED:
        raise KeyError(f"compression '{name}' is not ported to repro_torch "
                       f"yet; have {CODECS.names()}")
    return CODECS.get(name)


# ---------------------------------------------------------------------------
# Wire integrity: CRC32 framing over packed codes + params
# ---------------------------------------------------------------------------


class WireCorruptionError(ValueError):
    """A packed wire message failed its integrity check on receive."""


def _wire_children(packed: FlatPacked) -> tuple:
    """(payload, params) as host numpy arrays."""
    return (np.ascontiguousarray(packed.payload.detach().cpu().numpy()),
            np.ascontiguousarray(packed.params.detach().cpu().numpy()))


def wire_crc32(packed: FlatPacked) -> int:
    """CRC32 over the packed codes then the dequantization params (the
    contiguous host arrays are read in place, not copied to bytes)."""
    pay, par = _wire_children(packed)
    return zlib.crc32(par, zlib.crc32(pay)) & 0xFFFFFFFF


def wire_bits(packed: FlatPacked) -> int:
    """Total framed bits (payload + params) — the bit-flip domain."""
    return packed.wire_bytes * 8


def frame(packed: FlatPacked) -> tuple:
    """``(packed, crc)`` — what a framed send puts on the wire."""
    return packed, wire_crc32(packed)


def verify_wire(packed: FlatPacked, crc: int, *, where: str = "wire"
                ) -> None:
    """Raise ``WireCorruptionError`` unless the frame checks out."""
    got = wire_crc32(packed)
    want = int(crc) & 0xFFFFFFFF
    if got != want:
        raise WireCorruptionError(
            f"{where}: CRC32 mismatch on packed message "
            f"(got 0x{got:08x}, frame says 0x{want:08x}) — payload or "
            "params corrupted in flight")


def flip_bit(packed: FlatPacked, bit: int) -> FlatPacked:
    """A copy of the wire message with exactly one bit flipped —
    payload bits first, then params bits."""
    pay, par = _wire_children(packed)
    if not 0 <= bit < (pay.nbytes + par.nbytes) * 8:
        raise ValueError(f"bit {bit} outside the "
                         f"{(pay.nbytes + par.nbytes) * 8}-bit frame")

    def _flipped(arr, b):
        buf = bytearray(arr.tobytes())
        buf[b // 8] ^= 1 << (b % 8)
        return np.frombuffer(bytes(buf), dtype=arr.dtype).reshape(arr.shape)

    if bit < pay.nbytes * 8:
        pay = _flipped(pay, bit)
    else:
        par = _flipped(par, bit - pay.nbytes * 8)
    dev = packed.payload.device
    return dataclasses.replace(packed,
                               payload=torch.from_numpy(pay.copy()).to(dev),
                               params=torch.from_numpy(par.copy()).to(dev))


def tree_finite(tree) -> bool:
    """All-finite check over a decoded tree (one host sync per leaf)."""
    return all(bool(torch.isfinite(leaf).all())
               for leaf in pytree.tree_leaves(tree))


def guard_finite(tree, *, where: str = "decode") -> None:
    """The post-decode guard: NaN/Inf that slipped past the checksum
    raises instead of reaching the serving params."""
    if not tree_finite(tree):
        raise WireCorruptionError(
            f"{where}: decoded payload contains NaN/Inf — contribution "
            "skipped (post-decode finite guard)")
