"""Compression codecs Q(.) of Section 3 of the paper: the rq8/rq4/rq2
quantizers with their per-leaf, fused flat-buffer and partitioned wire
objects, the qdq-only operators, and CRC32 framing.

The port of ``repro.core.compression``: ``CompressionSpec``,
``FlatLayout``, the per-leaf tier (``Packed``, one message per leaf:
``Codec.qdq`` / ``encode`` / ``decode`` / ``wire_bytes`` and their tree
forms, the paper's reference form of a compressed message),
``FlatPacked``, ``PartitionedFlatPacked``, ``QuantCodec``'s fused flat
tier (``flat_encode`` / ``flat_decode`` / ``flat_qdq`` and their tree
forms) and partitioned tier (the ring AllReduce's partitions and its
fused hop, K5), the qdq-only ``QdqCodec`` operators (``none``,
``sign1``, ``clip16``, ``topk_1``, ``rand_sparse_10``, plus the
reference ``randomized_quantize``), the ``codec()`` registry with the
function-form ``REGISTRY`` / ``get`` / ``tree_compress`` /
``tree_bytes``, and the wire-integrity helpers (CRC framing,
``checked_decode``) over any wire object.

A ``QuantCodec`` leaf goes through the per-leaf kernels (K4, K2, K3
launched on leaf messages, ``kernels.quant.ops``), with
``decode(encode(x, k)) == qdq(x, k)`` bit for bit. The exchanges hold
their workers stacked, so the codec also takes a stacked tree with one
key per worker (``tree_qdq_rows`` and, for QuantCodec,
``tree_encode_rows`` / ``tree_decode_rows``): worker i's leaf l is
drawn under ``split(keys[i], n_leaves)[l]``, as ``tree_qdq(row_i,
keys[i])`` draws it, and each leaf is ONE kernel launch over the N
workers' messages.

A ``FlatLayout`` flattens a parameter tree onto ONE contiguous fp32
buffer in JAX's leaf order (dict keys sorted, ``core.pytree``), so the
offsets, the bucket boundaries and therefore the published bytes are the
JAX package's. The CRC stays host-side ``zlib.crc32`` over the payload
bytes, then the params bytes: equal bytes, equal CRC.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from functools import lru_cache, partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import prng, pytree
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

    def ratio(self, n_elements: int) -> float:
        """Compression ratio eta < 1 relative to fp32 (Table 1.1)."""
        return self.compressed_bytes(n_elements) / (4.0 * n_elements)


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
# The wire objects
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Packed:
    """ONE compressed leaf as it travels on the wire.

    payload: (R, 512) uint8 — the packed codes (the bulk bytes).
    params:  (1, 2) fp32 — [lo, scale] (the header).
    shape / dtype: the leaf's, restored on decode.
    codec:   registry name of the codec that produced it.
    """

    payload: torch.Tensor
    params: torch.Tensor
    shape: tuple
    dtype: Any
    codec: str

    @property
    def wire_bytes(self) -> int:
        """Measured size: payload bytes + header (params) bytes."""
        return int(self.payload.numel() * self.payload.element_size()
                   + self.params.numel() * self.params.element_size())


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


@dataclasses.dataclass
class PartitionedFlatPacked:
    """A whole-tree compressed message as N per-partition views over ONE
    backing buffer (the partitioned ring AllReduce's wire object).

    payload: (n_parts, rows_p, 512) uint8 — partition p's packed codes
             are the slab ``payload[p]``.
    params:  (n_parts, nb_p, 2) fp32 — partition p's own bucket rows.
    layout / codec / bucket_elems / part_elems: decode metadata;
             part_elems is the granule-aligned elements per partition
             (the flat buffer is edge-padded to n_parts * part_elems).

    A reduce-scatter hop ships ONE partition (``part(p)``); the
    all-gather copies finished partitions into this buffer verbatim.
    """

    payload: torch.Tensor
    params: torch.Tensor
    layout: FlatLayout
    codec: str
    bucket_elems: int
    part_elems: int

    @property
    def n_parts(self) -> int:
        return self.payload.shape[0]

    def part(self, p) -> tuple:
        """Partition p's (payload, params) — views, never a copy."""
        return self.payload[p], self.params[p]

    @property
    def part_wire_bytes(self) -> int:
        """Measured bytes of ONE partition message (what a ring hop
        ships): its payload slab + its own params rows."""
        return int((self.payload.numel() * self.payload.element_size()
                    + self.params.numel() * self.params.element_size())
                   // self.n_parts)

    @property
    def wire_bytes(self) -> int:
        """Measured size of all partitions: payload + params bytes."""
        return int(self.payload.numel() * self.payload.element_size()
                   + self.params.numel() * self.params.element_size())


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


class Codec:
    """One compression operator: packed wire format + fused qdq, per leaf
    and over a flat buffer. Subclasses set ``spec`` and implement
    ``qdq``; packable codecs also implement ``encode`` / ``decode`` with
    ``decode(encode(x, k)) == qdq(x, k)``."""

    spec: CompressionSpec
    packable: bool = False

    @property
    def name(self) -> str:
        return self.spec.name

    # -- single leaf ------------------------------------------------------

    def qdq(self, x: torch.Tensor, key) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, x: torch.Tensor, key) -> Packed:
        raise NotImplementedError(
            f"codec '{self.name}' has no packed wire format; use qdq")

    def decode(self, packed: Packed) -> torch.Tensor:
        raise NotImplementedError(
            f"codec '{self.name}' has no packed wire format; use qdq")

    def wire_bytes(self, x) -> float:
        """Wire bytes of one leaf (anything with a ``shape``)."""
        return self.wire_bytes_for(math.prod(tuple(x.shape)))

    def _leaf_wire_bytes(self, n_elements: int) -> float:
        return self.spec.compressed_bytes(n_elements)

    def wire_bytes_for(self, n_elements: int) -> float:
        """Wire bytes of one flat fp32 message of ``n_elements`` sent as
        one leaf (what the event simulator and the cluster scheduler size
        every message with): the static spec's bytes for a qdq-only
        codec, the per-leaf packed format's for QuantCodec."""
        b = self._leaf_wire_bytes(int(n_elements))
        self._observe_wire(b, int(n_elements), tier="leaf")
        return b

    def flat_qdq(self, flat: torch.Tensor, key, *,
                 bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                 donate: bool = False) -> torch.Tensor:
        """Fused qdq over one flat fp32 buffer: here one application of
        the operator to the whole buffer (QuantCodec buckets it)."""
        del bucket_elems, donate
        return self.qdq(flat, key)

    def tree_qdq_flat(self, tree, key, *,
                      bucket_elems: int = DEFAULT_BUCKET_ELEMS):
        """Whole-tree fused qdq through one flat buffer; the buffer is
        this call's own, so it may be written over."""
        layout = FlatLayout.from_tree(tree)
        return layout.unflatten(self.flat_qdq(
            layout.flatten(tree), key, bucket_elems=bucket_elems,
            donate=True))

    def tree_wire_bytes_flat(self, tree, *,
                             bucket_elems: int = DEFAULT_BUCKET_ELEMS
                             ) -> float:
        """Wire bytes of the ONE fused message for ``tree``: the static
        spec's bytes (one header per message) for a qdq-only codec."""
        del bucket_elems
        total = FlatLayout.from_tree(tree).total
        b = self.spec.compressed_bytes(total)
        self._observe_wire(b, total, tier="flat")
        return b

    def tree_wire_bytes_partitioned(self, tree, n_parts: int, *,
                                    bucket_elems: int = DEFAULT_BUCKET_ELEMS
                                    ) -> float:
        """Wire bytes of ONE partition message: the static-spec bytes of
        a 1/n_parts slice (QuantCodec measures its packed format)."""
        del bucket_elems
        total = FlatLayout.from_tree(tree).total
        return self.spec.compressed_bytes(-(-total // n_parts))

    # -- trees, leaf by leaf ------------------------------------------------

    def tree_qdq(self, tree, key):
        return tree_compress(tree, key, self.qdq)

    def tree_encode(self, tree, key):
        """Leaf-wise encode with independent keys -> tree of Packed."""
        leaves, treedef = pytree.tree_flatten(tree)
        keys = prng.split(key, len(leaves))
        return pytree.tree_unflatten(
            treedef, [self.encode(leaf, k) for leaf, k in zip(leaves, keys)])

    def tree_decode(self, tree):
        """Inverse of tree_encode (tree of Packed -> tree of tensors)."""
        return pytree.tree_map(self.decode, tree)

    def tree_wire_bytes(self, tree) -> float:
        return sum(self.wire_bytes(leaf) for leaf in pytree.tree_leaves(tree))

    def tree_qdq_rows(self, tree_w, keys):
        """``tree_qdq`` of each worker's tree in a stacked tree (leading
        worker dim N on every leaf), worker i under ``keys[i]``."""
        n = len(keys)
        rows = [self.tree_qdq(pytree.tree_map(lambda a: a[i], tree_w),
                              keys[i]) for i in range(n)]
        return pytree.tree_map(lambda *xs: torch.stack(xs), *rows)

    def _observe_wire(self, wire_b: float, n_elements: int, *,
                      tier: str) -> None:
        """Metrics tap on every host-side wire sizing."""
        if not obs.enabled("metrics"):
            return
        obs.counter("compression.wire_bytes", codec=self.name,
                    tier=tier).inc(wire_b)
        obs.counter("compression.sized_msgs", codec=self.name,
                    tier=tier).inc()
        if wire_b > 0:
            obs.histogram("compression.ratio", codec=self.name).observe(
                4.0 * n_elements / wire_b)


def _encode_partitions(flat: torch.Tensor, key, *, n_parts: int,
                       part_elems: int, bits: int, bucket_elems: int):
    """THE partition-encode pipeline: edge-pad the flat buffer to
    n_parts * part_elems, view it as equal partitions, and encode
    partition p under fold_in(key, p) -> (payload (n_parts, rows_p, 512),
    params (n_parts, nb_p, 2)). The ring exchange's own encodes key
    per (worker, hop) instead."""
    padded = ops.edge_pad(flat.reshape(-1).float(), n_parts * part_elems)
    pays, pars = [], []
    for p in range(n_parts):
        pay, par = ops.encode_flat(
            padded[p * part_elems:(p + 1) * part_elems],
            prng.fold_in(key, p), bits=bits, bucket_elems=bucket_elems)
        pays.append(pay)
        pars.append(par)
    return torch.stack(pays), torch.stack(pars)


class QuantCodec(Codec):
    """Randomized uniform quantization, Eq. (3.1) + Figure 3.1, with the
    packed sub-byte wire format of ``kernels.quant``: the CUDA kernels
    for tensors on the card, their plain versions on the CPU."""

    packable = True

    def __init__(self, bits: int):
        if bits not in (8, 4, 2):
            raise ValueError(f"bits must be 8, 4 or 2, got {bits}")
        self.bits = bits
        self.spec = CompressionSpec(f"rq{bits}", True, float(bits))

    def _leaf_wire_bytes(self, n_elements: int) -> float:
        """payload rows x 512 + the (1, 2) fp32 params header."""
        return float(ops.leaf_payload_rows(n_elements, bits=self.bits)
                     * ops.LANES + 8)

    def qdq(self, x, key):
        return ops.quantize_dequantize(x, key, bits=self.bits)

    def encode(self, x, key) -> Packed:
        payload, params = ops.encode(x, key, bits=self.bits)
        return Packed(payload, params, tuple(x.shape), x.dtype, self.name)

    def decode(self, packed: Packed):
        return ops.decode(packed.payload, packed.params, shape=packed.shape,
                          bits=self.bits, dtype=packed.dtype)

    # per-leaf, stacked workers: one launch a leaf over the N messages

    def tree_qdq_rows(self, tree_w, keys):
        leaves, treedef = pytree.tree_flatten(tree_w)
        lkeys = [prng.split(k, len(leaves)) for k in keys]
        return pytree.tree_unflatten(treedef, [
            ops.quantize_dequantize_rows(leaf, [lk[j] for lk in lkeys],
                                         bits=self.bits)
            for j, leaf in enumerate(leaves)])

    def tree_encode_rows(self, tree_w, keys) -> list:
        """``tree_encode`` of each worker's tree in a stacked tree ->
        one (payload (N, R, 512), params (N, 2)) pair a leaf, in leaf
        order: row i of leaf l is worker i's Packed payload and params."""
        leaves = pytree.tree_leaves(tree_w)
        lkeys = [prng.split(k, len(leaves)) for k in keys]
        return [ops.encode_rows(leaf, [lk[j] for lk in lkeys],
                                bits=self.bits)
                for j, leaf in enumerate(leaves)]

    def tree_decode_rows(self, msgs: list, layout: FlatLayout):
        """Inverse of ``tree_encode_rows``; ``layout`` is one worker's
        tree's (it gives the leaf shapes, dtypes and tree) -> the stacked
        tree."""
        return pytree.tree_unflatten(layout.treedef, [
            ops.decode_rows(pay, par, shape=shape, bits=self.bits,
                            dtype=dtype)
            for (pay, par), shape, dtype in zip(msgs, layout.shapes,
                                                layout.dtypes)])

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

    def tree_wire_bytes_flat(self, tree, *,
                             bucket_elems: int = DEFAULT_BUCKET_ELEMS
                             ) -> float:
        """Wire bytes of the ONE fused message for ``tree``, from the
        static geometry (payload rows x 512 + 8 bytes per bucket)."""
        layout = FlatLayout.from_tree(tree)
        _, _, nb, _, rows_kept = ops.flat_geometry(
            layout.total, bits=self.bits, bucket_elems=bucket_elems)
        b = float(rows_kept * ops.LANES + nb * 8)
        self._observe_wire(b, layout.total, tier="flat")
        return b

    def _observe_buckets(self, params: torch.Tensor) -> None:
        if obs.enabled("metrics"):
            levels = (1 << self.bits) - 1
            obs.observe_array("quant.bucket_range",
                              (params[:, 1] * levels).cpu(),
                              codec=self.name)

    # partitioned tier: the flat buffer as n_parts equal, granule-aligned
    # slices, each bucketed and packed on its own — the unit of the ring
    # AllReduce's reduce-scatter / all-gather hops.

    def partition_geometry(self, total: int, n_parts: int, *,
                           bucket_elems: int = DEFAULT_BUCKET_ELEMS):
        """(part_elems, nb_p, rows_p) of the N-way partition view."""
        return ops.partition_geometry(total, n_parts, bits=self.bits,
                                      bucket_elems=bucket_elems)

    def encode_partition(self, part: torch.Tensor, key, *,
                         bucket_elems: int = DEFAULT_BUCKET_ELEMS):
        """ONE partition (a granule-aligned (part_elems,) slice) ->
        (payload (rows_p, 512) uint8, params (nb_p, 2)): the ring hop's
        wire message."""
        return ops.encode_flat(part, key, bits=self.bits,
                               bucket_elems=bucket_elems)

    def decode_partition(self, payload, params, *, part_elems: int,
                         bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                         out: Optional[torch.Tensor] = None):
        """Inverse of encode_partition: -> (part_elems,) fp32 (into
        ``out`` when given)."""
        return ops.decode_flat(payload, params, total=part_elems,
                               bits=self.bits, bucket_elems=bucket_elems,
                               out=out)

    def decode_add_encode_partition(self, payload, params, local, key, *,
                                    bucket_elems=DEFAULT_BUCKET_ELEMS):
        """THE fused ring hop (K5): decode the incoming partition
        message, add the local fp32 slice and re-encode under ``key`` —
        bit-identical to ``encode_partition(decode_partition(...) +
        local, key)``. Returns the outgoing (payload, params)."""
        return ops.decode_add_encode_flat(payload, params, local, key,
                                          bits=self.bits,
                                          bucket_elems=bucket_elems)

    def decode_add_encode_partitions(self, payloads, params, locals_, keys,
                                     *, bucket_elems=DEFAULT_BUCKET_ELEMS,
                                     out=None, params_out=None):
        """The fused ring hop of N workers at once (K5, one call):
        worker w's ``decode_add_encode_partition(payloads[w], params[w],
        locals_[w], keys[w])``, stacked -> (payloads (N, rows_p, 512),
        params (N, nb_p, 2)), into ``out`` / ``params_out`` when
        given."""
        return ops.decode_add_encode_partitions(
            payloads, params, locals_, keys, bits=self.bits,
            bucket_elems=bucket_elems, out=out, params_out=params_out)

    def flat_encode_partitioned(self, flat, key, layout: FlatLayout, *,
                                n_parts: int,
                                bucket_elems: int = DEFAULT_BUCKET_ELEMS
                                ) -> PartitionedFlatPacked:
        """Encode every partition of a flat buffer into ONE backing
        (n_parts, rows_p, 512) payload + (n_parts, nb_p, 2) params pair
        (partition p under fold_in(key, p))."""
        part_elems, _, _ = self.partition_geometry(
            layout.total, n_parts, bucket_elems=bucket_elems)
        payload, params = _encode_partitions(
            flat, key, n_parts=n_parts, part_elems=part_elems,
            bits=self.bits, bucket_elems=bucket_elems)
        return PartitionedFlatPacked(payload, params, layout, self.name,
                                     bucket_elems, part_elems)

    def flat_decode_partitioned(self, packed: PartitionedFlatPacked,
                                out: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
        """All partitions -> the (total,) fp32 flat buffer, pad trimmed
        (a view of ``out``, an (n_parts * part_elems,) buffer, when
        given)."""
        pe = packed.part_elems
        if out is None:
            out = torch.empty((packed.n_parts * pe,), dtype=torch.float32,
                              device=packed.payload.device)
        for p in range(packed.n_parts):
            self.decode_partition(*packed.part(p), part_elems=pe,
                                  bucket_elems=packed.bucket_elems,
                                  out=out[p * pe:(p + 1) * pe])
        return out[:packed.layout.total]

    def tree_encode_partitioned(self, tree, key, n_parts: int, *,
                                bucket_elems: int = DEFAULT_BUCKET_ELEMS
                                ) -> PartitionedFlatPacked:
        """Whole tree -> n_parts partition messages over one buffer."""
        layout = FlatLayout.from_tree(tree)
        return self.flat_encode_partitioned(
            layout.flatten(tree), key, layout, n_parts=n_parts,
            bucket_elems=bucket_elems)

    def tree_decode_partitioned(self, packed: PartitionedFlatPacked):
        """Inverse of tree_encode_partitioned."""
        return packed.layout.unflatten(self.flat_decode_partitioned(packed))

    def tree_wire_bytes_partitioned(self, tree, n_parts: int, *,
                                    bucket_elems: int = DEFAULT_BUCKET_ELEMS
                                    ) -> float:
        """Wire bytes of ONE partition message, from the geometry."""
        layout = FlatLayout.from_tree(tree)
        _, nb_p, rows_p = self.partition_geometry(
            layout.total, n_parts, bucket_elems=bucket_elems)
        return float(rows_p * ops.LANES + nb_p * 8)


class QdqCodec(Codec):
    """Adapter for operators without a packed wire format: the
    algorithmic effect of Q is ``fn``; the wire cost comes from the
    static spec."""

    packable = False

    def __init__(self, fn: Callable, spec: CompressionSpec):
        self._fn = fn
        self.spec = spec

    def qdq(self, x, key=None):
        return self._fn(x, key)


# ---------------------------------------------------------------------------
# Operators. Each returns the dequantized tensor (same shape and dtype as
# the input), in plain torch on the input's device.
# ---------------------------------------------------------------------------


def randomized_quantize(x: torch.Tensor, key, *, bits: int = 8
                        ) -> torch.Tensor:
    """Unbiased randomized uniform quantization, Eq. (3.1) + Figure 3.1,
    on the original layout: the reference formulation (QuantCodec runs
    the packed kernels instead). Written as the JAX package's function
    runs op by op: a true division by ``levels`` and an unfused
    ``q * scale + lo``."""
    x32 = x.float()
    lo, hi = x32.min(), x32.max()
    levels = (1 << bits) - 1
    scale = torch.where(hi > lo, (hi - lo) / levels, torch.ones_like(lo))
    norm = (x32 - lo) / scale
    floor = torch.floor(norm)
    u = prng.uniform(key, x.shape, device=x.device)
    q = floor + (u < (norm - floor)).float()
    q = torch.clamp(q, 0.0, float(levels))
    return (q * scale + lo).to(x.dtype)


def randomized_sparsify(x: torch.Tensor, key, *, p: float = 0.1
                        ) -> torch.Tensor:
    """Unbiased randomized sparsification (Wangni et al., 2018): keep
    each coordinate with probability p, rescale kept ones by 1/p."""
    mask = prng.bernoulli(key, p, x.shape, device=x.device)
    return torch.where(mask, x / p, torch.zeros_like(x)).to(x.dtype)


def topk_sparsify(x: torch.Tensor, key=None, *, frac: float = 0.01
                  ) -> torch.Tensor:
    """Biased top-k (by magnitude) sparsification (Section 3.1.1
    caveat 3): keep the coordinates at or above the k-th magnitude."""
    del key
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs().float(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return kept.reshape(x.shape)


def onebit_sign(x: torch.Tensor, key=None) -> torch.Tensor:
    """Biased 1-bit quantization ||x||_1/d * sign(x) (Bernstein et al.,
    2018)."""
    del key
    x32 = x.float()
    return (x32.abs().mean() * torch.sign(x32)).to(x.dtype)


def clip_lowbits(x: torch.Tensor, key=None, *, keep_bits: int = 16
                 ) -> torch.Tensor:
    """Biased deterministic clipping: zero the low mantissa bits
    (Section 3.2); keep_bits=16 is fp32 -> bf16 truncation."""
    del key
    mask = (0xFFFFFFFF << (32 - keep_bits)) & 0xFFFFFFFF
    mask = mask - (1 << 32) if mask >= 1 << 31 else mask   # as int32
    raw = x.float().contiguous().view(torch.int32)
    return (raw & mask).view(torch.float32).to(x.dtype)


def identity(x: torch.Tensor, key=None) -> torch.Tensor:
    del key
    return x


CODECS: Registry = Registry("compression", {
    "none": QdqCodec(identity,
                     CompressionSpec("none", True, 32.0, overhead_bytes=0)),
    "rq8": QuantCodec(8),
    "rq4": QuantCodec(4),
    "rq2": QuantCodec(2),
    "rand_sparse_10": QdqCodec(
        partial(randomized_sparsify, p=0.1),
        CompressionSpec("rand_sparse_10", True, 32.0, density=0.1)),
    "topk_1": QdqCodec(partial(topk_sparsify, frac=0.01),
                       CompressionSpec("topk_1", False, 32.0, density=0.01)),
    "sign1": QdqCodec(onebit_sign, CompressionSpec("sign1", False, 1.0)),
    "clip16": QdqCodec(clip_lowbits, CompressionSpec("clip16", False, 16.0)),
})


def codec(name: str) -> Codec:
    return CODECS.get(name)


# The function form: name -> (fn(x, key) -> x_hat, CompressionSpec), for
# callers that hold the raw operator; the exchanges go through codec().
REGISTRY: dict = {name: (c.qdq, c.spec) for name, c in CODECS.items()}


def get(name: str) -> tuple:
    if name not in REGISTRY:
        raise KeyError(f"unknown compression '{name}'; have "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]


def tree_compress(tree, key, fn: Callable):
    """Apply Q leaf-wise with independent keys (``split(key, n_leaves)``
    in the JAX leaf order)."""
    leaves, treedef = pytree.tree_flatten(tree)
    keys = prng.split(key, len(leaves))
    return pytree.tree_unflatten(
        treedef, [fn(leaf, k) for leaf, k in zip(leaves, keys)])


def tree_bytes(tree, spec: CompressionSpec) -> float:
    """Total wire bytes of a tree message under a static ``spec``."""
    return sum(spec.compressed_bytes(leaf.numel())
               for leaf in pytree.tree_leaves(tree))


# ---------------------------------------------------------------------------
# Wire integrity: CRC32 framing over packed codes + params
# ---------------------------------------------------------------------------


class WireCorruptionError(ValueError):
    """A packed wire message failed its integrity check on receive."""


def _wire_children(packed) -> tuple:
    """(payload, params) as host numpy arrays, any wire class."""
    return (np.ascontiguousarray(packed.payload.detach().cpu().numpy()),
            np.ascontiguousarray(packed.params.detach().cpu().numpy()))


def wire_crc32(packed) -> int:
    """CRC32 over the packed codes then the dequantization params (the
    contiguous host arrays are read in place, not copied to bytes)."""
    pay, par = _wire_children(packed)
    return zlib.crc32(par, zlib.crc32(pay)) & 0xFFFFFFFF


def wire_bits(packed) -> int:
    """Total framed bits (payload + params) — the bit-flip domain."""
    return packed.wire_bytes * 8


def frame(packed) -> tuple:
    """``(packed, crc)`` — what a framed send puts on the wire."""
    return packed, wire_crc32(packed)


def verify_wire(packed, crc: int, *, where: str = "wire") -> None:
    """Raise ``WireCorruptionError`` unless the frame checks out."""
    got = wire_crc32(packed)
    want = int(crc) & 0xFFFFFFFF
    if got != want:
        raise WireCorruptionError(
            f"{where}: CRC32 mismatch on packed message "
            f"(got 0x{got:08x}, frame says 0x{want:08x}) — payload or "
            "params corrupted in flight")


def checked_decode(cdc: Codec, packed, crc: int, *,
                   where: str = "wire") -> torch.Tensor:
    """Verify the frame, then decode (a FlatPacked through the flat
    tier, a Packed leaf through ``decode``); the receive edge in one
    call."""
    verify_wire(packed, crc, where=where)
    out = (cdc.flat_decode(packed) if isinstance(packed, FlatPacked)
           else cdc.decode(packed))
    guard_finite(out, where=where)
    return out


def flip_bit(packed, bit: int):
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
