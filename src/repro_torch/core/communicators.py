"""The paper's system relaxations as composable gradient/model exchanges,
over a stacked worker dimension or over the ranks of a process group.

The port of ``repro.core.communicators``. JAX runs each exchange per
worker under ``vmap``/``shard_map`` with collectives over a named axis.
The port has two forms of that axis, chosen by ``axis_name``:

  * ``axis_name=None`` (the default): the map written out over a
    STACKED worker dimension on one device. An exchange takes the
    stacked gradient tree (every leaf has a leading worker dim N) and
    its stacked state, and returns the stacked update and state;
    ``lax.ppermute(x, perm)`` is a gather on dim 0 (``_ppermute``),
    ``lax.pmean`` a mean over dim 0, ``axis_index`` the row number.
  * ``axis_name=`` a ``RankAxis`` (``RankAxis(group)`` over a
    ``torch.distributed`` process group): one worker a rank, as JAX's
    exchanges under ``shard_map``. An exchange takes this rank's own tree and
    state; ``ppermute`` is point-to-point sends and receives (one
    ``batch_isend_irecv`` a call), ``pmean`` an all-reduce and a true
    division by N, ``axis_index`` the rank. ``init(params,
    axis_name=...)`` (``init_stacked`` for DCD/ECD) builds one rank's
    state from its own tree.

``_worker_key`` is ``fold_in(key, i)`` for worker i in both. Names, keys
and argument order are otherwise JAX's, so both packages draw the same
bits and the ring's chains are bit-identical to JAX's.

  MbSGDExchange      distributed baseline, Eq. (2.2)        pmean
  CSGDPSExchange     Eq. (3.2)  Q(1/N sum Q(g_n))           multi-server PS form
  CSGDRingExchange   Eq. (3.3)  per-partition chains        partitioned ring
                     (reduce-scatter + all-gather, Fig 3.3) AllReduce on K5
  ECSGDExchange      Eqs. (3.8)-(3.12) DoubleSqueeze        two-sided EC
  DelayedExchange    Assumption 5 bounded staleness (tau)   wraps any exchange
  GossipMix          Eq. (5.2)  X <- (X - gamma G) W        gathers over any W
  DCDGossipExchange  difference-compressed DSGD             compressed gossip
  ECDGossipExchange  error-compensated DCD variant          + flat residual

``flat=True`` (the JAX default) runs the fused flat tier: one message
per exchange step. ``flat=False`` runs the per-leaf reference tier, one
message per leaf: the PS forms and ECSGD (with per-leaf error trees)
through ``tree_qdq``, the ring through a chain of per-leaf ``Packed``
messages (``tree_encode`` / ``tree_decode``) for a packable codec. The
codec launches each leaf once over the N stacked workers' messages
(``Codec.tree_qdq_rows``, ``QuantCodec.tree_encode_rows`` /
``tree_decode_rows``); a step of L leaves and N workers launches K4
(``leaf_qdq``) 2L times on the PS forms and ECSGD, and K2
(``leaf_encode_packed``) and K3 (``leaf_decode_packed``) NL times each
on the ring. Every exchange reports the wire bytes one worker sends per
iteration via ``message_bytes``. Exchanges return new tensors and leave
their inputs as they are, except where a docstring says a state buffer
is updated in place.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, wraps
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import compression, mixing, prng, pytree
from repro_torch.core.registry import Registry, make_factory

PyTree = Any


def _sized(fn):
    """Metrics tap on every ``message_bytes`` sizing call: the measured
    per-iteration wire bytes one worker pays under this exchange."""
    @wraps(fn)
    def wrapper(self, tree, **kw):
        b = fn(self, tree, **kw)
        if obs.enabled("metrics"):
            obs.gauge("comm.message_bytes", exchange=self.name).set(b)
            obs.counter("comm.sized_total_bytes",
                        exchange=self.name).inc(b)
        return b
    return wrapper


def _n_workers(tree_w) -> int:
    return int(pytree.tree_leaves(tree_w)[0].shape[0])


def _row(tree_w, i: int):
    """Worker i's tree (views of the stacked leaves)."""
    return pytree.tree_map(lambda a: a[i], tree_w)


def _worker_key(key, i: int):
    return prng.fold_in(key, i)


def _ppermute(x: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute`` over dim 0: row dst receives row src for each
    (src, dst) pair of ``perm``."""
    idx = [0] * x.shape[0]
    for src, dst in perm:
        idx[dst] = src
    return x[idx]


def _pmean(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmean`` over dim 0: every row holds the mean of the rows."""
    return x.mean(dim=0, keepdim=True).expand_as(x)


class RankAxis:
    """The worker axis over a ``torch.distributed`` process group: one
    worker a rank, the port's counterpart of a JAX ``axis_name`` under
    ``shard_map``.

    ``n`` is the group's size and ``index`` this rank's worker id.
    ``ppermute`` and ``psum``/``pmean`` are JAX's collectives;
    ``sent_bytes`` counts the bytes this rank has sent to other ranks
    through ``ppermute``. A gloo group carries CUDA tensors point to
    point through the host, copied explicitly (gloo's send and receive
    take CPU tensors); an NCCL group sends them from the card. A failed
    send, receive or reduction raises.
    """

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.n = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.sent_bytes = 0
        self._joined = False

    def _peer(self, i: int) -> int:
        return i if self.group is None else \
            self._dist.get_global_rank(self.group, i)

    def _join(self, device) -> None:
        """The group's first collective includes every rank (NCCL's rule
        for a first ``batch_isend_irecv``): one all-reduce of one
        element at the axis's first ``ppermute``, which every rank
        calls, whether or not it sends or receives in it."""
        if not self._joined:
            self._dist.all_reduce(torch.zeros((1,), device=device),
                                  group=self.group)
            self._joined = True

    def ppermute(self, x, perm):
        """``lax.ppermute``: worker dst receives worker src's ``x`` for
        each (src, dst) pair of ``perm``; a rank that receives nothing
        gets zeros, a fixed point (i, i) a local copy. ``x`` is a tensor
        or a list/tuple of tensors, moved in ONE batch of sends and
        receives; returns what this rank received, in the same form."""
        dist = self._dist
        many = isinstance(x, (list, tuple))
        xs = list(x) if many else [x]
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
                not all(0 <= v < self.n for v in srcs + dsts):
            raise ValueError(f"{perm} is not a permutation of {self.n} "
                             "workers")
        self._join(xs[0].device)
        me = self.index
        to = [d for s, d in perm if s == me]
        frm = [s for s, d in perm if d == me]
        if not frm:
            outs = [torch.zeros_like(t) for t in xs]
        elif frm[0] == me:
            outs = [t.clone() for t in xs]
        else:
            outs = [torch.empty(tuple(t.shape), dtype=t.dtype,
                                device=t.device) for t in xs]
        remote_to = bool(to) and to[0] != me
        remote_from = bool(frm) and frm[0] != me
        if remote_to or remote_from:
            staged = "nccl" not in self.backend and xs[0].is_cuda
            host = (lambda t: t.detach().cpu()) if staged else \
                (lambda t: t.detach().contiguous())
            recv = [torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")
                    if staged else o for t, o in zip(xs, outs)]
            ops = []
            sent = got = 0
            if remote_to:
                peer = self._peer(to[0])
                for t in xs:
                    ops.append(dist.P2POp(dist.isend, host(t), peer,
                                          self.group))
                sent = sum(t.numel() * t.element_size() for t in xs)
                self.sent_bytes += sent
            if remote_from:
                peer = self._peer(frm[0])
                ops += [dist.P2POp(dist.irecv, r, peer, self.group)
                        for r in recv]
                got = sum(r.numel() * r.element_size() for r in recv)
            with obs.span("comm.sendrecv", args={
                    "sent_bytes": sent, "recv_bytes": got,
                    "to": to[0] if remote_to else None,
                    "from": frm[0] if remote_from else None}):
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            if staged and remote_from:
                for o, r in zip(outs, recv):
                    o.copy_(r)
        return outs if many else outs[0]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the sum over the workers, on every rank (a new
        tensor)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return out

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmean``: the sum over the workers, truly divided by N."""
        return self.psum(x).div_(self.n)


def worker_axis(axis_name):
    """The worker axis an exchange runs over: None (the stacked dim) or a
    ``RankAxis``; anything else raises."""
    if axis_name is None or isinstance(axis_name, RankAxis):
        return axis_name
    raise TypeError(f"axis_name is None or a RankAxis, not {axis_name!r}")


def _tree_pmean(axis: RankAxis, tree):
    """``lax.pmean`` of every leaf of a tree, as ONE all-reduce of the
    flattened tree."""
    layout = compression.FlatLayout.from_tree(tree)
    return layout.unflatten(axis.pmean(layout.flatten(tree)))


def _flatten_w(layout: compression.FlatLayout, tree_w, *,
               padded_len=None) -> torch.Tensor:
    """Stacked tree -> (N, total) fp32 buffer (each row edge-padded to
    ``padded_len`` with its last real element when given)."""
    leaves = pytree.tree_leaves(tree_w)
    n = leaves[0].shape[0]
    width = layout.total if padded_len is None else padded_len
    out = torch.empty((n, width), dtype=torch.float32,
                      device=leaves[0].device)
    for leaf, off, size in zip(leaves, layout.offsets, layout.sizes):
        out[:, off:off + size] = leaf.reshape(n, size)
    if width > layout.total:
        out[:, layout.total:] = out[:, layout.total - 1:layout.total]
    return out


def _unflatten_w(layout: compression.FlatLayout, flat_w: torch.Tensor):
    """(N, >= total) buffer -> stacked tree (fp32 leaves are views)."""
    n = flat_w.shape[0]
    leaves = [flat_w[:, o:o + s].reshape((n,) + tuple(shape)).to(dtype)
              for o, s, shape, dtype in zip(layout.offsets, layout.sizes,
                                            layout.shapes, layout.dtypes)]
    return pytree.tree_unflatten(layout.treedef, leaves)


def _layout_w(tree_w) -> compression.FlatLayout:
    """The FlatLayout of one worker's tree."""
    return compression.FlatLayout.from_tree(_row(tree_w, 0))


def _fp32_bytes(tree) -> float:
    """Uncompressed fp32 wire bytes of one message (the 'none' codec)."""
    return compression.codec("none").tree_wire_bytes_flat(tree)


def _add(a, b):
    return pytree.tree_map(torch.add, a, b)


def _sub_(a, b):
    """a - b into a's own leaves."""
    return pytree.tree_map(torch.Tensor.sub_, a, b)


# `message_bytes(tree, n_workers=...)` on every exchange reports the wire
# bytes ONE worker sends per iteration under the exchange's native
# pattern, for one worker's (unstacked) tree.


@dataclasses.dataclass(frozen=True)
class MbSGDExchange:
    """Synchronous data-parallel baseline: exact mean of worker gradients."""

    name: str = "mbsgd"

    def init(self, params_w: PyTree, *, axis_name=None) -> PyTree:
        return ()

    def __call__(self, grad: PyTree, state: PyTree, key, *, axis_name=None):
        axis = worker_axis(axis_name)
        if axis is not None:
            return _tree_pmean(axis, grad), state
        return pytree.tree_map(_pmean, grad), state

    @_sized
    def message_bytes(self, tree, *, n_workers: int = 1) -> float:
        """Uplink + broadcast share, fp32."""
        del n_workers
        return 2.0 * _fp32_bytes(tree)


@dataclasses.dataclass(frozen=True)
class CSGDPSExchange:
    """CSGD, multi-server parameter-server form, Eq. (3.2).

    Workers quantize independently (per-worker key); the server's
    outgoing compression uses a key shared by all workers, so the
    broadcast value is identical everywhere: it is computed once and
    given to every row. Both directions use the fused qdq (bit-identical
    to a decode(encode(.)) round trip)."""

    compressor: str = "rq8"
    name: str = "csgd_ps"
    flat: bool = True

    def init(self, params_w: PyTree, *, axis_name=None) -> PyTree:
        return ()

    def __call__(self, grad, state, key, *, axis_name=None):
        cdc = compression.codec(self.compressor)
        skey = prng.fold_in(key, 0x5E4E4)
        axis = worker_axis(axis_name)
        if axis is not None:
            return self._on_ranks(grad, key, skey, cdc, axis), state
        n = _n_workers(grad)
        if not self.flat:
            local_q = cdc.tree_qdq_rows(grad, [_worker_key(key, i)
                                               for i in range(n)])
            mean_q = pytree.tree_map(lambda a: a.mean(dim=0), local_q)
            out = cdc.tree_qdq(mean_q, skey)
            return pytree.tree_map(
                lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape)),
                out), state
        layout = _layout_w(grad)
        local_q = _flatten_w(layout, grad)
        for i in range(local_q.shape[0]):
            local_q[i] = cdc.flat_qdq(local_q[i], _worker_key(key, i),
                                      donate=True)
        out = cdc.flat_qdq(local_q.mean(dim=0), skey, donate=True)
        return _unflatten_w(layout, out.expand_as(local_q)), state

    def _on_ranks(self, grad, key, skey, cdc, axis: RankAxis):
        """This rank's worker: its qdq, the pmean, the server's shared-key
        qdq (so every rank holds the same bits)."""
        wkey = _worker_key(key, axis.index)
        if not self.flat:
            return cdc.tree_qdq(_tree_pmean(axis, cdc.tree_qdq(grad, wkey)),
                                skey)
        layout = compression.FlatLayout.from_tree(grad)
        local_q = cdc.flat_qdq(layout.flatten(grad), wkey, donate=True)
        return layout.unflatten(cdc.flat_qdq(axis.pmean(local_q), skey,
                                             donate=True))

    @_sized
    def message_bytes(self, tree, *, n_workers: int = 1) -> float:
        """One worker->server message + this worker's share of the
        broadcast."""
        del n_workers
        cdc = compression.codec(self.compressor)
        if self.flat:
            return 2.0 * cdc.tree_wire_bytes_flat(tree)
        return 2.0 * cdc.tree_wire_bytes(tree)


@dataclasses.dataclass(frozen=True)
class CSGDRingExchange:
    """CSGD, ring-AllReduce form, Eq. (3.3) — partitioned by default.

    partitioned=True (needs a packable codec): reduce-scatter +
    all-gather with the paper's per-partition requantization chains
    (Figure 3.3). Each worker's flat gradient is edge-padded to
    N * part_elems and cut into N equal granule-aligned partitions:

      * reduce-scatter, N-1 hops: worker i first encodes its own
        partition i under its worker key; at hop h it receives the
        message of worker i-1, and decodes it, adds its own slice of
        partition (i - h) mod N and re-encodes under fold_in(wkey_i, h)
        in ONE fused call (K5 on the card) — partition p accumulates
        Q(..Q(Q(g_p[p]) + g_{p+1}[p]).. + g_{p+N-1}[p]);
      * all-gather, N-1 hops: finished partitions circulate VERBATIM
        into one (N, N, rows_p, 512) backing payload (worker i's row of
        it is its PartitionedFlatPacked), so every worker ends
        bit-identical.

    Per-worker wire bytes: 2(N-1) partition messages = 2*M*(N-1)/N, vs
    the monolithic chain's (N-1)*M. partitioned=False keeps the
    monolithic chain (ONE whole-tree FlatPacked per hop, per-worker
    nesting orders); non-packable codecs fall back to the qdq chain.

    The bucket cap is ``compression.DEFAULT_BUCKET_ELEMS``, read at call
    time.
    """

    compressor: str = "rq8"
    name: str = "csgd_ring"
    flat: bool = True
    partitioned: bool = True

    def init(self, params_w: PyTree, *, axis_name=None) -> PyTree:
        return ()

    def __call__(self, grad, state, key, *, axis_name=None):
        cdc = compression.codec(self.compressor)
        axis = worker_axis(axis_name)
        if axis is not None:
            return self._on_ranks(grad, key, cdc, axis), state
        n = _n_workers(grad)
        if not self.flat:
            return self._per_leaf_chain(grad, state, key, cdc, n)
        if self.partitioned and cdc.packable and n > 1:
            return self._partitioned_allreduce(grad, state, key, cdc, n)
        layout = _layout_w(grad)
        gflat = _flatten_w(layout, grad)
        wkeys = [_worker_key(key, i) for i in range(n)]
        be = compression.DEFAULT_BUCKET_ELEMS
        if cdc.packable and n > 1:
            acc = [cdc.flat_encode(gflat[i], wkeys[i], layout,
                                   bucket_elems=be) for i in range(n)]
            for h in range(1, n):
                shifted = [acc[(i - 1) % n] for i in range(n)]
                acc = [cdc.flat_encode(
                    cdc.flat_decode(shifted[i]) + gflat[i],
                    prng.fold_in(wkeys[i], h), layout, bucket_elems=be)
                    for i in range(n)]
            out = torch.stack([cdc.flat_decode(a) for a in acc])
        else:
            out = torch.stack([cdc.flat_qdq(gflat[i], wkeys[i],
                                            bucket_elems=be)
                               for i in range(n)])
            for h in range(1, n):
                shifted = _ppermute(out, [(i, (i + 1) % n)
                                          for i in range(n)])
                out = torch.stack([cdc.flat_qdq(
                    shifted[i] + gflat[i], prng.fold_in(wkeys[i], h),
                    bucket_elems=be, donate=True) for i in range(n)])
        return _unflatten_w(layout, out.div_(n)), state

    def _per_leaf_chain(self, grad, state, key, cdc, n: int):
        """The per-leaf reference chains: a tree of Packed messages moves
        one step right a hop (the packable codecs), or the qdq'd tree
        (the others); the one division by N comes after the last
        decode."""
        perm = [(i, (i + 1) % n) for i in range(n)]
        wkeys = [_worker_key(key, i) for i in range(n)]
        if cdc.packable and n > 1:
            layout = _layout_w(grad)
            acc = cdc.tree_encode_rows(grad, wkeys)
            for h in range(1, n):
                shifted = [(_ppermute(pay, perm), _ppermute(par, perm))
                           for pay, par in acc]
                summed = _add(cdc.tree_decode_rows(shifted, layout), grad)
                acc = cdc.tree_encode_rows(
                    summed, [prng.fold_in(k, h) for k in wkeys])
            out = cdc.tree_decode_rows(acc, layout)
        else:
            out = cdc.tree_qdq_rows(grad, wkeys)
            for h in range(1, n):
                summed = _add(pytree.tree_map(
                    lambda a: _ppermute(a, perm), out), grad)
                out = cdc.tree_qdq_rows(summed,
                                        [prng.fold_in(k, h) for k in wkeys])
        return pytree.tree_map(lambda a: a / n, out), state

    def _partitioned_allreduce(self, grad, state, key, cdc, n: int):
        """Reduce-scatter + all-gather over the N-way partition view."""
        layout = _layout_w(grad)
        be = compression.DEFAULT_BUCKET_ELEMS
        part_elems, _, _ = cdc.partition_geometry(layout.total, n,
                                                  bucket_elems=be)
        gparts = _flatten_w(layout, grad, padded_len=n * part_elems).view(
            n, n, part_elems)                    # [worker, partition]
        wkeys = [_worker_key(key, i) for i in range(n)]

        # reduce-scatter: worker i starts with its own partition i; hop h
        # ships the partial sum of partition (i - h) mod N one step right,
        # all N workers in one K5 call reading their slices of gparts
        # in place; a hop writes its stacked messages over the ones of two
        # hops back
        msgs = [cdc.encode_partition(gparts[i, i], wkeys[i],
                                     bucket_elems=be) for i in range(n)]
        pay, prm = [m[0] for m in msgs], [m[1] for m in msgs]
        spare = (None, None)
        for h in range(1, n):
            sent = cdc.decode_add_encode_partitions(
                [pay[(i - 1) % n] for i in range(n)],
                [prm[(i - 1) % n] for i in range(n)],
                [gparts[i, (i - h) % n] for i in range(n)],
                [prng.fold_in(wkeys[i], h) for i in range(n)],
                bucket_elems=be, out=spare[0], params_out=spare[1])
            spare = (pay, prm) if h > 1 else (None, None)
            pay, prm = sent
        del gparts, msgs, spare

        # all-gather: worker i finished partition (i + 1) mod N; N - 1
        # hops forward finished messages verbatim one step right, into the
        # backing buffer of every worker (after g hops worker i holds
        # worker (i - g) mod N's message)
        payload_all = torch.empty((n,) + tuple(pay.shape), dtype=pay.dtype,
                                  device=pay.device)
        params_all = torch.empty((n,) + tuple(prm.shape), dtype=prm.dtype,
                                 device=prm.device)
        rows = torch.arange(n, device=pay.device)
        for g in range(n):
            src = (rows - g) % n
            payload_all[rows, (src + 1) % n] = pay[src]
            params_all[rows, (src + 1) % n] = prm[src]

        out = torch.empty((n, n * part_elems), dtype=torch.float32,
                          device=pay.device)
        for i in range(n):
            packed = compression.PartitionedFlatPacked(
                payload_all[i], params_all[i], layout, cdc.name, be,
                part_elems)
            cdc.flat_decode_partitioned(packed, out=out[i])
        return _unflatten_w(layout, out.div_(n)), state

    def _on_ranks(self, grad, key, cdc, axis: RankAxis):
        """This rank's worker of JAX's exchange: the partitioned ring, the
        monolithic chain of one FlatPacked a hop, the per-leaf chain of
        Packed messages, or the qdq chain (non-packable codecs, or one
        worker); every hop is one ``ppermute`` one step right."""
        n, i = axis.n, axis.index
        perm = [(j, (j + 1) % n) for j in range(n)]
        wkey = _worker_key(key, i)
        be = compression.DEFAULT_BUCKET_ELEMS
        if cdc.packable and n > 1:
            if not self.flat:
                return self._per_leaf_on_ranks(grad, wkey, cdc, axis, perm)
            if self.partitioned:
                return self._partitioned_on_ranks(grad, wkey, cdc, axis,
                                                  perm)
        layout = compression.FlatLayout.from_tree(grad)
        gflat = layout.flatten(grad)
        if cdc.packable and n > 1:
            acc = cdc.flat_encode(gflat, wkey, layout, bucket_elems=be)
            for h in range(1, n):
                pay, prm = axis.ppermute((acc.payload, acc.params), perm)
                shifted = compression.FlatPacked(pay, prm, layout, cdc.name,
                                                 be)
                acc = cdc.flat_encode(cdc.flat_decode(shifted) + gflat,
                                      prng.fold_in(wkey, h), layout,
                                      bucket_elems=be)
            return layout.unflatten(cdc.flat_decode(acc).div_(n))
        if not self.flat:
            out = cdc.tree_qdq(grad, wkey)
            for h in range(1, n):
                leaves, treedef = pytree.tree_flatten(out)
                shifted = pytree.tree_unflatten(
                    treedef, axis.ppermute(leaves, perm))
                out = cdc.tree_qdq(_add(shifted, grad),
                                   prng.fold_in(wkey, h))
            return pytree.tree_map(lambda a: a / n, out)
        out = cdc.flat_qdq(gflat, wkey, bucket_elems=be)
        for h in range(1, n):
            out = cdc.flat_qdq(axis.ppermute(out, perm) + gflat,
                               prng.fold_in(wkey, h), bucket_elems=be,
                               donate=True)
        return layout.unflatten(out.div_(n))

    def _per_leaf_on_ranks(self, grad, wkey, cdc, axis: RankAxis, perm):
        """The per-leaf chain: a hop moves the tree of Packed messages
        (every payload and params) in one ``ppermute``."""
        n = axis.n
        acc = cdc.tree_encode(grad, wkey)
        for h in range(1, n):
            msgs, treedef = pytree.tree_flatten(acc)
            moved = axis.ppermute([t for m in msgs
                                   for t in (m.payload, m.params)], perm)
            shifted = pytree.tree_unflatten(treedef, [
                compression.Packed(moved[2 * j], moved[2 * j + 1], m.shape,
                                   m.dtype, m.codec)
                for j, m in enumerate(msgs)])
            acc = cdc.tree_encode(_add(cdc.tree_decode(shifted), grad),
                                  prng.fold_in(wkey, h))
        return pytree.tree_map(lambda a: a / n, cdc.tree_decode(acc))

    def _partitioned_on_ranks(self, grad, wkey, cdc, axis: RankAxis, perm):
        """Reduce-scatter + all-gather of this rank's worker: it encodes
        its own partition once, then each of N-1 hops receives a
        partition message from the rank on its left, decodes it, adds its
        own slice and re-encodes (ONE K5 call on one partition) and sends
        the result right; N-1 all-gather hops forward finished messages
        verbatim into the (N, rows_p, 512) backing buffer, decoded once.
        Spans: ``ring.exchange`` around ``ring.encode``, N-1 ``ring.hop``
        (wire + K5), N-1 ``ring.gather`` and ``ring.decode``."""
        n, i = axis.n, axis.index
        with obs.span("ring.exchange", args={"workers": n}):
            with obs.span("ring.encode"):
                layout = compression.FlatLayout.from_tree(grad)
                be = compression.DEFAULT_BUCKET_ELEMS
                part_elems, _, _ = cdc.partition_geometry(layout.total, n,
                                                          bucket_elems=be)
                gparts = layout.flatten(grad, padded_len=n * part_elems
                                        ).view(n, part_elems)
                pay, prm = cdc.encode_partition(gparts[i], wkey,
                                                bucket_elems=be)
            for h in range(1, n):
                with obs.span("ring.hop", args={"hop": h}):
                    pay, prm = axis.ppermute((pay, prm), perm)
                    pay, prm = cdc.decode_add_encode_partition(
                        pay, prm, gparts[(i - h) % n], prng.fold_in(wkey, h),
                        bucket_elems=be)
            del gparts
            payload_all = torch.empty((n,) + tuple(pay.shape),
                                      dtype=pay.dtype, device=pay.device)
            params_all = torch.empty((n,) + tuple(prm.shape),
                                     dtype=prm.dtype, device=prm.device)
            payload_all[(i + 1) % n] = pay
            params_all[(i + 1) % n] = prm
            for g in range(1, n):
                with obs.span("ring.gather", args={"hop": g}):
                    pay, prm = axis.ppermute((pay, prm), perm)
                    payload_all[(i + 1 - g) % n] = pay
                    params_all[(i + 1 - g) % n] = prm
            with obs.span("ring.decode"):
                packed = compression.PartitionedFlatPacked(
                    payload_all, params_all, layout, cdc.name, be,
                    part_elems)
                return layout.unflatten(
                    cdc.flat_decode_partitioned(packed).div_(n))

    @_sized
    def message_bytes(self, tree, *, n_workers: int = 2) -> float:
        """Partitioned: 2(n-1) partition messages per iteration;
        monolithic: n-1 hops of one whole-tree message each (per leaf
        with ``flat=False``)."""
        cdc = compression.codec(self.compressor)
        hops = max(n_workers - 1, 1)
        be = compression.DEFAULT_BUCKET_ELEMS
        if not self.flat:
            return hops * cdc.tree_wire_bytes(tree)
        if self.partitioned and cdc.packable and n_workers > 1:
            return 2.0 * hops * cdc.tree_wire_bytes_partitioned(
                tree, n_workers, bucket_elems=be)
        return hops * cdc.tree_wire_bytes_flat(tree, bucket_elems=be)

    def n_wire_messages(self, n_workers: int) -> int:
        """Wire messages one worker sends per iteration: 2(n-1) partition
        messages on the partitioned path, n-1 on the monolithic chain."""
        cdc = compression.codec(self.compressor)
        hops = max(n_workers - 1, 1)
        if self.flat and self.partitioned and cdc.packable and n_workers > 1:
            return 2 * hops
        return hops


@dataclasses.dataclass(frozen=True)
class ECSGDExchange:
    """Error-compensated SGD / DoubleSqueeze, Eqs. (3.8)-(3.12).

    Worker side:  v_n = g_n + delta_n ; send Q(v_n) ; delta_n = v_n - Q(v_n)
    Server side:  v = mean_n Q(v_n) + delta ; bcast Q(v) ; delta = v - Q(v)

    Works with ANY codec, biased ones included (Section 3.3). With
    ``flat=True`` both error buffers are single flat fp32 residuals per
    worker, stacked: state ``{"worker_err": (N, total), "server_err":
    (N, total)}``; with ``flat=False`` they are per-leaf error trees
    shaped like the stacked parameters (the reference formulation).
    """

    compressor: str = "sign1"
    name: str = "ecsgd"
    flat: bool = True

    def init(self, params_w: PyTree, *, axis_name=None) -> PyTree:
        """The stacked residuals, or one rank's (``axis_name`` given:
        ``params_w`` is its own tree, the flat buffers (total,))."""
        if not self.flat:
            z = pytree.tree_map(torch.zeros_like, params_w)
            return {"worker_err": z,
                    "server_err": pytree.tree_map(torch.zeros_like, z)}
        dev = pytree.tree_leaves(params_w)[0].device
        if axis_name is not None:
            shape = (compression.FlatLayout.from_tree(params_w).total,)
        else:
            shape = (_n_workers(params_w), _layout_w(params_w).total)
        return {"worker_err": torch.zeros(shape, device=dev),
                "server_err": torch.zeros(shape, device=dev)}

    def __call__(self, grad, state, key, *, axis_name=None):
        cdc = compression.codec(self.compressor)
        skey = prng.fold_in(key, 0x5E4E4)
        axis = worker_axis(axis_name)
        if axis is not None:
            return self._on_ranks(grad, state, key, skey, cdc, axis)
        n = _n_workers(grad)
        if not self.flat:
            v_n = _add(grad, state["worker_err"])
            q_n = cdc.tree_qdq_rows(v_n, [_worker_key(key, i)
                                          for i in range(n)])
            v = _add(pytree.tree_map(_pmean, q_n), state["server_err"])
            out = cdc.tree_qdq_rows(v, [skey] * n)
            # v_n and v are this call's own: the residuals overwrite them
            return out, {"worker_err": _sub_(v_n, q_n),
                         "server_err": _sub_(v, out)}
        layout = _layout_w(grad)
        # worker side (Eqs. 3.8-3.9) on the flat residual buffers
        v_n = _flatten_w(layout, grad).add_(state["worker_err"])
        q_n = torch.stack([cdc.flat_qdq(v_n[i], _worker_key(key, i))
                           for i in range(n)])
        # server side (Eqs. 3.10-3.11); shared key -> identical everywhere
        v = _pmean(q_n) + state["server_err"]
        out = torch.stack([cdc.flat_qdq(v[i], skey) for i in range(n)])
        return _unflatten_w(layout, out), {"worker_err": v_n.sub_(q_n),
                                           "server_err": v.sub_(out)}

    def _on_ranks(self, grad, state, key, skey, cdc, axis: RankAxis):
        """This rank's worker: its residual-corrected qdq, the pmean of
        the workers' messages, the server's shared-key qdq."""
        wkey = _worker_key(key, axis.index)
        if not self.flat:
            v_n = _add(grad, state["worker_err"])
            q_n = cdc.tree_qdq(v_n, wkey)
            v = _add(_tree_pmean(axis, q_n), state["server_err"])
            out = cdc.tree_qdq(v, skey)
            return out, {"worker_err": _sub_(v_n, q_n),
                         "server_err": _sub_(v, out)}
        layout = compression.FlatLayout.from_tree(grad)
        v_n = layout.flatten(grad).add_(state["worker_err"])
        q_n = cdc.flat_qdq(v_n, wkey)
        v = axis.pmean(q_n).add_(state["server_err"])
        out = cdc.flat_qdq(v, skey)
        return layout.unflatten(out), {"worker_err": v_n.sub_(q_n),
                                       "server_err": v.sub_(out)}

    @_sized
    def message_bytes(self, tree, *, n_workers: int = 1) -> float:
        """As CSGDPSExchange: worker->server + broadcast share."""
        del n_workers
        cdc = compression.codec(self.compressor)
        if self.flat:
            return 2.0 * cdc.tree_wire_bytes_flat(tree)
        return 2.0 * cdc.tree_wire_bytes(tree)


@dataclasses.dataclass(frozen=True)
class DelayedExchange:
    """Bounded-staleness wrapper (ASGD, Section 4, Assumption 5).

    Default (``schedule=None``): a length-tau FIFO — the update returned
    at step t is the one computed at step t - tau; the first tau steps
    return the warm-up buffer's zeros.

    ``schedule``: TRACE-DRIVEN per-step staleness, a 1-D sequence s_t
    (all workers) or a 2-D (n_workers, T) table of delays, each clipped
    to [0, tau]; the update returned at step t is the one computed at
    step t - s_t, zeros before one exists; steps past the end wrap.

    State: ``{"inner", "buffer", "head"}``, stacked like JAX's vmapped
    state: each buffer leaf is (N, slots, ...), ``head`` an (N,) int32
    host tensor (the FIFO slot, or the step counter under a schedule).
    The buffer is written in place.
    """

    inner: Any = dataclasses.field(default_factory=MbSGDExchange)
    tau: int = 4
    name: str = "asgd"
    schedule: Any = None      # None | 1-D | 2-D ints; tuple-ized below

    def __post_init__(self):
        if self.schedule is not None:
            s = np.asarray(self.schedule, dtype=int)
            if s.ndim == 1:
                sched = tuple(int(v) for v in s)
            elif s.ndim == 2:
                sched = tuple(tuple(int(v) for v in row) for row in s)
            else:
                raise ValueError("schedule must be 1-D or 2-D")
            object.__setattr__(self, "schedule", sched)

    def _cap(self) -> int:
        # schedule mode needs tau+1 slots: s=0 must read the value written
        # THIS step, while s=tau still reads step t-tau un-clobbered
        return self.tau + 1 if self.schedule is not None else max(self.tau, 1)

    def init(self, params_w: PyTree, *, axis_name=None) -> PyTree:
        """The stacked state, or one rank's (``axis_name`` given: buffer
        leaves (slots, ...), ``head`` a 0-d int32 host tensor)."""
        if axis_name is not None:
            buf = pytree.tree_map(
                lambda p: torch.zeros((self._cap(),) + tuple(p.shape),
                                      dtype=p.dtype, device=p.device),
                params_w)
            return {"inner": self.inner.init(params_w, axis_name=axis_name),
                    "buffer": buf, "head": torch.zeros((), dtype=torch.int32)}
        n = _n_workers(params_w)
        buf = pytree.tree_map(
            lambda p: torch.zeros((n, self._cap()) + tuple(p.shape[1:]),
                                  dtype=p.dtype, device=p.device), params_w)
        return {"inner": self.inner.init(params_w), "buffer": buf,
                "head": torch.zeros((n,), dtype=torch.int32)}

    def __call__(self, grad, state, key, *, axis_name=None):
        axis = worker_axis(axis_name)
        if axis is not None:
            fresh, inner_state = self.inner(grad, state["inner"], key,
                                            axis_name=axis)
            return self._on_ranks(fresh, state, inner_state, axis)
        fresh, inner_state = self.inner(grad, state["inner"], key)
        if self.schedule is not None:
            return self._delayed_by_schedule(fresh, state, inner_state)
        if self.tau <= 0:
            return fresh, {"inner": inner_state, "buffer": state["buffer"],
                           "head": state["head"]}
        head = [int(h) for h in state["head"]]
        rows = range(len(head))

        def swap(b, f):
            stale = torch.stack([b[i, head[i]] for i in rows])
            for i in rows:
                b[i, head[i]] = f[i]
            return stale

        stale = pytree.tree_map(swap, state["buffer"], fresh)
        return stale, {"inner": inner_state, "buffer": state["buffer"],
                       "head": (state["head"] + 1) % self.tau}

    def _delayed_by_schedule(self, fresh, state, inner_state):
        """Write fresh at slot t mod (tau+1), read slot (t - s_t)."""
        steps = [int(h) for h in state["head"]]   # the step counters
        sched = np.asarray(self.schedule, dtype=np.int64)
        n = len(steps)
        if sched.ndim == 2 and sched.shape[0] != n:
            raise ValueError(f"2-D schedule has {sched.shape[0]} rows but "
                             f"there are {n} workers")
        cap = self._cap()
        s_t = [int(np.clip(sched[i, st % sched.shape[1]] if sched.ndim == 2
                           else sched[st % sched.shape[0]], 0, self.tau))
               for i, st in enumerate(steps)]

        def write_read(b, f):
            for i in range(n):
                b[i, steps[i] % cap] = f[i]
            return torch.stack([
                b[i, (steps[i] - s_t[i]) % cap] if steps[i] >= s_t[i]
                else torch.zeros_like(b[i, 0]) for i in range(n)])

        stale = pytree.tree_map(write_read, state["buffer"], fresh)
        return stale, {"inner": inner_state, "buffer": state["buffer"],
                       "head": state["head"] + 1}

    def _on_ranks(self, fresh, state, inner_state, axis: RankAxis):
        """This rank's FIFO, or its row ``axis.index`` of a 2-D
        schedule."""
        head, buf = int(state["head"]), state["buffer"]
        new = {"inner": inner_state, "buffer": buf}
        if self.schedule is None:
            if self.tau <= 0:
                return fresh, dict(new, head=state["head"])

            def swap(b, f):
                stale = b[head].clone()
                b[head] = f
                return stale

            return (pytree.tree_map(swap, buf, fresh),
                    dict(new, head=(state["head"] + 1) % self.tau))
        sched = np.asarray(self.schedule, dtype=np.int64)
        if sched.ndim == 2:
            if sched.shape[0] != axis.n:
                raise ValueError(f"2-D schedule has {sched.shape[0]} rows "
                                 f"but there are {axis.n} workers")
            s_t = sched[axis.index, head % sched.shape[1]]
        else:
            s_t = sched[head % sched.shape[0]]
        s_t = int(np.clip(s_t, 0, self.tau))
        cap = self._cap()

        def write_read(b, f):
            b[head % cap] = f
            return b[(head - s_t) % cap].clone() if head >= s_t \
                else torch.zeros_like(b[0])

        return (pytree.tree_map(write_read, buf, fresh),
                dict(new, head=state["head"] + 1))

    @_sized
    def message_bytes(self, tree, *, n_workers: int = 1) -> float:
        return self.inner.message_bytes(tree, n_workers=n_workers)


def _freeze_w(obj) -> None:
    """Store a frozen dataclass's ``w`` matrix as a nested tuple (keeps
    the exchange hashable — shared by GossipMix and DCD/ECD)."""
    if obj.w is not None:
        w = np.asarray(obj.w, dtype=float)
        object.__setattr__(obj, "w",
                           tuple(tuple(row) for row in w.tolist()))


def _resolve_matrix(w, topology: str, n: int):
    """Explicit (n, n) gossip matrix for a (w, topology) spec: an
    explicit ``w`` wins; otherwise the named ``mixing`` constructor."""
    if w is not None:
        w = np.asarray(w)
        if w.shape != (n, n):
            raise ValueError(f"W is {w.shape}, there are {n} workers")
        return w
    if topology == "ring":
        return mixing.ring(n)
    if topology == "torus":
        return mixing.torus_2d(*mixing.near_square_factors(n))
    if topology == "full":
        return mixing.fully_connected(n)
    raise ValueError(f"unknown topology {topology}")


@dataclasses.dataclass(frozen=True)
class GossipMix:
    """Decentralized model mixing, Eq. (5.2): X_{t+1} = (X_t - gamma G_t) W.

    ``topology='ring'`` is the paper's W2 (self + both neighbors, all
    1/3), two gathers; ``'full'`` is W1 = 11^T/N (a mean over workers).
    ``'torus'`` and an explicit doubly stochastic ``w`` are lowered via
    ``mixing.birkhoff_decomposition``: W = sum_k c_k P_k, one gather per
    non-identity permutation, scaled by c_k — deg(W) is the number of
    wire messages each worker sends per mix. Takes and returns the
    stacked parameter tree.
    """

    topology: str = "ring"
    name: str = "gossip"
    w: Any = None

    def __post_init__(self):
        _freeze_w(self)

    def _matrix(self, n: int):
        """The explicit W for this worker count, or None for the
        ring/full fast paths."""
        if self.w is None and self.topology in ("ring", "full"):
            return None
        return _resolve_matrix(self.w, self.topology, n)

    def __call__(self, params: PyTree, *, axis_name=None) -> PyTree:
        axis = worker_axis(axis_name)
        if axis is not None:
            return self._on_ranks(params, axis)
        n = _n_workers(params)
        w = self._matrix(n)
        if w is not None:
            if n == 1:
                return params
            terms = mixing.birkhoff_decomposition(w)

            def mix(x):
                acc = torch.zeros_like(x)
                for c, perm in terms:
                    acc = acc + c * (x if not perm else _ppermute(x, perm))
                return acc

            return pytree.tree_map(mix, params)
        if self.topology == "full":
            return pytree.tree_map(_pmean, params)
        right = [(i, (i + 1) % n) for i in range(n)]
        left = [(i, (i - 1) % n) for i in range(n)]

        def mix(x):
            if n == 1:
                return x
            xr = _ppermute(x, right)
            xl = _ppermute(x, left)
            if n == 2:  # both neighbors are the same worker: 1/3 self + 2/3 nbr
                return x / 3.0 + 2.0 * xr / 3.0
            return (x + xr + xl) / 3.0

        return pytree.tree_map(mix, params)

    def _on_ranks(self, params, axis: RankAxis):
        """This rank's model mixed with its neighbors': one ``ppermute``
        of every leaf (one batch) a non-identity term."""
        n = axis.n
        w = self._matrix(n)
        if n == 1:
            return params
        if w is None and self.topology == "full":
            return _tree_pmean(axis, params)
        leaves, treedef = pytree.tree_flatten(params)
        if w is not None:
            terms = mixing.birkhoff_decomposition(w)
            moved = [axis.ppermute(leaves, list(perm)) if perm else None
                     for _, perm in terms]
            out = []
            for j, x in enumerate(leaves):
                acc = torch.zeros_like(x)
                for (c, perm), m in zip(terms, moved):
                    acc = acc + c * (x if not perm else m[j])
                out.append(acc)
            return pytree.tree_unflatten(treedef, out)
        xr = axis.ppermute(leaves, [(i, (i + 1) % n) for i in range(n)])
        if n == 2:  # both neighbors are the same worker: 1/3 self + 2/3 nbr
            out = [x / 3.0 + 2.0 * r / 3.0 for x, r in zip(leaves, xr)]
        else:
            xl = axis.ppermute(leaves, [(i, (i - 1) % n) for i in range(n)])
            out = [(x + r + l) / 3.0 for x, r, l in zip(leaves, xr, xl)]
        return pytree.tree_unflatten(treedef, out)

    @_sized
    def message_bytes(self, tree, *, n_workers: int = 3) -> float:
        """Full fp32 model to each neighbor: deg(W) sends per mix."""
        w = self._matrix(n_workers)
        if w is not None:
            degree = mixing.degree(w)
        else:
            degree = 2 if self.topology == "ring" else max(n_workers - 1, 1)
            if self.topology == "ring" and n_workers == 2:
                degree = 1   # both neighbors are the same worker
        return degree * _fp32_bytes(tree)


@lru_cache(maxsize=64)
def _birkhoff_terms_cached(w_rows: tuple):
    """(c_identity, ((c_k, perm_k), ...)) of W's Birkhoff-von Neumann
    decomposition, cached on the nested-tuple matrix."""
    terms = mixing.birkhoff_decomposition(np.asarray(w_rows))
    c_id = sum(c for c, perm in terms if not perm)
    nonid = tuple((c, perm) for c, perm in terms if perm)
    return float(c_id), nonid


@dataclasses.dataclass(frozen=True)
class DCDGossipExchange:
    """Difference-compressed decentralized mixing: DCD-PSGD over any W
    (Section 5 + Tang et al. 2018). Every worker keeps its public copy
    ``x̂_i``; per iteration

      1. ``x_i^{t+1/2} = sum_j W_ij x̂_j^t - gamma g_i``   (mix on replicas)
      2. ``delta_i = x_i^{t+1/2} - x̂_i^t``
      3. ``Q(delta_i)`` through the fused flat codec, ONE message per
         neighbor;
      4. every holder applies the decoded delta, so a worker's model and
         all replicas of it stay bit-identical.

    The replica a receiver adds is the decode of the sender's message,
    which is bit for bit the sender's own decode, so it is gathered from
    the senders' rows rather than decoded again.

    State (stacked flat fp32 buffers): ``xhat`` (N, total), ``nbr``
    (N, K, total), one replica per non-identity Birkhoff term, and for
    ECD ``err`` (N, total). ``init_stacked(params_w)`` builds it;
    ``__call__(params_w, state, key)`` mixes.
    """

    compressor: str = "rq4"
    topology: str = "ring"
    w: Any = None
    name: str = "dcd"
    error_compensated = False        # class attr (ECD subclass flips it)

    def __post_init__(self):
        _freeze_w(self)

    def _matrix(self, n: int):
        return _resolve_matrix(self.w, self.topology, n)

    def birkhoff_terms(self, n: int):
        """(c_identity, ((c_k, perm_k), ...)) — the gather lowering."""
        w = self._matrix(n)
        return _birkhoff_terms_cached(tuple(tuple(row) for row in
                                            w.tolist()))

    def degree(self, n: int) -> int:
        return mixing.degree(self._matrix(n))

    def init_stacked(self, params_w: PyTree, *, axis_name=None) -> PyTree:
        """Replica state from the (n_workers, ...) stacked params:
        nbr[w, k] starts at the term-k source's flattened params. With
        ``axis_name``, one rank's state from its own params: ``xhat``
        (total,), ``nbr`` (K, total) received from the term-k sources."""
        axis = worker_axis(axis_name)
        if axis is not None:
            layout = compression.FlatLayout.from_tree(params_w)
            xhat = layout.flatten(params_w)
            _, terms = self.birkhoff_terms(axis.n)
            nbr = torch.stack([axis.ppermute(xhat, list(perm))
                               for _, perm in terms]) if terms else \
                torch.zeros((0, layout.total), device=xhat.device)
            state = {"xhat": xhat, "nbr": nbr}
            if self.error_compensated:
                state["err"] = torch.zeros_like(xhat)
            return state
        n = _n_workers(params_w)
        layout = _layout_w(params_w)
        xhat = _flatten_w(layout, params_w)                 # (n, total)
        _, terms = self.birkhoff_terms(n)
        if terms:
            idx = np.zeros((len(terms), n), dtype=np.int64)  # idx[k, dst]=src
            for k, (_, perm) in enumerate(terms):
                for src, dst in perm:
                    idx[k, dst] = src
            nbr = xhat[torch.from_numpy(idx.T.copy())]      # (n, K, total)
        else:
            nbr = torch.zeros((n, 0, layout.total), device=xhat.device)
        state = {"xhat": xhat, "nbr": nbr}
        if self.error_compensated:
            state["err"] = torch.zeros_like(xhat)
        return state

    def __call__(self, params: PyTree, state: PyTree, key, *,
                 axis_name=None):
        axis = worker_axis(axis_name)
        if axis is not None:
            return self._on_ranks(params, state, key, axis)
        cdc = compression.codec(self.compressor)
        n = _n_workers(params)
        layout = _layout_w(params)
        c_id, terms = self.birkhoff_terms(n)
        xhat = state["xhat"]
        # the call site hands us x̂_i - gamma g_i (model == public copy)
        y = _flatten_w(layout, params)
        z = c_id * xhat                      # sum_j W_ij x̂_j from replicas
        for k, (c, _) in enumerate(terms):
            z = z + c * state["nbr"][:, k]
        x_half = (y - xhat) + z              # = sum_j W_ij x̂_j - gamma g_i
        v = x_half - xhat                    # the broadcast delta
        if self.error_compensated:
            v = v + state["err"]
        q = torch.empty_like(v)
        for i in range(n):
            wkey = _worker_key(key, i)
            if cdc.packable:
                q[i] = cdc.flat_decode(cdc.flat_encode(v[i], wkey, layout))
            else:
                q[i] = cdc.flat_qdq(v[i], wkey)
        new_xhat = xhat + q
        nbr = state["nbr"].clone()
        for k, (_, perm) in enumerate(terms):
            nbr[:, k] += _ppermute(q, perm)
        new_state = {"xhat": new_xhat, "nbr": nbr}
        if self.error_compensated:
            new_state["err"] = v - q
        return _unflatten_w(layout, new_xhat), new_state

    def _on_ranks(self, params, state, key, axis: RankAxis):
        """This rank's worker: its delta encoded once, the packed wire
        (payload and params) sent to each term's destination, and each
        received message decoded into the term's replica."""
        cdc = compression.codec(self.compressor)
        layout = compression.FlatLayout.from_tree(params)
        c_id, terms = self.birkhoff_terms(axis.n)
        xhat = state["xhat"]
        y = layout.flatten(params)
        z = c_id * xhat
        for k, (c, _) in enumerate(terms):
            z = z + c * state["nbr"][k]
        v = ((y - xhat) + z) - xhat
        if self.error_compensated:
            v = v + state["err"]
        wkey = _worker_key(key, axis.index)
        if cdc.packable:
            wire = cdc.flat_encode(v, wkey, layout)
            q = cdc.flat_decode(wire)
            msg = (wire.payload, wire.params)
        else:
            q = msg = cdc.flat_qdq(v, wkey)
        nbr = state["nbr"].clone()
        for k, (_, perm) in enumerate(terms):
            got = axis.ppermute(msg, list(perm))
            nbr[k] += cdc.flat_decode(compression.FlatPacked(
                *got, layout, cdc.name, wire.bucket_elems)) \
                if cdc.packable else got
        new_state = {"xhat": xhat + q, "nbr": nbr}
        if self.error_compensated:
            new_state["err"] = v - q
        return layout.unflatten(new_state["xhat"]), new_state

    @_sized
    def message_bytes(self, tree, *, n_workers: int = 3) -> float:
        """deg(W) compressed-delta messages per mix."""
        cdc = compression.codec(self.compressor)
        return self.degree(n_workers) * cdc.tree_wire_bytes_flat(tree)

    def n_wire_messages(self, n_workers: int) -> int:
        """One fused message per neighbor per mix."""
        return self.degree(n_workers)


@dataclasses.dataclass(frozen=True)
class ECDGossipExchange(DCDGossipExchange):
    """Error-compensated compressed decentralized mixing: DCD with a
    residual-corrected delta ``v_i = (x_i^{t+1/2} - x̂_i) + e_i``, ship
    ``Q(v_i)``, ``e_i <- v_i - Q(v_i)``; a single flat fp32 residual per
    worker. Default codec: the biased 1-bit ``sign1``."""

    compressor: str = "sign1"
    name: str = "ecd"
    error_compensated = True


EXCHANGES: Registry = Registry("exchange", {
    "mbsgd": MbSGDExchange,
    "csgd_ps": CSGDPSExchange,
    "csgd_ring": CSGDRingExchange,
    "ecsgd": ECSGDExchange,
    "asgd": DelayedExchange,
    "gossip": GossipMix,
    "dcd": DCDGossipExchange,
    "ecd": ECDGossipExchange,
})

make_exchange = make_factory(EXCHANGES)
