"""Carry parameter trees and wire messages across from the JAX package.

Everything crosses as numpy arrays (``np.asarray`` of a jax array), so
this module needs neither jax nor ``repro``:

  * ``params_from_jax``: a parameter tree (nested dicts/lists of arrays;
    the unrolled ``transformer`` tree or the stacked ``transformer_scan``
    one) -> the port's tree of tensors, same keys and shapes; the port
    flattens it in the same (sorted-key) leaf order.
  * ``train_state_from_jax``: a JAX train state (``params``, ``opt``
    with ``step``/``m``/``v``, ``step``, ``rng``, ``ec_err``) -> the
    port's, with the key's uint32 words as the port's int64 key.
  * ``wire_from_jax``: the two arrays of a JAX ``FlatPacked`` (payload,
    params) -> the port's ``FlatPacked``, whose bytes, CRC and decode
    are the JAX package's.
  * ``quadratic_from_jax``: a JAX ``parallel.Quadratic`` -> the port's,
    on the same (a, b) arrays.
  * ``packed_from_jax``: a JAX per-leaf ``Packed`` (payload, params,
    shape, dtype, codec) -> the port's ``Packed``.
  * ``exchange_state_from_jax``: the stacked (vmapped) state of a JAX
    exchange or gossip operator — ECSGD residuals (flat buffers, or the
    per-leaf error trees of ``flat=False``), DCD/ECD replicas and
    residuals, ``DelayedExchange`` buffers and heads — -> the port's
    stacked state, so both packages can start from identical state.

A bf16 leaf (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
crosses bit for bit as its 16-bit pattern viewed as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compression, parallel, pytree
from repro_torch.kernels.quant.ops import DEFAULT_BUCKET_ELEMS
from repro_torch.train.steps import state_to


def _tensor(a) -> torch.Tensor:
    arr = np.array(a, copy=True)
    if arr.dtype == np.uint32:        # threefry key words (core.prng)
        arr = arr.astype(np.int64)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree):
    """Tree of numpy (or array-like) leaves -> tree of CPU tensors."""
    return pytree.tree_map(_tensor, tree)


def train_state_from_jax(state, device=None):
    """A JAX train state (numpy or jax leaves) -> the port's, with the
    parameters, moments and residual on ``device`` and ``step``/``rng``
    (and the optimizer's ``step``) on the host, as the port keeps them."""
    return state_to(pytree.tree_map(_tensor, state), device or "cpu")


def wire_from_jax(payload, params, *, tree, codec: str = "rq8",
                  bucket_elems: int = DEFAULT_BUCKET_ELEMS
                  ) -> compression.FlatPacked:
    """A JAX checkpoint's (payload, params) -> the port's FlatPacked.
    ``tree`` is the port parameter tree the message encodes (it gives
    the FlatLayout)."""
    return compression.FlatPacked(
        _tensor(np.asarray(payload, np.uint8)),
        _tensor(np.asarray(params, np.float32)),
        compression.FlatLayout.from_tree(tree), codec, bucket_elems)


def packed_from_jax(packed) -> compression.Packed:
    """A JAX ``Packed`` -> the port's: the same payload and params bytes,
    shape and codec, the dtype as the torch dtype of the same name."""
    return compression.Packed(
        _tensor(np.asarray(packed.payload, np.uint8)),
        _tensor(np.asarray(packed.params, np.float32)),
        tuple(packed.shape), getattr(torch, np.dtype(packed.dtype).name),
        packed.codec)


def quadratic_from_jax(prob, device=None) -> parallel.Quadratic:
    """A JAX ``Quadratic`` (a, b, worker_slices) -> the port's, with
    (a, b) on ``device`` (the CPU unless given)."""
    dev = device or "cpu"
    return parallel.Quadratic(_tensor(np.asarray(prob.a)).to(dev),
                              _tensor(np.asarray(prob.b)).to(dev),
                              int(prob.worker_slices))


def exchange_state_from_jax(state, device=None):
    """A JAX exchange state as ``vmap`` stacks it (leading worker dim on
    every leaf) -> the port's: float buffers on ``device`` (the CPU
    unless given), integer counters (``DelayedExchange``'s ``head``) on
    the host, where the port keeps them."""
    dev = device or "cpu"

    def place(a):
        t = _tensor(np.asarray(a))
        return t.to(dev) if t.is_floating_point() else t

    return pytree.tree_map(place, state)
