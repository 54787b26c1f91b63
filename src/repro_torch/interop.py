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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compression, pytree
from repro_torch.kernels.quant.ops import DEFAULT_BUCKET_ELEMS
from repro_torch.train.steps import state_to


def _tensor(a) -> torch.Tensor:
    arr = np.array(a, copy=True)
    if arr.dtype == np.uint32:        # threefry key words (core.prng)
        arr = arr.astype(np.int64)
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
