"""Carry parameter trees and wire messages across from the JAX package.

Everything crosses as numpy arrays (``np.asarray`` of a jax array), so
this module needs neither jax nor ``repro``:

  * ``params_from_jax``: a ``transformer_scan`` parameter tree (nested
    dicts/lists of arrays) -> the port's tree of tensors, same keys and
    shapes; the port flattens it in the same (sorted-key) leaf order.
  * ``wire_from_jax``: the two arrays of a JAX ``FlatPacked`` (payload,
    params) -> the port's ``FlatPacked``, whose bytes, CRC and decode
    are the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compression, pytree
from repro_torch.kernels.quant.ops import DEFAULT_BUCKET_ELEMS


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree):
    """Tree of numpy (or array-like) leaves -> tree of CPU tensors."""
    return pytree.tree_map(_tensor, tree)


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
