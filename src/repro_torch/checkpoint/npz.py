"""Checkpointing: flattened-path ``.npz``, the JAX package's format.

The port of ``repro.checkpoint.npz``, file for file: leaves are keyed by
their slash-joined tree path (dict keys in sorted order, list indices),
each with a ``__crc__<key>`` companion holding the CRC32 of the stored
bytes; bf16 leaves are stored as a uint16 view under the ``__bf16__``
prefix. The integer leaves are stored as JAX stores them with 64-bit
off: ``step`` as int32, and the threefry key ``rng`` — an int64 tensor
of uint32 words in the port (``core.prng``) — as uint32[2]. So each
package loads the other's checkpoints.

Writes are atomic (a temporary file in the target directory, fsync,
``os.replace``). ``load_state`` rebuilds into a caller-provided template
(the leaves' dtypes and devices come from it), verifies every CRC on the
raw stored bytes before any view conversion and raises
``CheckpointCorruptionError`` naming the array on a mismatch, and a
``ValueError`` on a truncated or unreadable archive.

Under a process group (the launcher on several ranks, the state
replicated) ``save_state(..., group=g)`` has rank 0 of ``g`` write and
every rank wait at a barrier, so the file is whole when any rank goes
on; every rank then resumes from it.
"""
from __future__ import annotations

import os
import tempfile
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import pytree

PyTree = Any

_BF16_PREFIX = "__bf16__"
_CRC_PREFIX = "__crc__"


class CheckpointCorruptionError(ValueError):
    """A stored array's bytes disagree with its CRC32 companion entry."""


def _crc32(arr: np.ndarray) -> np.ndarray:
    """The array's CRC32 over its raw bytes, as a storable uint32."""
    return np.uint32(zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF)


def _with_paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's leaf order (``core.pytree``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            yield from _with_paths(c, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> tuple[np.ndarray, bool]:
    """-> (array as stored, is_bf16)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    arr = t.numpy()
    if arr.dtype == np.int64:
        # a threefry key: uint32 words (JAX with 64-bit off has no int64)
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
            raise ValueError("int64 leaf outside uint32: not a threefry key")
        arr = arr.astype(np.uint32)
    return arr, False


def save_state(state: PyTree, directory: str, *, step: int = 0,
               group=None) -> str:
    """Write ``state`` to ``directory/step-<step>.npz`` and return the
    file's name; with a process ``group``, only its rank 0 writes and
    every rank returns once the file is in place."""
    fname = os.path.join(directory, f"step-{step:08d}.npz")
    if group is None:
        return _write(state, directory, fname)
    import torch.distributed as dist
    try:
        if dist.get_rank(group) == 0:
            _write(state, directory, fname)
    finally:
        dist.barrier(group=group)
    return fname


def _write(state: PyTree, directory: str, fname: str) -> str:
    os.makedirs(directory, exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    for key, leaf in _with_paths(state):
        arr, bf16 = _to_numpy(leaf)
        if bf16:
            key = _BF16_PREFIX + key
        flat[key] = arr
        flat[_CRC_PREFIX + key] = _crc32(arr)
    # write-then-rename: the temp file lives in the target directory so
    # os.replace is an atomic same-filesystem rename
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-step-",
                               suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **flat)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return fname


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith("step-") and f.endswith(".npz"))
    return os.path.join(directory, files[-1]) if files else None


def _read(fname: str) -> dict[str, tuple[np.ndarray, bool]]:
    """key -> (stored array, is_bf16), every CRC verified."""
    by_key: dict[str, tuple[np.ndarray, bool]] = {}
    try:
        with np.load(fname) as data:
            crcs = {key[len(_CRC_PREFIX):]: int(data[key])
                    for key in data.files if key.startswith(_CRC_PREFIX)}
            for key in data.files:
                if key.startswith(_CRC_PREFIX):
                    continue
                arr = data[key]
                if key in crcs and int(_crc32(arr)) != crcs[key]:
                    raise CheckpointCorruptionError(
                        f"checksum mismatch in checkpoint {fname!r}: array "
                        f"{key!r} is corrupt (stored CRC32 {crcs[key]:#010x}"
                        f" != computed {int(_crc32(arr)):#010x})")
                bf16 = key.startswith(_BF16_PREFIX)
                by_key[key[len(_BF16_PREFIX):] if bf16 else key] = (arr,
                                                                    bf16)
    except (FileNotFoundError, CheckpointCorruptionError):
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        raise ValueError(
            f"corrupt or truncated checkpoint {fname!r}: {e} — writes "
            "are atomic, so this file was damaged after the fact; "
            "restore from the previous step") from e
    return by_key


def load_state(template: PyTree, fname: str) -> PyTree:
    """The checkpoint rebuilt into ``template``'s tree, each leaf with the
    template leaf's dtype and device."""
    by_key = _read(fname)
    leaves, treedef = pytree.tree_flatten(template)
    out = []
    for (key, _), leaf in zip(_with_paths(template), leaves):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, bf16 = by_key[key]
        like = torch.as_tensor(leaf)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"template {tuple(like.shape)}")
        if bf16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        elif arr.dtype == np.uint32:
            t = torch.from_numpy(arr.astype(np.int64))
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        out.append(t.to(dtype=like.dtype, device=like.device))
    return pytree.tree_unflatten(treedef, out)
