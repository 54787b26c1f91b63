"""Threefry-2x32 (20 rounds) and the uniform draw built on it, in plain
torch: the counter-based generator whose bits the codec's stochastic
rounding uses (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; the key schedule and rotations of JAX's ``threefry2x32``).

A key is two uint32 words. ``fold_in(key, d)`` hashes the counter
(0, d). A draw of n elements hashes counter i = (i >> 32, i & M32) for
element i and keeps ``y0 ^ y1``; a float32 uniform in [0, 1) takes the
top 23 of those bits as the mantissa of a float in [1, 2), minus 1.

Words are held in int64 tensors (or Python ints) with ``& M32`` after
every add and shift.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) & M32) | (v >> (32 - r))


def hash2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter (x0, x1) under the key (k0, k1)."""
    ks = (k0, k1, (k0 ^ k1 ^ PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key_of_seed(seed: int) -> tuple[int, int]:
    """The raw key of a 32-bit seed: (0, seed)."""
    return 0, int(seed) & M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return hash2x32(key[0], key[1], 0, int(data) & M32)


def uniform(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """(n,) float32 uniforms on [0, 1): element i from counter i."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = hash2x32(key[0], key[1], idx >> 32, idx & M32)
    bits = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0
