"""Threefry-2x32 counter PRNG, bit-compatible with ``jax.random``.

The counterpart of JAX's default ``threefry2x32`` implementation with
the **partitionable** bit layout (``jax_threefry_partitionable=True``,
the default of current JAX): element i of a draw of any shape hashes
the 64-bit counter i, split into (hi, lo) 32-bit words, under the key,
and 32 random bits are ``hash_0 ^ hash_1``. ``fold_in`` and ``split``
use the same fold-like layout. The legacy (non-partitionable) layout is
not implemented: ``check_layout`` refuses it.

The codec's draws follow it (``bucket_key = fold_in(key, b)``, then
``uniform(k, (pack, R, 512))``), which is what lets the port's
published checkpoint bytes equal the JAX package's: on the CPU the
kernels' plain versions draw here; on the card K2, K4 and K5 hash the
same counters themselves (``csrc/threefry.cuh``), and only the keys'
derivations run here, on Python ints.

Arithmetic is int64 holding uint32 values with ``& 0xFFFFFFFF`` after
every add and shift, in plain torch on either device. The same round
function also runs on Python ints, which is how the (tiny) key
derivations run without touching a device.

A key is a length-2 int64 tensor of uint32 values on the CPU, the shape
and values of a raw ``jax.random.PRNGKey``.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def check_layout(partitionable: bool) -> None:
    """Refuse a reference that draws with the legacy bit layout."""
    if not partitionable:
        raise NotImplementedError(
            "repro_torch.core.prng implements only the partitionable "
            "threefry layout (jax_threefry_partitionable=True); the legacy "
            "layout gives different bits and is not ported")


def _rotl(v, r: int):
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds), on Python ints or int64
    tensors holding uint32 values. Returns (y0, y1)."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key_words(key) -> tuple[int, int]:
    """A key's two uint32 words as Python ints."""
    k = key.tolist() if isinstance(key, torch.Tensor) else list(key)
    if len(k) != 2:
        raise ValueError(f"a raw threefry key has 2 words, got {k}")
    return int(k[0]) & M32, int(k[1]) & M32


def _key(k0: int, k1: int) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 (mirrors jax.random)
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed]."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} outside 32 bits")
    return _key(0, seed & M32)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter (0, data) under key."""
    k0, k1 = key_words(key)
    return _key(*threefry2x32(k0, k1, 0, int(data) & M32))


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys; key i hashes counter i."""
    k0, k1 = key_words(key)
    out = [threefry2x32(k0, k1, i >> 32, i & M32) for i in range(num)]
    return torch.tensor(out, dtype=torch.int64).reshape(num, 2)


def _counters(n: int, device) -> tuple:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def random_bits(key, shape: Sequence[int], *,
                device: Union[str, torch.device, None] = None
                ) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    k0, k1 = key_words(key)
    hi, lo = _counters(n, device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(shape)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) floats from the top 23 bits, the JAX way: mantissa bits
    under exponent 0 (a float in [1, 2)), minus 1 — exact."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key, shape: Sequence[int], *,
            device: Union[str, torch.device, None] = None,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``. XLA
    contracts ``u * span + lo`` into one FMA, so the product and sum run
    in float64 (the product is exact there) and round once."""
    u = bits_to_unit(random_bits(key, shape, device=device))
    if minval == 0.0 and maxval == 1.0:
        return u
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    out = (u.double() * float(span) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values held in int64, without an
    int64 overflow: a is split into 16-bit halves."""
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & M32


def randint(key, shape: Sequence[int], minval: int, maxval: int, *,
            device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32
    (JAX's default with 64-bit off): two 32-bit draws under
    ``split(key)``, combined as ``(hi % span * (2**32 % span) + lo %
    span) % span`` in uint32 — JAX's ``_randint``, bit for bit.
    Returns int32."""
    lo_v, hi_v = int(minval), int(maxval)
    if not -(1 << 31) <= lo_v <= hi_v <= (1 << 31) - 1:
        raise ValueError(f"randint bounds [{lo_v}, {hi_v}) outside int32")
    span = hi_v - lo_v if hi_v > lo_v else 1
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device=device)
    lower = random_bits(k2, shape, device=device)
    mult = ((((1 << 16) % span) ** 2) & M32) % span    # uint32 wrap
    off = (_mulmod32(higher % span, mult) + lower % span) & M32
    return (off % span + lo_v).to(torch.int32)


def bernoulli(key, p: float, shape: Sequence[int], *,
              device: Union[str, torch.device, None] = None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a float32
    uniform draw below float32(p). Returns bool."""
    return uniform(key, shape, device=device) < float(np.float32(p))


# XLA's float32 inverse error function (Giles' polynomials in
# w = -log1p(-x^2), split at w = 5)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """erfinv of a float32 tensor in |x| < 1, as XLA computes it: the
    same polynomial, each Horner step one rounding (XLA contracts it
    into an FMA; here a float64 multiply-add, exact before the round)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(lt, float(np.float32(a)), float(np.float32(b)))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = (p.double() * w + c.double()).float()
    return p * x


def normal(key, shape: Sequence[int], *,
           device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` for float32: ``sqrt(2) *
    erfinv(u)`` with u uniform on [nextafter(-1, 0), 1). The uniforms
    are JAX's bits and the polynomial XLA's, but ``log1p`` is PyTorch's:
    about 1 % of the draws differ from JAX's by an ulp or two, so the
    draw is allclose to JAX's, not bit-equal."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device=device, minval=lo, maxval=1.0)
    return _erfinv32(u) * float(np.float32(np.sqrt(2)))


def gumbel(key, shape: Sequence[int], *,
           device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): -log(-log(u)), u on
    [tiny, 1). Each log runs in float64 and rounds once to float32, as
    each of JAX's float32 logs rounds once; XLA's log may still differ
    in the last bit, which moves a categorical draw only if two classes
    tie to within that bit."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, shape, device=device, minval=tiny, maxval=1.0)
    inner = (-torch.log(u.double())).float()
    return (-torch.log(inner.double())).float()


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical``: argmax(gumbel + logits) along axis."""
    g = gumbel(key, logits.shape, device=logits.device)
    return torch.argmax(g + logits.float(), dim=axis)
