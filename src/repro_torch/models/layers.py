"""Shared layer primitives (plain functions over parameter dicts).

The port of ``repro.models.layers``' dense / RMSNorm / LayerNorm / RoPE /
M-RoPE / SiLU- and GELU-MLP pieces. Parameters
are nested dicts of tensors with the JAX package's keys and shapes (a
dense weight is (d_in, d_out), applied as ``x @ w``), so a JAX parameter
tree converts leaf for leaf (``interop``). Random init draws from an
explicit ``torch.Generator``; it gives other numbers than ``jax.random``
from the same seed, by design — the tests carry JAX's parameters across
instead.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``. Init places every
    draw and buffer on ``gen.device``, so under this generator it makes
    shapes and dtypes only (``torch.randn(..., generator=g,
    device="meta")`` allocates nothing): the dry run's abstract trees."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _draw(gen: torch.Generator, shape: tuple, scale: float
          ) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x if scale == 1.0 else x.mul_(scale)


def normal(gen: torch.Generator, shape: tuple, *, scale: float = 1.0,
           dtype=torch.float32) -> torch.Tensor:
    """Normal draw times ``scale`` on the generator's device, in
    ``dtype``, with no full-size temporary: an fp32 draw is scaled in
    place (the same values as ``randn(...) * scale``); a narrower leaf
    with a stacking dim is drawn one slice of that dim at a time, in
    fp32, into the preallocated result (a (40, 8192, 22528) bf16 leaf
    would otherwise pass through 29.5 GB of fp32)."""
    if dtype == torch.float32 or len(shape) < 3:
        return _draw(gen, shape, scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = _draw(gen, shape[1:], scale)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               lead: tuple = (), dtype=torch.float32) -> dict:
    """``lead`` prepends stacking dims (the scanned layers' n_rep)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal(gen, lead + (d_in, d_out), scale=scale, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


NORMS = ("rmsnorm", "layernorm")


def _check_norm(kind: str) -> None:
    if kind not in NORMS:
        raise NotImplementedError(f"norm '{kind}' is not ported yet")


def norm_init(d: int, kind: str, *, lead: tuple = (), dtype=torch.float32,
              device=None) -> dict:
    """RMSNorm: {"scale"}; LayerNorm: {"scale", "bias"}."""
    _check_norm(kind)
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, *, kind: str, eps: float
               ) -> torch.Tensor:
    """In fp32, as JAX's: LayerNorm's variance is the mean of squared
    deviations from the mean (``jnp.var``'s two passes)."""
    _check_norm(kind)
    x32 = x.float()
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        return (x32 * p["scale"].float()).to(x.dtype)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    x32 = (x32 - mu) * torch.rsqrt(var + eps)
    return (x32 * p["scale"].float() + p["bias"].float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, cached per (head_dim, theta, device): every
    layer of every decode step asks for the same (D/2,) tensor."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def yarn_mscale(scale: float, m: float) -> float:
    """YaRN's attention temperature ``0.1 m ln(scale) + 1`` (1 for a
    scale of at most 1), as DeepSeek-V2's ``yarn_get_mscale``."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_range(head_dim: int, theta: float, scaling) -> tuple:
    """(low, high): the frequency slots where YaRN's ramp starts and
    ends, ``floor(c(beta_fast))`` and ``ceil(c(beta_slow))`` with
    ``c(r) = D ln(L / (2 pi r)) / (2 ln theta)``, L the original
    context, clamped to [0, D - 1]."""
    def c(rot):
        return (head_dim * math.log(scaling.original_max_position_embeddings
                                    / (rot * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(c(scaling.beta_fast)), 0),
            min(math.ceil(c(scaling.beta_slow)), head_dim - 1))


@functools.lru_cache(maxsize=16)
def yarn_freqs(head_dim: int, theta: float, scaling, device=None
               ) -> torch.Tensor:
    """YaRN's inverse frequencies (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``), cached per arguments: the
    extrapolated ``theta^(-2i/D)`` below ``low``, the interpolated
    ``1 / (factor theta^(2i/D))`` above ``high``, a linear ramp between."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    base = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)
    extra = 1.0 / base
    inter = 1.0 / (scaling.factor * base)
    low, high = yarn_range(head_dim, theta, scaling)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float, scaling=None) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).
    ``scaling``: a ``YaRNConfig``, whose frequencies replace the plain
    ones and whose ``yarn_mscale(factor, mscale) / yarn_mscale(factor,
    mscale_all_dim)`` multiplies cos and sin."""
    d = x.shape[-1]
    freqs = (rope_freqs(d, theta, x.device) if scaling is None
             else yarn_freqs(d, theta, scaling, x.device))   # (D/2,)
    ang = positions[..., None].float() * freqs              # (..., S, D/2)
    ang = ang[..., None, :]                                 # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None:
        mscale = (yarn_mscale(scaling.factor, scaling.mscale)
                  / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _mrope_section_ids(sections: tuple, half: int, device=None
                       ) -> torch.Tensor:
    """(D/2,) axis of each frequency slot: ``jnp.repeat(arange(3),
    sections, total_repeat_length=half)`` (a longer repeat is cut, a
    shorter one extended with its last value), cached per device."""
    ids = [axis for axis, n in enumerate(sections) for _ in range(n)]
    ids = (ids + ids[-1:] * half)[:half]
    return torch.tensor(ids, dtype=torch.long, device=device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, *, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE [arXiv:2409.12191]. x: (..., S, H, D);
    positions3: (..., 3, S), the temporal / height / width position ids.
    The D/2 frequency slots are split into ``sections``, each slot taking
    its angle from its section's axis; cos and sin in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ids = _mrope_section_ids(tuple(sections), d // 2, x.device)
    pos = positions3.movedim(-2, -1).float()                # (..., S, 3)
    ang = pos[..., ids] * freqs                             # (..., S, D/2)
    ang = ang[..., None, :]                                 # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """A text stream's M-RoPE ids: the three axes share the position,
    (..., S) -> (..., 3, S)."""
    return torch.stack([positions, positions, positions], dim=-2)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *, glu: bool,
             lead: tuple = (), dtype=torch.float32) -> dict:
    p = {"up": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
         "down": dense_init(gen, d_ff, d_model, lead=lead, dtype=dtype)}
    if glu:
        p["gate"] = dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": gelu}


def mlp(p: dict, x: torch.Tensor, *, act: str, glu: bool) -> torch.Tensor:
    a = ACTS[act]
    up = dense(p["up"], x)
    h = a(dense(p["gate"], x)) * up if glu else a(up)
    return dense(p["down"], h)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)
