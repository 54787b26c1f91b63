"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro.models.rglru``. Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t)            recurrence gate
    i_t = sigmoid(W_x x_t)            input gate
    log a_t = -c * softplus(Lambda) * r_t        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is elementwise, so prefill and training run it as a
log-depth doubling scan over the sequence (``rglru_scan``: ceil(log2 S)
elementwise passes, the work JAX's ``lax.associative_scan`` does); the
decays are multiplied, never divided, so a decay near e^-13.6 that
underflows a running product cannot turn into 0/0. Decode carries a
(B, width) state. Block layout (Griffin "recurrent block"): a GELU gate
branch and conv1d(width 4) -> RG-LRU, multiplied, then projected out.
The JAX package has no Pallas kernel here: this plain torch is the
port's, as the ``jnp`` form is JAX's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.common import ModelConfig

RG_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglu_width or cfg.d_model


def rglru_block_init(gen: torch.Generator, cfg: ModelConfig, *,
                     lead: tuple = (), dtype=torch.float32) -> dict:
    d, w = cfg.d_model, _width(cfg)
    kw = dict(lead=lead, dtype=dtype)
    dev = gen.device
    return {
        "in_gate": layers.dense_init(gen, d, w, **kw),
        "in_rec": layers.dense_init(gen, d, w, **kw),
        "conv_w": layers.normal(gen, lead + (cfg.conv_width, w), scale=0.1,
                                dtype=dtype),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "gate_a": layers.dense_init(gen, w, w, **kw),
        "gate_x": layers.dense_init(gen, w, w, **kw),
        # softplus(lam) spread so that a^c lies in [0.9, 0.999]
        "lam": torch.linspace(0.3, 1.5, w, device=dev).to(dtype)
        .expand(lead + (w,)).clone(),
        "out": layers.dense_init(gen, w, d, **kw),
    }


def _causal_conv(p: dict, x: torch.Tensor, *,
                 state: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv1d. x: (B, S, W); state: (B, conv_width-1,
    W). The window is concatenated in the promoted dtype of the two, as
    ``jnp.concatenate`` promotes it."""
    cw = p["conv_w"].shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xx = torch.cat([state.to(dt), x.to(dt)], dim=1)
    s = x.shape[1]
    out = sum(xx[:, i:i + s] * p["conv_w"][i] for i in range(cw))
    return out + p["conv_b"], xx[:, -(cw - 1):]


def _rglru_coeffs(p: dict, x: torch.Tensor) -> tuple:
    r = torch.sigmoid(layers.dense(p["gate_a"], x).float())
    i = torch.sigmoid(layers.dense(p["gate_x"], x).float())
    log_a = -RG_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_x = i * x.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t for every t. a, b: (B, S, W); h0: (B, W).

    Hillis-Steele doubling: after the pass of offset o, (a_t, b_t) is
    the composition of the steps t-2o+1 .. t, so ceil(log2 S) passes
    leave b_t = h_t. Out of place, so autograd runs through it."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s, off = a.shape[1], 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_block(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[dict] = None) -> tuple:
    """Full-sequence recurrent block. Returns (out, new_state)."""
    gate = layers.gelu(layers.dense(p["in_gate"], x))
    rec_in = layers.dense(p["in_rec"], x)
    conv_state = None if state is None else state["conv"]
    h0 = None if state is None else state["h"]
    rec_in, new_conv = _causal_conv(p, rec_in, state=conv_state)
    a, b = _rglru_coeffs(p, rec_in)
    h = rglru_scan(a, b, h0=h0)
    out = layers.dense(p["out"], h.to(x.dtype) * gate)
    return out, {"conv": new_conv, "h": h[:, -1]}


def rglru_block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       state: dict) -> tuple:
    """One-token step. x: (B, 1, d). Returns (out, new_state) as new
    tensors (the caller writes them into its state)."""
    gate = layers.gelu(layers.dense(p["in_gate"], x))
    rec_in = layers.dense(p["in_rec"], x)
    rec_in, new_conv = _causal_conv(p, rec_in, state=state["conv"])
    a, b = _rglru_coeffs(p, rec_in)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = layers.dense(p["out"], h[:, None].to(x.dtype) * gate)
    return out, {"conv": new_conv, "h": h}


def init_state(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16,
               param_dtype=torch.float32, lead: tuple = (),
               device=None) -> dict:
    """{conv (B, conv_width-1, W), h (B, W) fp32}, zeros.

    JAX makes ``conv`` in the cache dtype, but its first decode step
    returns it in the dtype the window was concatenated in, the promotion
    of that dtype and the activations' (fp32 for fp32 weights). The port
    writes the state in place, so ``conv`` is allocated in that promoted
    dtype from the start: the step-0 zeros are exact in either, and a
    bf16 leaf would round every later step where JAX does not."""
    w = _width(cfg)
    return {"conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                                dtype=torch.promote_types(dtype, param_dtype),
                                device=device),
            "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device)}
