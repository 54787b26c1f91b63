"""RWKV-6 "Finch" time-mix and channel-mix blocks (arXiv:2404.05892).

The port of ``repro.models.rwkv``. Attention-free: per-head matrix state
S in R^{K x V} with DATA-DEPENDENT decay w_t and a bonus u for the
current token:

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(wd(x_t)))

Prefill and training use the chunked parallel form ``wkv_chunked``
(intra-chunk (C, C) products + the inter-chunk state carry), the oracle
of the WKV6 kernel. ``time_mix`` runs the scan on K7 (through
``kernels.wkv6.ops.wkv6``, forward only) for a CUDA tensor when autograd
records nothing, and on ``wkv_chunked`` otherwise (``wkv_scan_for``).
Decode carries (S, token-shift tail) as the recurrent state and steps
it with ``wkv_recurrent_step`` (plain torch, as in JAX).

Init draws come from an explicit ``torch.Generator`` in JAX's order of
keys (r, k, v, g, o, wA, wB, u); ``lead`` prepends the scanned layers'
n_rep dim to every leaf.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig

CHUNK = 64


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def time_mix_init(gen: torch.Generator, cfg: ModelConfig, *,
                  lead: tuple = (), dtype=torch.float32) -> dict:
    d = cfg.d_model
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    lora = max(32, d // 16)
    dev = gen.device
    kw = dict(lead=lead, dtype=dtype)
    p = {"mu": torch.full(lead + (5, d), 0.5, dtype=dtype, device=dev)}
    for name in ("r", "k", "v", "g", "o"):
        p[name] = layers.dense_init(gen, d, d, **kw)
    # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
    p["w0"] = torch.full(lead + (d,), -6.0, dtype=dtype, device=dev)
    p["wA"] = layers.dense_init(gen, d, lora, **kw)
    p["wB"] = layers.normal(gen, lead + (lora, d), scale=0.01, dtype=dtype)
    p["u"] = layers.normal(gen, lead + (h, hd), scale=0.1, dtype=dtype)
    # a LayerNorm over all of d (JAX's comment calls it a per-head
    # groupnorm; time_mix applies a layernorm)
    p["ln_x"] = layers.norm_init(d, "layernorm", lead=lead, dtype=dtype,
                                 device=dev)
    return p


def channel_mix_init(gen: torch.Generator, cfg: ModelConfig, *,
                     lead: tuple = (), dtype=torch.float32) -> dict:
    d = cfg.d_model
    kw = dict(lead=lead, dtype=dtype)
    return {
        "mu": torch.full(lead + (2, d), 0.5, dtype=dtype, device=gen.device),
        "k": layers.dense_init(gen, d, cfg.d_ff, **kw),
        "v": layers.dense_init(gen, cfg.d_ff, d, **kw),
        "r": layers.dense_init(gen, d, d, **kw),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x: (B, S, d). prev: (B, d) last token of the previous segment (or
    None: zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    prev = prev.to(x.dtype)   # recurrent state may be carried in fp32
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(x, x_prev, mu):
    return x * mu + x_prev * (1.0 - mu)


def _rwkv_projections(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      x_prev: torch.Tensor) -> tuple:
    """r, k, v (B, S, H, K), g (B, S, d) and log_w (B, S, H, K) fp32 from
    the token-shifted inputs."""
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    xr, xw, xk, xv, xg = (_mix(x, x_prev, p["mu"][i]) for i in range(5))
    r = sharding.split_heads(layers.dense(p["r"], xr), h, hd)
    k = sharding.split_heads(layers.dense(p["k"], xk), h, hd)
    v = sharding.split_heads(layers.dense(p["v"], xv), h, hd)
    g = F.silu(layers.dense(p["g"], xg))
    # log decay in (-inf, 0): log w = -exp(w0 + lora(xw))
    lw = -torch.exp(p["w0"].float()
                    + torch.tanh(xw.float() @ p["wA"]["w"].float())
                    @ p["wB"].float())
    return r, k, v, g, sharding.split_heads(lw, h, hd)


def wkv_chunked(r, k, v, log_w, u, *, chunk: int = CHUNK,
                state0: Optional[torch.Tensor] = None) -> tuple:
    """Chunked-parallel WKV6 scan (the oracle of the kernel).

    r, k, v, log_w: (B, S, H, K) fp32; u: (H, K). Returns (out
    (B, S, H, K), state (B, H, K, K)). K == V (square state).
    """
    b, s, h, dk = r.shape
    pad = (-s) % chunk
    if pad:
        # padded steps are identity on the state: k = 0, log_w = 0
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, log_w))
    nc = (s + pad) // chunk
    rc, kc, vc, lwc = (t.reshape(b, nc, chunk, h, dk)
                       for t in (r, k, v, log_w))
    state = (torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=r.device) if state0 is None else state0)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    outs = []
    for c in range(nc):
        rc_, kc_, vc_, lwc_ = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]
        cum = torch.cumsum(lwc_, dim=1)              # inclusive cum log decay
        # inter-chunk: q_t attends to state with decay prod_{s<=t-1} w
        q_in = rc_ * torch.exp(cum - lwc_)           # (B, C, H, K)
        out_inter = torch.einsum("bchk,bhkv->bchv", q_in, state)
        # intra-chunk pairwise: t attends s<t with decay cum_{t-1}-cum_s
        kd = kc_ * torch.exp(-cum)
        att = torch.einsum("bthk,bshk->bhts", q_in, kd)   # (B, H, C, C)
        att = torch.where(causal, att, 0.0)
        out_intra = torch.einsum("bhts,bshv->bthv", att, vc_)
        # bonus (current token)
        bonus = torch.einsum("bchk,hk,bchk->bch", rc_, u, kc_)
        outs.append(out_inter + out_intra + bonus[..., None] * vc_)
        # state: S' = diag(prod w) S + sum_s (prod_{r>s} w * k_s) v_s^T
        total = cum[:, -1]                           # (B, H, K)
        k_carry = kc_ * torch.exp(total[:, None] - cum)
        state = (torch.exp(total)[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_carry, vc_))
    out = torch.stack(outs, dim=1).reshape(b, nc * chunk, h, dk)
    return out[:, :s], state


def wkv_recurrent_step(r, k, v, log_w, u, state) -> tuple:
    """Single-token recurrence (decode). r, k, v, log_w: (B, H, K);
    state (B, H, K, K)."""
    att = torch.einsum("bhk,bhkv->bhv", r, state)
    bonus = torch.einsum("bhk,hk,bhk->bh", r, u, k)[..., None] * v
    new_state = (torch.exp(log_w)[..., None] * state
                 + torch.einsum("bhk,bhv->bhkv", k, v))
    return att + bonus, new_state


def wkv_scan_for(*inputs):
    """The WKV6 scan to run on these inputs (``None`` entries ignored).

    K7 (``wkv_ops.wkv6``, forward-only) when they lie on the card and
    autograd records nothing: grad mode is off, or no input requires
    grad (prefill and serving). Otherwise the differentiable chunked
    scan, JAX's own model path, so that a train step on the card runs as
    on the CPU. Both compute one function (the chunked scan is K7's
    oracle)."""
    ts = [t for t in inputs if t is not None]
    records = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
    if ts[0].is_cuda and not records:
        return wkv_ops.wkv6
    return wkv_chunked


def _out(p: dict, x: torch.Tensor, out: torch.Tensor, g: torch.Tensor
         ) -> torch.Tensor:
    out = sharding.merge_heads(out).reshape(x.shape).to(x.dtype)
    out = layers.apply_norm(p["ln_x"], out, kind="layernorm", eps=1e-5)
    return layers.dense(p["o"], out * g)


def time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
             state: Optional[dict] = None) -> tuple:
    """Full-sequence time-mix. ``state``: optional {prev_x, wkv} for
    chunked streaming; returns (out, new_state)."""
    prev_x = None if state is None else state["prev_x"]
    s0 = None if state is None else state["wkv"]
    r, k, v, g, log_w = _rwkv_projections(p, cfg, x, _token_shift(x, prev_x))
    args = (r.float(), k.float(), v.float(), log_w, p["u"].float())
    out, new_s = wkv_scan_for(*args, s0)(*args, state0=s0)
    return _out(p, x, out, g), {"prev_x": x[:, -1].float(), "wkv": new_s}


def time_mix_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    state: dict) -> tuple:
    """One-token decode. x: (B, 1, d). Returns (out, new_state) as new
    tensors (the caller writes them into its state)."""
    x_prev = state["prev_x"][:, None].to(x.dtype)
    r, k, v, g, log_w = _rwkv_projections(p, cfg, x, x_prev)
    out, new_wkv = wkv_recurrent_step(
        r[:, 0].float(), k[:, 0].float(), v[:, 0].float(), log_w[:, 0],
        p["u"].float(), state["wkv"])
    return _out(p, x, out, g), {"prev_x": x[:, 0].float(), "wkv": new_wkv}


def init_state(cfg: ModelConfig, batch: int, *, lead: tuple = (),
               device=None) -> dict:
    """{prev_x (B, d), wkv (B, H, K, K)}, fp32 zeros (as JAX keeps
    them, whatever the cache dtype)."""
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    z = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32,  # noqa: E731
                                   device=device)
    return {"prev_x": z(batch, cfg.d_model), "wkv": z(batch, h, hd, hd)}


def channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                prev_x: Optional[torch.Tensor] = None) -> tuple:
    x_prev = _token_shift(x, prev_x)
    xk = _mix(x, x_prev, p["mu"][0])
    xr = _mix(x, x_prev, p["mu"][1])
    kk = torch.square(F.relu(layers.dense(p["k"], xk)))
    out = torch.sigmoid(layers.dense(p["r"], xr)) * layers.dense(p["v"], kk)
    return out, x[:, -1].float()


def channel_mix_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       prev_x: torch.Tensor) -> tuple:
    return channel_mix(p, cfg, x, prev_x=prev_x)
