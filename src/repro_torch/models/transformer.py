"""Model assembly (unrolled ``layers`` list) and the blocks shared with
``transformer_scan``.

The port of ``repro.models.transformer`` for every decoder block kind of
the JAX package: block init, norm, dense or MoE FFN, token embedding,
(tied or untied) LM head, the full-sequence forward ``apply`` over the
unrolled tree (``{"embed", "final_norm", "lm_head"?, "layers": [block,
...]}`` — the JAX package's default training tree, whose flat layout the
trainer quantizes), ``sharded_cross_entropy``, ``loss_fn`` (cross
entropy plus the MoE router's aux loss) and ``count_params``.
``remat=True`` checkpoints each block (``torch.utils.checkpoint``);
``use_flash=True`` runs every ``attn`` / ``local_attn`` block on the
flash-attention kernel (forward only: the prefill). The mixers:

  attn        full-causal GQA          local_attn  sliding-window GQA
  mla         multi-head latent attention (``mla``)
  rwkv        RWKV6 time-mix with its own channel-mix FFN (``rwkv``; its
              scan on the kernel K7 for an input on the card)
  rglru       Griffin RG-LRU recurrent block (``rglru``)

and the FFN is a gated or plain MLP (SiLU or GELU), or the MoE layer
(``moe``) when ``cfg.moe`` is set, except deepseek's dense layer 0.
``block_apply`` returns (x, aux) as JAX's ``_block_apply`` does, and
``apply(..., with_aux=True)`` returns (logits, aux) as JAX's ``apply``;
without it the port's ``apply`` returns the logits alone. The cached
decode over the unrolled tree, ``init_decode_state`` / ``decode_step``
(``{"layers": [...]}``, with the int8 KV cache under ``quantize_kv``),
shares its per-block state and step (``_block_state``,
``_block_decode``) with ``transformer_scan``. Enc-dec stacks come with
a later slice.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import pytree
from repro_torch.models import attention, layers, mla, moe, rglru, rwkv
from repro_torch.models.common import ModelConfig

ATTN_KINDS = ("attn", "local_attn")
BLOCK_KINDS = ATTN_KINDS + ("mla", "rwkv", "rglru")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (later slices: M-RoPE "
        "and enc-dec stacks)")


def _moe_skipped(cfg: ModelConfig, layer_idx: int) -> bool:
    # DeepSeek-V2 keeps its first layer dense
    return cfg.arch_id.startswith("deepseek") and layer_idx == 0


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                layer_idx: int, *, lead: tuple = (), dtype=torch.float32
                ) -> dict:
    """One block's params; ``lead`` stacks n_rep copies."""
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind}")
    dev = gen.device
    kw = dict(lead=lead, dtype=dtype)
    if kind == "rwkv":
        ln = lambda: layers.norm_init(cfg.d_model, "layernorm",  # noqa: E731
                                      lead=lead, dtype=dtype, device=dev)
        return {"ln1": ln(),
                "mixer": rwkv.time_mix_init(gen, cfg, **kw),
                "ln2": ln(),
                "ffn": rwkv.channel_mix_init(gen, cfg, **kw)}
    if cfg.is_encdec:
        raise not_ported("cross attention")
    mixer_init = {"mla": mla.mla_init,
                  "rglru": rglru.rglru_block_init}.get(kind,
                                                       attention.attn_init)
    p: dict = {
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                dtype=dtype, device=dev),
        "mixer": mixer_init(gen, cfg, **kw),
    }
    if not cfg.parallel_block:
        p["ln2"] = layers.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                    dtype=dtype, device=dev)
    if cfg.moe is not None and not _moe_skipped(cfg, layer_idx):
        p["ffn"] = moe.moe_init(gen, cfg, **kw)
    else:
        p["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, glu=cfg.glu,
                                   **kw)
    return p


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return layers.apply_norm(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               layer_idx: int, *, moe_rows: bool = False) -> tuple:
    """(out, aux): the MoE layer's (``moe_rows``: each batch row its own
    groups), or the dense MLP's with aux 0.0."""
    if cfg.moe is not None and not _moe_skipped(cfg, layer_idx) \
            and "router" in p:
        return moe.moe_apply(p, cfg, x, act=cfg.act, rows=moe_rows)
    return layers.mlp(p, x, act=cfg.act, glu=cfg.glu), 0.0


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                 ) -> torch.Tensor:
    if "tokens" not in batch:
        raise not_ported("embedding frontends")
    x = params["embed"][batch["tokens"].long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=x.device).to(x.dtype)
    return x


def _lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor
             ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return layers.dense(params["lm_head"], x)


def init(cfg: ModelConfig, gen: torch.Generator, *, dtype=torch.float32
         ) -> dict:
    """Random parameters on ``gen``'s device, in JAX's unrolled tree."""
    params: dict = {
        "embed": layers.normal(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                               dtype=dtype),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dtype=dtype,
                                       device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                              dtype=dtype)
    params["layers"] = [_block_init(gen, cfg, kind, i, dtype=dtype)
                        for i, kind in enumerate(cfg.block_pattern)]
    return params


def _positions(cfg: ModelConfig, b: int, s: int, batch: dict,
               device=None) -> torch.Tensor:
    if "positions3" in batch or cfg.rope_variant == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (vlm slice)")
    return torch.arange(s, device=device)[None].expand(b, s)


def block_apply(p: dict, cfg: ModelConfig, kind: str, layer_idx: int,
                x: torch.Tensor, positions: torch.Tensor, *,
                use_flash: bool = False) -> tuple:
    """One pre-norm block over the full sequence -> (x, aux), aux the
    MoE FFN's router loss (0.0 for a dense FFN)."""
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)
    if kind == "rwkv":
        mix, _ = rwkv.time_mix(p["mixer"], cfg, _norm(cfg, p["ln1"], x))
        x = x + mix
        ffn_out, _ = rwkv.channel_mix(p["ffn"], cfg, _norm(cfg, p["ln2"], x))
        return x + ffn_out, 0.0
    h = _norm(cfg, p["ln1"], x)
    if kind == "mla":
        mixer_out = mla.mla_attention(p["mixer"], cfg, h, positions)
    elif kind == "rglru":
        mixer_out, _ = rglru.rglru_block(p["mixer"], cfg, h)
    else:
        window = cfg.local_window if kind == "local_attn" else 0
        mixer_out = attention.attention(p["mixer"], cfg, h, positions,
                                        causal=True, window=window,
                                        use_flash=use_flash)
    if cfg.parallel_block:
        ffn_out, aux = _ffn_apply(p["ffn"], cfg, h, layer_idx)
        return x + mixer_out + ffn_out, aux
    x = x + mixer_out
    h2 = _norm(cfg, p["ln2"], x)
    ffn_out, aux = _ffn_apply(p["ffn"], cfg, h2, layer_idx)
    return x + ffn_out, aux


def _block_apply(p: dict, cfg: ModelConfig, kind: str, layer_idx: int,
                 x: torch.Tensor, positions: torch.Tensor, *,
                 use_flash: bool = False) -> torch.Tensor:
    """``block_apply``'s x alone."""
    return block_apply(p, cfg, kind, layer_idx, x, positions,
                       use_flash=use_flash)[0]


def run_block(fn, remat: bool, *args, context_fn=None):
    """``fn(*args)``, checkpointed (its activations recomputed in the
    backward) when ``remat``; ``context_fn`` selects what a
    checkpoint keeps (``torch.utils.checkpoint``'s selective form)."""
    if not remat:
        return fn(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def apply(params: dict, cfg: ModelConfig, batch: dict, *,
          use_flash: bool = False, remat: bool = False,
          with_aux: bool = False):
    """Full-sequence forward over the unrolled tree -> logits (B, S, V),
    or (logits, aux) with ``with_aux`` (JAX's return: aux is the summed
    MoE router loss, 0.0 without MoE layers)."""
    if cfg.is_encdec:
        raise not_ported("the encoder-decoder stack")
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, batch, x.device)
    aux_total = 0.0
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.block_pattern)):
        def block(p_, x_, i=i, kind=kind):
            return block_apply(p_, cfg, kind, i, x_, positions,
                               use_flash=use_flash)

        x, aux = run_block(block, remat, p, x)
        aux_total = aux_total + aux
    x = _norm(cfg, params["final_norm"], x)
    logits = _lm_head(params, cfg, x)
    return (logits, aux_total) if with_aux else logits


def _block_state(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                 window: int, dtype, device, lead: tuple = (),
                 param_dtype=torch.float32, quantize_kv: bool = False
                 ) -> dict:
    """One block's decode state (``lead`` stacks n_rep copies): the KV
    cache of an attention block (int8 with ``quantize_kv``), an mla
    block's latent cache, an rwkv block's recurrent state, an rglru
    block's window and hidden state."""
    if kind == "rwkv":
        st = rwkv.init_state(cfg, batch, lead=lead, device=device)
        st["prev_x_ffn"] = torch.zeros_like(st["prev_x"])
        return st
    if kind == "rglru":
        return rglru.init_state(cfg, batch, dtype=dtype,
                                param_dtype=param_dtype, lead=lead,
                                device=device)
    if kind == "mla":
        return mla.init_cache(cfg, batch, seq_len, window=window,
                              dtype=dtype, device=device, lead=lead)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    w = cfg.local_window if kind == "local_attn" else window
    return attention.init_cache(cfg, batch, seq_len, window=w, dtype=dtype,
                                device=device, lead=lead,
                                quantize=quantize_kv)


def _block_decode(p: dict, cfg: ModelConfig, kind: str, layer_idx: int,
                  x: torch.Tensor, st: dict, moe_rows: bool = False
                  ) -> torch.Tensor:
    """One block's decode of x (B, 1, d); the block's new state is
    written into ``st``'s own tensors."""
    if kind == "rwkv":
        h = _norm(cfg, p["ln1"], x)
        mix, tm = rwkv.time_mix_decode(p["mixer"], cfg, h, st)
        x = x + mix
        h2 = _norm(cfg, p["ln2"], x)
        ffn_out, prev_ffn = rwkv.channel_mix_decode(p["ffn"], cfg, h2,
                                                    st["prev_x_ffn"])
        # into the state's own tensors (views of the stacked leaves)
        st["prev_x"].copy_(tm["prev_x"])
        st["wkv"].copy_(tm["wkv"])
        st["prev_x_ffn"].copy_(prev_ffn)
        return x + ffn_out
    h = _norm(cfg, p["ln1"], x)
    if kind == "mla":
        mix, _ = mla.decode_attention(p["mixer"], cfg, h, st)
    elif kind == "rglru":
        mix, new = rglru.rglru_block_decode(p["mixer"], cfg, h, st)
        st["conv"].copy_(new["conv"])
        st["h"].copy_(new["h"])
    else:
        mix, _ = attention.decode_attention(p["mixer"], cfg, h, st)
    if cfg.parallel_block:
        ffn_out, _ = _ffn_apply(p["ffn"], cfg, h, layer_idx,
                                moe_rows=moe_rows)
        return x + mix + ffn_out
    x = x + mix
    h2 = _norm(cfg, p["ln2"], x)
    ffn_out, _ = _ffn_apply(p["ffn"], cfg, h2, layer_idx, moe_rows=moe_rows)
    return x + ffn_out


def init_decode_state(params: dict, cfg: ModelConfig, batch: int,
                      seq_len: int, *, window: int = 0,
                      dtype=torch.bfloat16, device=None,
                      quantize_kv: bool = False) -> dict:
    """``{"layers": [state, ...]}``, one block state per layer of the
    unrolled tree (JAX's ``transformer.init_decode_state``): ``window``
    > 0 makes the attn blocks' caches ring buffers, local_attn always
    uses ``cfg.local_window``; ``quantize_kv`` stores K/V in int8 with
    fp32 scales."""
    if cfg.is_encdec:
        raise not_ported("the encoder-decoder decode")
    if device is None:
        device = params["embed"].device
    return {"layers": [
        _block_state(cfg, kind, batch, seq_len, window, dtype, device,
                     param_dtype=params["embed"].dtype,
                     quantize_kv=quantize_kv)
        for kind in cfg.block_pattern]}


def decode_step(params: dict, cfg: ModelConfig, inputs: dict,
                state: dict, *, moe_rows: bool = False) -> tuple:
    """One token through the unrolled stack. inputs: {"tokens": (B, 1)}.
    Returns (logits (B, 1, V), state) — ``state`` updated in place.
    ``moe_rows``: each row's token is its own MoE group, else the B
    tokens are one group (JAX's batch-B step)."""
    x = embed_inputs(params, cfg, inputs)
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.block_pattern)):
        x = _block_decode(p, cfg, kind, i, x, state["layers"][i], moe_rows)
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x), state


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          softcap: float = 0.0) -> torch.Tensor:
    """Mean token cross entropy over labels >= 0, as the JAX package's
    max / sum-exp formulation computes it (the max is detached, as JAX
    stops its gradient). The label logit is a gather: JAX's one-hot dot
    adds exact zeros to the same value."""
    logits = layers.softcap(logits.float(), softcap)
    m = logits.amax(-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
    labels = labels.long()
    label_logit = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - label_logit) * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            use_flash: bool = False, remat: bool = False) -> torch.Tensor:
    logits, aux = apply(params, cfg, batch, use_flash=use_flash,
                        remat=remat, with_aux=True)
    return sharded_cross_entropy(logits, batch["labels"],
                                 softcap=cfg.logit_softcap) + aux


def count_params(cfg: ModelConfig, *, active_only: bool = False) -> int:
    """Parameters of the unrolled tree, from its shapes (built under
    ``FakeTensorMode``, which allocates nothing, as JAX's count uses
    ``jax.eval_shape``); ``active_only`` leaves out the routed experts a
    token does not use (top-k of n_experts in each MoE layer)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = init(cfg, torch.Generator())
        total = sum(t.numel() for t in pytree.tree_leaves(tree))
    if not active_only or cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = sum(1 for i in range(cfg.n_layers)
                       if not _moe_skipped(cfg, i))
    return total - n_moe_layers * (m.n_experts - m.top_k) * per_expert

