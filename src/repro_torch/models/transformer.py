"""Model assembly (unrolled ``layers`` list) and the blocks shared with
``transformer_scan``.

The port of ``repro.models.transformer`` for every block kind of the
JAX package: block init, norm, dense or MoE FFN, the token embedding or
the frontend stubs' embeddings (``embed_inputs``), text or 3-axis
M-RoPE positions (``_positions``), (tied or untied) LM head, the
full-sequence forward ``apply`` over the unrolled tree (``{"embed",
"final_norm", "lm_head"?, "layers": [block, ...]}`` — the JAX package's
default training tree, whose flat layout the trainer quantizes),
``sharded_cross_entropy``, ``loss_fn`` (cross
entropy plus the MoE router's aux loss) and ``count_params``.
``remat=True`` checkpoints each block (``torch.utils.checkpoint``);
``use_flash=True`` runs every ``attn`` / ``local_attn`` block on the
flash-attention kernel (K6, and K6b for its gradient; a training call
on the card that K6b covers takes them unasked: ``attention.flash_trains``),
and an ``mla`` block on the card on K6 at its head dims (``mla._flash``).
The mixers:

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
``_block_decode``) with ``transformer_scan``.

The encoder-decoder stack (``cfg.is_encdec``): a bidirectional encoder
(``encode``, attention blocks under ``params["encoder"]``) over the
frontend stub's ``src_embeddings``, and decoder blocks with a cross
attention step (``ln_cross``, ``cross``) over each layer's K/V of the
encoder memory (``attention.memory_kv``), computed once by ``apply``
and held in the decode state (``init_decode_state(memory=)``). The
encoder's attention is never the flash kernel, as in JAX.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.core import pytree
from repro_torch.dist import sharding
from repro_torch.models import attention, layers, mla, moe, rglru, rwkv
from repro_torch.models.common import ModelConfig

ATTN_KINDS = ("attn", "local_attn")
BLOCK_KINDS = ATTN_KINDS + ("mla", "rwkv", "rglru")


def _moe_skipped(cfg: ModelConfig, layer_idx: int) -> bool:
    # DeepSeek-V2 keeps its first layer dense
    return cfg.arch_id.startswith("deepseek") and layer_idx == 0


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                layer_idx: int, *, cross: bool = False, lead: tuple = (),
                dtype=torch.float32) -> dict:
    """One block's params; ``lead`` stacks n_rep copies, ``cross`` adds
    the enc-dec decoder's cross attention (``ln_cross``, ``cross``)."""
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
    mixer_init = {"mla": mla.mla_init,
                  "rglru": rglru.rglru_block_init}.get(kind,
                                                       attention.attn_init)
    p: dict = {
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                dtype=dtype, device=dev),
        "mixer": mixer_init(gen, cfg, **kw),
    }
    if cross:
        p["ln_cross"] = layers.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                         dtype=dtype, device=dev)
        p["cross"] = attention.attn_init(gen, cfg, **kw)
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
    """The token embedding when the model has a token frontend or the
    batch holds ``tokens`` (an enc-dec decoder generating text), else
    the stub frontend's ``embeddings`` (B, S, d) as given; times
    sqrt(d_model) under ``embed_scale``, stub embeddings too; on a mesh
    the result is pinned to the batch placement (``constrain_act``)."""
    if cfg.frontend == "token" or "tokens" in batch:
        x = sharding.take_rows(params["embed"], batch["tokens"].long())
    else:
        x = batch["embeddings"]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=x.device).to(x.dtype)
    # on a mesh: pin the batch placement, so the table's layout does not
    # carry into the activations (the identity on a plain tensor)
    return sharding.constrain_act(x)


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
    params["layers"] = [_block_init(gen, cfg, kind, i, cross=cfg.is_encdec,
                                    dtype=dtype)
                        for i, kind in enumerate(cfg.block_pattern)]
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": [_block_init(gen, cfg, "attn", i, dtype=dtype)
                       for i in range(cfg.n_encoder_layers)],
            "final_norm": layers.norm_init(cfg.d_model, cfg.norm,
                                           dtype=dtype, device=gen.device),
        }
    return params


def _positions(cfg: ModelConfig, b: int, s: int, batch: dict,
               device=None) -> torch.Tensor:
    """The batch's ``positions3`` (B, 3, S) when it has them; else 0..S-1
    per row, as (B, S), or as text M-RoPE ids (B, 3, S) for an mrope
    model."""
    if "positions3" in batch:
        return batch["positions3"]
    pos = torch.arange(s, device=device)[None].expand(b, s)
    if cfg.rope_variant == "mrope":
        return layers.text_mrope_positions(pos)
    return pos


def block_apply(p: dict, cfg: ModelConfig, kind: str, layer_idx: int,
                x: torch.Tensor, positions: torch.Tensor, *,
                memory_kv: tuple = None, use_flash: bool = False) -> tuple:
    """One pre-norm block over the full sequence -> (x, aux), aux the
    MoE FFN's router loss (0.0 for a dense FFN); with ``memory_kv`` an
    enc-dec decoder block, whose cross attention follows the mixer.
    Spans ``block.mixer`` (norm, mixer, residual) and ``block.ffn``
    (norm, FFN, residual), args ``layer``: ``layer_idx``."""
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)
    if kind == "rwkv":
        mix, _ = rwkv.time_mix(p["mixer"], cfg, _norm(cfg, p["ln1"], x))
        x = x + mix
        ffn_out, _ = rwkv.channel_mix(p["ffn"], cfg, _norm(cfg, p["ln2"], x))
        return x + ffn_out, 0.0
    with obs.span("block.mixer", args={"layer": layer_idx}):
        h = _norm(cfg, p["ln1"], x)
        if kind == "mla":
            mixer_out = mla.mla_attention(p["mixer"], cfg, h, positions,
                                          use_flash=use_flash)
        elif kind == "rglru":
            mixer_out, _ = rglru.rglru_block(p["mixer"], cfg, h)
        else:
            window = cfg.local_window if kind == "local_attn" else 0
            mixer_out = attention.attention(p["mixer"], cfg, h, positions,
                                            causal=True, window=window,
                                            use_flash=use_flash)
        if not cfg.parallel_block:
            # on a mesh: the row-parallel projection's partial sums are
            # reduced here, into the batch placement (the identity on a
            # plain tensor)
            x = sharding.constrain_act(x + mixer_out)
    if cfg.parallel_block:
        with obs.span("block.ffn", args={"layer": layer_idx}):
            ffn_out, aux = _ffn_apply(p["ffn"], cfg, h, layer_idx)
        return x + mixer_out + ffn_out, aux
    if memory_kv is not None:
        x = sharding.constrain_act(x + _cross(p, cfg, x, memory_kv))
    with obs.span("block.ffn", args={"layer": layer_idx}):
        h2 = _norm(cfg, p["ln2"], x)
        ffn_out, aux = _ffn_apply(p["ffn"], cfg, h2, layer_idx)
        return x + ffn_out, aux


def _cross(p: dict, cfg: ModelConfig, x: torch.Tensor, memory_kv: tuple
           ) -> torch.Tensor:
    """A decoder block's cross-attention step (pre-norm ``ln_cross``)."""
    return attention.cross_attention(p["cross"], cfg,
                                     _norm(cfg, p["ln_cross"], x), memory_kv)


def encode(params: dict, cfg: ModelConfig, src_embeddings: torch.Tensor
           ) -> torch.Tensor:
    """The bidirectional encoder over the frontend stub's embeddings
    (B, S, d) -> memory (B, S, d). Its attention is non-causal and plain
    (q-chunked at S >= 4096, a multiple of 1024; else the reference),
    never the flash kernel, as in JAX."""
    enc = params["encoder"]
    b, s, _ = src_embeddings.shape
    pos = torch.arange(s, device=src_embeddings.device)[None].expand(b, s)
    x = src_embeddings
    for i, p in enumerate(enc["layers"]):
        x = _encoder_block(p, cfg, i, x, pos)
    return _norm(cfg, enc["final_norm"], x)


def _encoder_block(p: dict, cfg: ModelConfig, layer_idx: int,
                   x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, p["ln1"], x)
    x = x + attention.attention(p["mixer"], cfg, h, pos, causal=False)
    ffn_out, _ = _ffn_apply(p["ffn"], cfg, _norm(cfg, p["ln2"], x),
                            layer_idx)
    return x + ffn_out


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
    MoE router loss, 0.0 without MoE layers). An enc-dec model encodes
    ``batch["src_embeddings"]`` first and gives each decoder layer its
    K/V of the memory."""
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, batch, x.device)
    memory_kvs = [None] * cfg.n_layers
    if cfg.is_encdec:
        memory = encode(params, cfg, batch["src_embeddings"])
        memory_kvs = [attention.memory_kv(p["cross"], cfg, memory)
                      for p in params["layers"]]
    aux_total = 0.0
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.block_pattern)):
        def block(p_, x_, mkv_, i=i, kind=kind):
            return block_apply(p_, cfg, kind, i, x_, positions,
                               memory_kv=mkv_, use_flash=use_flash)

        x, aux = run_block(block, remat, p, x, memory_kvs[i])
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
                  x: torch.Tensor, st: dict, moe_rows: bool = False,
                  memory_kv: tuple = None) -> torch.Tensor:
    """One block's decode of x (B, 1, d); the block's new state is
    written into ``st``'s own tensors. ``memory_kv``: an enc-dec decoder
    block's K/V of the encoder memory."""
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
    if memory_kv is not None:
        x = x + _cross(p, cfg, x, memory_kv)
    h2 = _norm(cfg, p["ln2"], x)
    ffn_out, _ = _ffn_apply(p["ffn"], cfg, h2, layer_idx, moe_rows=moe_rows)
    return x + ffn_out


def _need_memory(cfg: ModelConfig, memory) -> None:
    if cfg.is_encdec and memory is None:
        raise ValueError("enc-dec decode needs encoder memory")


def init_decode_state(params: dict, cfg: ModelConfig, batch: int,
                      seq_len: int, *, window: int = 0,
                      dtype=torch.bfloat16, device=None,
                      memory: torch.Tensor = None,
                      quantize_kv: bool = False) -> dict:
    """``{"layers": [state, ...]}``, one block state per layer of the
    unrolled tree (JAX's ``transformer.init_decode_state``): ``window``
    > 0 makes the attn blocks' caches ring buffers, local_attn always
    uses ``cfg.local_window``; ``quantize_kv`` stores K/V in int8 with
    fp32 scales. An enc-dec model needs the encoder's ``memory`` (B, S,
    d): each decoder layer's K/V of it go into ``"memory_kv"``, in the
    dtype they are computed in (never quantized)."""
    _need_memory(cfg, memory)
    if device is None:
        device = params["embed"].device
    out = {"layers": [
        _block_state(cfg, kind, batch, seq_len, window, dtype, device,
                     param_dtype=params["embed"].dtype,
                     quantize_kv=quantize_kv)
        for kind in cfg.block_pattern]}
    if cfg.is_encdec:
        out["memory_kv"] = [attention.memory_kv(p["cross"], cfg, memory)
                            for p in params["layers"]]
    return out


def decode_step(params: dict, cfg: ModelConfig, inputs: dict,
                state: dict, *, moe_rows: bool = False) -> tuple:
    """One token through the unrolled stack. inputs: {"tokens": (B, 1)}
    or {"embeddings": (B, 1, d)}. Returns (logits (B, 1, V), state) —
    ``state`` updated in place. ``moe_rows``: each row's token is its
    own MoE group, else the B tokens are one group (JAX's batch-B
    step)."""
    x = embed_inputs(params, cfg, inputs)
    mkv = state.get("memory_kv", [None] * cfg.n_layers)
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.block_pattern)):
        x = _block_decode(p, cfg, kind, i, x, state["layers"][i], moe_rows,
                          mkv[i])
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
    label_logit = sharding.take_label_logits(logits, labels.clamp_min(0))
    mask = (labels >= 0).float()
    return ((lse - label_logit) * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            use_flash: bool = False, remat: bool = False) -> torch.Tensor:
    logits, aux = apply(params, cfg, batch, use_flash=use_flash,
                        remat=remat, with_aux=True)
    return sharded_cross_entropy(logits, batch["labels"],
                                 softcap=cfg.logit_softcap) + aux


def count_params(cfg: ModelConfig, *, active_only: bool = False) -> int:
    """Parameters of the unrolled tree (drawn on ``meta``); with
    ``active_only`` less the routed experts a token does not use."""
    total = sum(leaf.numel() for leaf in
                pytree.tree_leaves(init(cfg, layers.MetaGenerator())))
    if not active_only or cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = sum(1 for i in range(cfg.n_layers)
                       if not _moe_skipped(cfg, i))
    return total - n_moe_layers * (m.n_experts - m.top_k) * per_expert
