"""Scan-over-layers model assembly: init, the full-sequence forward and
loss (training with ``--scan-layers``), and the cached decode step.

The port of ``repro.models.transformer_scan`` for every decoder block
kind (attn, local_attn, mla, rwkv, rglru; dense or MoE FFN). It keeps
the JAX package's parameter tree exactly — ``embed``, ``final_norm``,
``lm_head`` (untied only), ``prefix_layers`` (deepseek's dense layer
0), ``scan_blocks`` (one block per position of the repeating unit, every
leaf with a leading ``n_rep`` dim) and ``suffix_layers`` (e.g.
recurrentgemma's trailing two), and an enc-dec model's ``encoder``
(``scan_blocks``: ONE attention block stacked over the encoder layers,
and ``final_norm``) — so the flat wire layout of a
checkpoint, and a JAX parameter tree carried across
(``interop.params_from_jax``), line up leaf for leaf. The ``lax.scan``
over layers becomes a loop over the layer index of the stacked leaves;
``remat`` checkpoints each repetition of the unit, keeping nothing
(``remat_policy="full"``) or the dense projections' matmul outputs
(``"dots"``, JAX's ``dots_with_no_batch_dims_saveable``) through torch's
selective activation checkpointing. The MoE router's aux loss is summed
over the layers as JAX's scan carries it.

The decode state mirrors JAX's ``{prefix, scan, suffix}`` with the batch
axis written out: an attention block's KV cache and an mla block's
latent cache with a per-row cursor (see ``attention``, ``mla``), an
rwkv block's fp32 ``prev_x``, ``wkv`` (B, H, K, K) and ``prev_x_ffn``,
an rglru block's ``conv`` window and fp32 ``h``. ``decode_step`` updates
it in place — a block writes its new state into the views ``_at`` hands
it — and returns it. Its MoE layers group the B tokens of a step
together, as JAX's batch-B step does, or each row alone with
``moe_rows=True``, as the JAX engine's vmapped batch-1 step does. An
enc-dec model's decode state also holds each decoder layer's K/V of the
encoder memory (``memory_kv_prefix`` / ``memory_kv_scan``, stacked over
n_rep / ``memory_kv_suffix``), computed layer by layer as the unrolled
form computes them, so the two forms decode bit for bit alike.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch.dist import sharding
from repro_torch.models import attention, layers
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (_block_decode, _block_init,
                                            _block_state, _encoder_block,
                                            _lm_head, _moe_skipped,
                                            _need_memory, _norm, _positions,
                                            block_apply, embed_inputs,
                                            run_block,
                                            sharded_cross_entropy)


def pattern_segments(cfg: ModelConfig):
    """-> (prefix_kinds, unit_kinds, n_rep, suffix_kinds)."""
    pattern = tuple(cfg.block_pattern)
    start = 1 if (cfg.moe is not None and _moe_skipped(cfg, 0)) else 0
    rest = pattern[start:]
    unit, n_rep = rest[:1] or ("attn",), 0
    for u in (1, 2, 3, 4, 6):
        if not rest or len(rest) < u:
            break
        reps = len(rest) // u
        if reps >= 1 and all(rest[i] == rest[i % u] for i in range(reps * u)):
            unit, n_rep = rest[:u], reps
            break
    suffix = rest[n_rep * len(unit):]
    return pattern[:start], unit, n_rep, suffix


def generator(seed: int, device=None) -> torch.Generator:
    """The explicit parameter-init generator for ``init``."""
    return torch.Generator(device=torch.device(device or "cpu")
                           ).manual_seed(int(seed))


def init(cfg: ModelConfig, gen: torch.Generator, *, dtype=torch.float32
         ) -> dict:
    """Random parameters on ``gen``'s device, in JAX's tree shape."""
    prefix, unit, n_rep, suffix = pattern_segments(cfg)
    dev = gen.device
    params: dict = {
        "embed": layers.normal(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                               dtype=dtype),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dtype=dtype,
                                       device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                              dtype=dtype)
    kw = dict(cross=cfg.is_encdec, dtype=dtype)
    params["prefix_layers"] = [_block_init(gen, cfg, kind, i, **kw)
                               for i, kind in enumerate(prefix)]
    params["scan_blocks"] = [
        _block_init(gen, cfg, kind, len(prefix) + j, lead=(n_rep,), **kw)
        for j, kind in enumerate(unit)] if n_rep else []
    off = len(prefix) + n_rep * len(unit)
    params["suffix_layers"] = [_block_init(gen, cfg, kind, off + i, **kw)
                               for i, kind in enumerate(suffix)]
    if cfg.is_encdec:
        params["encoder"] = {
            "scan_blocks": _block_init(gen, cfg, "attn", 1,
                                       lead=(cfg.n_encoder_layers,),
                                       dtype=dtype),
            "final_norm": layers.norm_init(cfg.d_model, cfg.norm,
                                           dtype=dtype, device=dev),
        }
    return params


def encode(params: dict, cfg: ModelConfig, src_embeddings: torch.Tensor,
           *, remat: bool = False) -> torch.Tensor:
    """The bidirectional encoder over the stacked encoder block (B, S, d)
    -> memory (B, S, d); ``remat`` checkpoints each layer. Non-causal,
    never the flash kernel; every layer's FFN is called as layer 1, as
    JAX's scan calls it."""
    enc = params["encoder"]
    b, s, _ = src_embeddings.shape
    pos = torch.arange(s, device=src_embeddings.device)[None].expand(b, s)

    def body(p_, x_):
        return _encoder_block(p_, cfg, 1, x_, pos)

    x = src_embeddings
    for r in range(cfg.n_encoder_layers):
        x = run_block(body, remat, _at(enc["scan_blocks"], r), x)
    return _norm(cfg, enc["final_norm"], x)


def _memory_kvs(params: dict, cfg: ModelConfig, memory: torch.Tensor
                ) -> tuple:
    """Each decoder layer's K/V of the encoder memory, computed layer by
    layer (JAX's ``vmap`` over the stacked layers, written out): lists
    of (k, v) for the prefix and suffix layers, and per unit position a
    (k, v) stacked over n_rep."""
    n_rep = pattern_segments(cfg)[2]
    mk = lambda p: attention.memory_kv(p["cross"], cfg, memory)  # noqa: E731
    scan = []
    for sp in params["scan_blocks"]:
        per = [mk(_at(sp, r)) for r in range(n_rep)]
        scan.append(tuple(torch.stack(t) for t in zip(*per)))
    return ([mk(p) for p in params["prefix_layers"]], scan,
            [mk(p) for p in params["suffix_layers"]])


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of matmuls without batch dims (the dense projections, which
    reach aten as ``mm`` / ``addmm``), recompute everything else —
    attention's batched matmuls included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat_policy: str):
    if remat_policy == "full":
        return None
    if remat_policy != "dots":
        raise ValueError(f"unknown remat_policy '{remat_policy}'")
    return partial(create_selective_checkpoint_contexts, _save_dots)


def apply(params: dict, cfg: ModelConfig, batch: dict, *,
          use_flash: bool = False, remat: bool = False,
          logits_positions: str = "all", remat_policy: str = "full",
          with_aux: bool = False):
    """Full-sequence forward over the stacked tree -> logits (B, S, V),
    or (B, 1, V) with ``logits_positions="last"``: only the final
    position goes through the final norm and the LM head (the serving
    prefill's path: a 32k-token prefill otherwise computes a
    (B, 32768, V) logits tensor to keep one row). ``with_aux`` returns
    (logits, aux) as JAX's function does, aux the summed MoE router
    loss (0.0 without MoE layers). An enc-dec model encodes
    ``batch["src_embeddings"]`` first (``remat`` applies to the encoder
    too) and gives each decoder layer its K/V of the memory."""
    if logits_positions not in ("all", "last"):
        raise ValueError(f"logits_positions must be 'all' or 'last', got "
                         f"'{logits_positions}'")
    prefix, unit, n_rep, suffix = pattern_segments(cfg)
    context_fn = _remat_context(remat_policy) if remat else None
    params = _unshard_top(params)
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, batch, x.device)
    mkv_prefix = [None] * len(prefix)
    mkv_scan = [None] * len(unit)
    mkv_suffix = [None] * len(suffix)
    if cfg.is_encdec:
        memory = encode(params, cfg, batch["src_embeddings"], remat=remat)
        mkv_prefix, mkv_scan, mkv_suffix = _memory_kvs(params, cfg, memory)
    aux_total = 0.0
    for i, (p, kind) in enumerate(zip(params["prefix_layers"], prefix)):
        x, aux = block_apply(p, cfg, kind, i, x, positions,
                             memory_kv=mkv_prefix[i], use_flash=use_flash)
        x = sharding.constrain_act(x)
        aux_total = aux_total + aux

    def body(x_, ps, mkvs):
        aux_ = 0.0
        for j, (p_j, mkv_j, kind) in enumerate(zip(ps, mkvs, unit)):
            x_, a = block_apply(p_j, cfg, kind, len(prefix) + j, x_,
                                positions, memory_kv=mkv_j,
                                use_flash=use_flash)
            x_ = sharding.constrain_act(x_)
            aux_ = aux_ + a
        return x_, aux_

    for r in range(n_rep):
        x, aux = run_block(body, remat, x,
                           [_at(sp, r) for sp in params["scan_blocks"]],
                           [_kv_at(m, r) for m in mkv_scan],
                           context_fn=context_fn)
        aux_total = aux_total + aux
    off = len(prefix) + n_rep * len(unit)
    for i, (p, kind) in enumerate(zip(params["suffix_layers"], suffix)):
        x, aux = block_apply(p, cfg, kind, off + i, x, positions,
                             memory_kv=mkv_suffix[i], use_flash=use_flash)
        x = sharding.constrain_act(x)
        aux_total = aux_total + aux
    if logits_positions == "last":
        x = x[:, -1:]
    x = _norm(cfg, params["final_norm"], x)
    logits = _lm_head(params, cfg, x)
    return (logits, aux_total) if with_aux else logits


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            use_flash: bool = False, remat: bool = False,
            remat_policy: str = "full") -> torch.Tensor:
    logits, aux = apply(params, cfg, batch, use_flash=use_flash, remat=remat,
                        remat_policy=remat_policy, with_aux=True)
    return sharded_cross_entropy(logits, batch["labels"],
                                 softcap=cfg.logit_softcap) + aux


def init_decode_state(params: dict, cfg: ModelConfig, batch: int,
                      seq_len: int, *, window: int = 0,
                      dtype=torch.bfloat16, device=None,
                      memory: torch.Tensor = None,
                      quantize_kv: bool = False) -> dict:
    """The stacked decode state; ``quantize_kv`` stores the attention
    blocks' K/V in int8 with fp32 scales (``attention.init_cache``). An
    enc-dec model needs the encoder's ``memory`` (B, S, d), whose
    per-layer K/V go into ``memory_kv_{prefix,scan,suffix}``."""
    _need_memory(cfg, memory)
    prefix, unit, n_rep, suffix = pattern_segments(cfg)
    if device is None:
        device = params["embed"].device
    mk = lambda k, lead=(): _block_state(  # noqa: E731
        cfg, k, batch, seq_len, window, dtype, device, lead,
        params["embed"].dtype, quantize_kv)
    state = {
        "prefix": [mk(k) for k in prefix],
        "scan": [mk(k, (n_rep,)) for k in unit] if n_rep else [],
        "suffix": [mk(k) for k in suffix],
    }
    if cfg.is_encdec:
        (state["memory_kv_prefix"], state["memory_kv_scan"],
         state["memory_kv_suffix"]) = _memory_kvs(params, cfg, memory)
    return state


def _at(tree, i: int, *, state: bool = False):
    """Layer i of a stacked dict subtree (views; non-tensor leaves
    kept). Walks dicts only — the shape of a block's params and cache.
    On a mesh a layer's parameters are gathered over the data axes here,
    a layer at a time (``sharding.unshard``); a ``state`` leaf keeps its
    shards (``sharding.take_layer``, a copy where the layer dim is
    sharded, which ``_put_at`` writes back)."""
    if isinstance(tree, dict):
        return {k: _at(v, i, state=state) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return sharding.take_layer(tree, i) if state else \
        sharding.unshard(tree[i])


def _put_at(tree, i: int, layer) -> None:
    """Layer i of a stacked state subtree set to ``layer``, the subtree
    ``_at(tree, i, state=True)`` gave and the block updated: a no-op
    where those were views, the write-back of a layer-sharded leaf on a
    mesh (``sharding.put_layer``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put_at(v, i, layer[k])
    elif isinstance(tree, torch.Tensor):
        sharding.put_layer(tree, i, layer)


def _unshard_top(params: dict) -> dict:
    """On a mesh, the unstacked parameters gathered over the data axes
    (the stacked layers are gathered a layer at a time by ``_at``); the
    tree itself off a mesh."""
    if not sharding.is_dtensor(params["embed"]):
        return params
    return {k: v if k in ("scan_blocks", "encoder")
            else sharding.unshard_tree(v) for k, v in params.items()}


def _kv_at(mkv, i: int):
    """Layer i's (k, v) of a stacked memory K/V, or None without one."""
    return None if mkv is None else (mkv[0][i], mkv[1][i])


def decode_step(params: dict, cfg: ModelConfig, inputs: dict,
                state: dict, *, moe_rows: bool = False) -> tuple:
    """One token for the whole stack. inputs: {"tokens": (B, 1)} or
    {"embeddings": (B, 1, d)}. Returns (logits (B, 1, V), state) —
    ``state`` updated in place. ``moe_rows``: each row's token is its
    own MoE group (the serve engine's slots), else the B tokens are one
    group (JAX's batch-B step)."""
    prefix, unit, n_rep, suffix = pattern_segments(cfg)
    params = _unshard_top(params)
    x = embed_inputs(params, cfg, inputs)
    mkv_prefix = state.get("memory_kv_prefix", [None] * len(prefix))
    mkv_scan = state.get("memory_kv_scan", [None] * len(unit))
    mkv_suffix = state.get("memory_kv_suffix", [None] * len(suffix))
    for i, (p, kind) in enumerate(zip(params["prefix_layers"], prefix)):
        x = _block_decode(p, cfg, kind, i, x, state["prefix"][i], moe_rows,
                          mkv_prefix[i])
    for r in range(n_rep):
        for j, kind in enumerate(unit):
            st = _at(state["scan"][j], r, state=True)
            x = _block_decode(_at(params["scan_blocks"][j], r), cfg, kind,
                              len(prefix) + j, x, st, moe_rows,
                              _kv_at(mkv_scan[j], r))
            _put_at(state["scan"][j], r, st)
            del st      # a copy on a mesh: freed before the next is taken
            x = sharding.constrain_act(x)
    off = len(prefix) + n_rep * len(unit)
    for i, (p, kind) in enumerate(zip(params["suffix_layers"], suffix)):
        x = _block_decode(p, cfg, kind, off + i, x, state["suffix"][i],
                          moe_rows, mkv_suffix[i])
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x), state
