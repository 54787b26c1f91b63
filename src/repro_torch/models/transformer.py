"""Model assembly (unrolled ``layers`` list) and the blocks shared with
``transformer_scan``.

The port of ``repro.models.transformer`` for attention and RWKV6
stacks: block init, norm, dense FFN, token embedding, (tied or untied)
LM head, the full-sequence forward ``apply`` over the unrolled tree
(``{"embed", "final_norm", "lm_head"?, "layers": [block, ...]}`` — the
JAX package's default training tree, whose flat layout the trainer
quantizes), ``sharded_cross_entropy`` and ``loss_fn``. ``remat=True``
checkpoints each block (``torch.utils.checkpoint``); ``use_flash=True``
runs every attention block on the flash-attention kernel (forward only:
the unrolled prefill). An ``rwkv`` block (layernorm, time-mix, its own
channel-mix FFN) runs its WKV6 scan on the kernel K7 when its input is
on the card and on the plain chunked scan on the CPU (``rwkv``). MoE
FFNs, the MLA / RG-LRU mixers, enc-dec stacks and the unrolled
``decode_step`` come with later slices (serving runs the scanned
layout).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers, rwkv
from repro_torch.models.common import ModelConfig

ATTN_KINDS = ("attn", "local_attn")
BLOCK_KINDS = ATTN_KINDS + ("rwkv",)


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (models slice: MoE, MLA, "
        "RG-LRU and enc-dec stacks)")


def _moe_skipped(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.arch_id.startswith("deepseek") and layer_idx == 0


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                layer_idx: int, *, lead: tuple = (), dtype=torch.float32
                ) -> dict:
    """One block's params; ``lead`` stacks n_rep copies."""
    if kind not in BLOCK_KINDS:
        raise not_ported(f"block kind '{kind}'")
    dev = gen.device
    if kind == "rwkv":
        ln = lambda: layers.norm_init(cfg.d_model, "layernorm",  # noqa: E731
                                      lead=lead, dtype=dtype, device=dev)
        return {"ln1": ln(),
                "mixer": rwkv.time_mix_init(gen, cfg, lead=lead, dtype=dtype),
                "ln2": ln(),
                "ffn": rwkv.channel_mix_init(gen, cfg, lead=lead,
                                             dtype=dtype)}
    if cfg.moe is not None and not _moe_skipped(cfg, layer_idx):
        raise not_ported("the MoE FFN")
    if cfg.is_encdec:
        raise not_ported("cross attention")
    p: dict = {
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                dtype=dtype, device=dev),
        "mixer": attention.attn_init(gen, cfg, lead=lead, dtype=dtype),
    }
    if not cfg.parallel_block:
        p["ln2"] = layers.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                    dtype=dtype, device=dev)
    p["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, glu=cfg.glu,
                               lead=lead, dtype=dtype)
    return p


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return layers.apply_norm(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               layer_idx: int) -> torch.Tensor:
    if "router" in p:
        raise not_ported("the MoE FFN")
    return layers.mlp(p, x, act=cfg.act, glu=cfg.glu)


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
        "embed": (layers.normal(gen, (cfg.vocab, cfg.d_model)) * 0.02
                  ).to(dtype),
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


def _block_apply(p: dict, cfg: ModelConfig, kind: str, layer_idx: int,
                 x: torch.Tensor, positions: torch.Tensor, *,
                 use_flash: bool = False) -> torch.Tensor:
    """One pre-norm block over the full sequence (the JAX function's
    ``aux`` is 0.0 for every ported block kind, so only x is returned)."""
    if kind not in BLOCK_KINDS:
        raise not_ported(f"block kind '{kind}'")
    if kind == "rwkv":
        mix, _ = rwkv.time_mix(p["mixer"], cfg, _norm(cfg, p["ln1"], x))
        x = x + mix
        ffn_out, _ = rwkv.channel_mix(p["ffn"], cfg, _norm(cfg, p["ln2"], x))
        return x + ffn_out
    h = _norm(cfg, p["ln1"], x)
    window = cfg.local_window if kind == "local_attn" else 0
    mixer_out = attention.attention(p["mixer"], cfg, h, positions,
                                    causal=True, window=window,
                                    use_flash=use_flash)
    if cfg.parallel_block:
        return x + mixer_out + _ffn_apply(p["ffn"], cfg, h, layer_idx)
    x = x + mixer_out
    h2 = _norm(cfg, p["ln2"], x)
    return x + _ffn_apply(p["ffn"], cfg, h2, layer_idx)


def run_block(fn, remat: bool, *args, context_fn=None):
    """``fn(*args)``, checkpointed (its activations recomputed in the
    backward) when ``remat``; ``context_fn`` selects what a
    checkpoint keeps (``torch.utils.checkpoint``'s selective form)."""
    if not remat:
        return fn(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def apply(params: dict, cfg: ModelConfig, batch: dict, *,
          use_flash: bool = False, remat: bool = False) -> torch.Tensor:
    """Full-sequence forward over the unrolled tree -> logits (B, S, V).
    (The JAX function also returns the MoE aux loss, 0.0 here.)"""
    if cfg.is_encdec:
        raise not_ported("the encoder-decoder stack")
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, b, s, batch, x.device)
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.block_pattern)):
        def block(p_, x_, i=i, kind=kind):
            return _block_apply(p_, cfg, kind, i, x_, positions,
                                use_flash=use_flash)

        x = run_block(block, remat, p, x)
    x = _norm(cfg, params["final_norm"], x)
    return _lm_head(params, cfg, x)


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
    logits = apply(params, cfg, batch, use_flash=use_flash, remat=remat)
    return sharded_cross_entropy(logits, batch["labels"],
                                 softcap=cfg.logit_softcap)
