"""Block primitives shared by the model assemblies.

The port of ``repro.models.transformer``'s attention-block init, norm,
dense FFN, token embedding and (tied or untied) LM head — what
``transformer_scan`` needs for attention-only stacks. MoE FFNs and the
MLA / RWKV / RG-LRU mixers come with the models slice; the unrolled
assembly (``apply`` / ``decode_step`` over a ``layers`` list) is not
ported, since serving runs the scanned layout.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention, layers
from repro_torch.models.common import ModelConfig

ATTN_KINDS = ("attn", "local_attn")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (models slice: MoE, MLA, "
        "RWKV, RG-LRU and enc-dec stacks)")


def _moe_skipped(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.arch_id.startswith("deepseek") and layer_idx == 0


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                layer_idx: int, *, lead: tuple = (), dtype=torch.float32
                ) -> dict:
    """One attention block's params; ``lead`` stacks n_rep copies."""
    if kind not in ATTN_KINDS:
        raise not_ported(f"block kind '{kind}'")
    if cfg.moe is not None and not _moe_skipped(cfg, layer_idx):
        raise not_ported("the MoE FFN")
    if cfg.is_encdec:
        raise not_ported("cross attention")
    dev = gen.device
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
    x = params["embed"][batch["tokens"]]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=x.device).to(x.dtype)
    return x


def _lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor
             ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return layers.dense(params["lm_head"], x)
