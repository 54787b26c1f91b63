"""Model configuration system (a stdlib copy of ``repro.models.common``).

One ``ModelConfig`` describes any architecture in the zoo (6 families). The
per-layer ``block_pattern`` composes heterogeneous stacks (e.g. recurrent-
gemma's RG-LRU/RG-LRU/local-attn 2:1 pattern). ``reduced()`` derives the
CPU smoke-test variant required per assigned architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int               # routed experts
    top_k: int
    d_ff_expert: int             # per-expert hidden width
    n_shared: int = 0            # always-on shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance loss weight
    # port only (JAX's MoEConfig has none): every (token, choice) goes to
    # its expert, no capacity, no groups, the top-k gates the router's
    # probabilities (DeepSeek-V2's ``norm_topk_prob`` false; the module
    # docstring of ``moe``)
    dropless: bool = False


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN rope scaling (arXiv:2309.00071) as DeepSeek-V2's
    ``rope_scaling`` states it (``type: yarn``); see ``layers.yarn_freqs``
    and ``layers.yarn_mscale``. Port only: JAX's ModelConfig has none."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    out_bias: bool = False
    rope_theta: float = 10_000.0
    rope_variant: str = "rope"   # rope | mrope | none
    rope_scaling: Optional[YaRNConfig] = None   # port only: YaRN
    mrope_sections: Sequence[int] = (16, 24, 24)
    logit_softcap: float = 0.0
    local_window: int = 0        # window for 'local_attn' blocks
    # block composition; entries: attn | local_attn | rwkv | rglru | mla
    block_pattern: Sequence[str] = ()
    # norm / mlp
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "silu"            # silu | gelu
    glu: bool = True             # gated MLP (SwiGLU/GeGLU) vs plain 2-layer
    parallel_block: bool = False  # Cohere-style attn+mlp in parallel
    # families
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rwkv_head_dim: int = 64
    rglu_width: int = 0          # RG-LRU width (0 -> d_model)
    conv_width: int = 4          # temporal conv in recurrent blocks
    # embeddings
    tie_embeddings: bool = False
    embed_scale: bool = False    # multiply embeddings by sqrt(d_model)
    # encoder-decoder (audio family)
    n_encoder_layers: int = 0
    # modality frontend: token | patch_stub | frame_stub
    frontend: str = "token"
    # serving
    sliding_window_decode: int = 0  # >0: windowed KV cache for long-context

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern:
            kind = "mla" if self.mla is not None else "attn"
            object.__setattr__(self, "block_pattern",
                               tuple([kind] * self.n_layers))
        if len(self.block_pattern) != self.n_layers:
            raise ValueError(
                f"{self.arch_id}: block_pattern len {len(self.block_pattern)}"
                f" != n_layers {self.n_layers}")

    # ---- derived quantities -------------------------------------------------

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (the dry run's ``params``)."""
        from repro_torch.models import transformer  # avoids a cycle
        return transformer.count_params(self)

    def active_param_count(self) -> int:
        """Activated params per token (= param_count for non-MoE)."""
        from repro_torch.models import transformer
        return transformer.count_params(self, active_only=True)

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant: same family/block kinds, tiny dims."""
        n_heads = max(2, min(4, self.n_heads))
        head_dim = d_model // n_heads
        n_kv = min(self.n_kv_heads, n_heads)
        # preserve the flavor of the pattern in 2 layers
        kinds = list(dict.fromkeys(self.block_pattern))  # unique, ordered
        pattern = tuple((kinds * n_layers)[:n_layers])
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                n_shared=min(1, self.moe.n_shared),
                d_ff_expert=d_model)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=64, qk_nope_head_dim=head_dim,
                            qk_rope_head_dim=head_dim // 2,
                            v_head_dim=head_dim)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, head_dim=head_dim, d_ff=2 * d_model, vocab=vocab,
            block_pattern=pattern, moe=moe, mla=mla,
            local_window=min(self.local_window, 64) if self.local_window else 0,
            rglu_width=0, mrope_sections=_reduced_sections(self, head_dim),
            n_encoder_layers=min(self.n_encoder_layers, n_layers),
            sliding_window_decode=(64 if self.sliding_window_decode else 0))


def _reduced_sections(cfg: ModelConfig, head_dim: int) -> Sequence[int]:
    if cfg.rope_variant != "mrope":
        return cfg.mrope_sections
    half = head_dim // 2
    a = half // 4
    return (half - 2 * a, a, a)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
