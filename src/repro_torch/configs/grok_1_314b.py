"""grok-1-314b [moe] — xAI Grok-1 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072; MoE 8 experts
top-2. Attention-logit softcapping (30.0) as in the released model.
"""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    head_dim=128,
    qkv_bias=False,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="gelu",
    glu=True,
    logit_softcap=30.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32_768, n_shared=0),
    sliding_window_decode=4096,
)
