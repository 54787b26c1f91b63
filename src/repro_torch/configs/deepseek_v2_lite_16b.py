"""deepseek-v2-lite-16b [moe] — DeepSeek-V2-Lite [arXiv:2405.04434].

27L d_model=2048 16H d_ff=1408(expert width) vocab=102400; MLA with
kv_lora_rank=512 (qk_nope 128 / qk_rope 64 / v_head 128); MoE with 2 shared
+ 64 routed experts, top-6. Layer 0 keeps a dense FFN (as in the released
model). Note: the assignment bracket's "160 routed" matches full V2, not
Lite; we follow the explicit "64e top-6" spec. The latent KV cache is the
long-context story: decode state is (c_kv 512 + k_rope 64) per token.
"""
from repro_torch.models.common import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    head_dim=128,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    block_pattern=tuple(["mla"] * 27),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    sliding_window_decode=4096,
)
