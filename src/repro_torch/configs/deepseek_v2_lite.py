"""deepseek-v2-lite — DeepSeek-V2-Lite as published (arXiv:2405.04434;
huggingface.co/deepseek-ai/DeepSeek-V2-Lite ``config.json``).

27 layers, d_model 2,048, 16 heads, vocab 102,400, an untied head; MLA
without a query LoRA (kv_lora_rank 512, qk_nope 128 / qk_rope 64 /
v_head 128); layer 0 a dense SwiGLU FFN of 10,944, the other 26 MoE
layers of 64 routed experts of 1,408 (top-6, softmax scores, greedy,
gates not renormalised, routed_scaling_factor 1) beside 2 shared
experts; YaRN rope (factor 40 over 4,096 original positions, beta_fast
32, beta_slow 1, mscale = mscale_all_dim = 0.707, theta 10,000);
rms_norm_eps 1e-6; 163,840 positions. 15,706,484,224 parameters.

Every token's every choice reaches its expert, gated by its router
probability (``MoEConfig.dropless``), as the published model computes. ``deepseek-v2-lite-16b`` stays the
JAX package's copy, which departs from this one: capacity dropping in
groups of 4,096, renormalised gates, layer 0 1,408 wide, no YaRN, eps
1e-5 and a 4,096-slot decode window.

Departures kept here: the rope columns. DeepSeek-V2 rotates the rope
part of q and of the shared key in an interleaved layout (the pairs
(2i, 2i + 1)); the port rotates halves (i, i + D/2). The two differ by
a fixed permutation of the rope columns of ``q_proj`` and ``kv_down``,
so on random weights they are the same model; a checkpoint loader
would permute those columns. The two shared experts are the published
shared MLP of 2 x 1,408 = 2,816 split into two blocks of its hidden
units (the same function), and ``k_up`` / ``v_up`` are the published
``kv_b_proj``'s columns split by kind.
"""
from repro_torch.models.common import (MLAConfig, ModelConfig, MoEConfig,
                                       YaRNConfig)

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10_944,
    vocab=102_400,
    head_dim=128,
    rope_theta=10_000.0,
    rope_scaling=YaRNConfig(factor=40.0,
                            original_max_position_embeddings=4096,
                            beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                            mscale_all_dim=0.707),
    norm="rmsnorm",
    norm_eps=1e-6,
    act="silu",
    glu=True,
    tie_embeddings=False,
    block_pattern=tuple(["mla"] * 27),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  dropless=True),
    sliding_window_decode=0,
)
