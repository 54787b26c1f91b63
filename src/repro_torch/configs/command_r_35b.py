"""command-r-35b [dense] — Cohere Command-R v01 [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000. GQA, no bias.
Cohere specifics: parallel attention+FFN block sharing one LayerNorm,
tied input/output embeddings, rope_theta=8e6.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256_000,
    head_dim=128,
    qkv_bias=False,
    out_bias=False,
    rope_theta=8_000_000.0,
    norm="layernorm",
    act="silu",
    glu=True,
    parallel_block=True,
    tie_embeddings=True,
    sliding_window_decode=4096,   # long_500k sub-quadratic serving variant
)
