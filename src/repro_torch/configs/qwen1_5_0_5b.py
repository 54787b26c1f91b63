"""qwen1.5-0.5b [dense] — Qwen1.5 0.5B [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=2816 vocab=151936; QKV bias,
tied embeddings. Also the quickstart-scale architecture.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151_936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    tie_embeddings=True,
    sliding_window_decode=4096,
)
