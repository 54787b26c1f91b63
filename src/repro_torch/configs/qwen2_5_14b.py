"""qwen2.5-14b [dense] — Qwen2.5 family [hf:Qwen/Qwen2.5-0.5B card lineage].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064. GQA with QKV bias.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13_824,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    out_bias=False,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    sliding_window_decode=4096,
)
