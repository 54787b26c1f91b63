"""qwen2-vl-72b [vlm] — Qwen2-VL [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; M-RoPE with
sections (16,24,24) over (temporal,height,width) position ids; dynamic-
resolution ViT frontend is the allowed STUB — input_specs() supplies patch
embeddings + 3-axis position grids (DESIGN.md §3).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    norm="rmsnorm",
    act="silu",
    glu=True,
    frontend="patch_stub",
    sliding_window_decode=4096,
)
