"""granite-8b [dense] — IBM Granite Code 8B [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152. Llama-arch, code
model; tied embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=49_152,
    head_dim=128,
    qkv_bias=False,
    rope_theta=10_000_000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    tie_embeddings=True,
    sliding_window_decode=4096,
)
