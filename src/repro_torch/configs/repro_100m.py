"""repro-100m — the end-to-end training-example model (~115M params).

Not an assigned architecture: a llama-style decoder sized so the
examples/train_lm.py driver can train a few hundred steps on CPU-class
hardware while exercising the same code paths as the production archs.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab=32_768,
    head_dim=64,
    norm="rmsnorm",
    act="silu",
    glu=True,
    tie_embeddings=True,
    sliding_window_decode=1024,
)
