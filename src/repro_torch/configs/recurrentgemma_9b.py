"""recurrentgemma-9b [hybrid] — Griffin architecture [arXiv:2402.19427].

38L d_model=4096 16H (GQA kv=1 = MQA) d_ff=12288 vocab=256000; RG-LRU
recurrent blocks and local attention in 2:1 pattern (rg, rg, local_attn),
local window 2048, lru_width 5632 (model card), GeGLU MLP, scaled
embeddings. O(width) recurrent state + windowed attention -> long_500k
runs natively.
"""
from repro_torch.models.common import ModelConfig

_PATTERN = tuple((["rglru", "rglru", "local_attn"] * 13)[:38])

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12_288,
    vocab=256_000,
    head_dim=256,
    qkv_bias=False,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="gelu",
    glu=True,
    block_pattern=_PATTERN,
    local_window=2048,
    rglu_width=5632,
    conv_width=4,
    embed_scale=True,
    tie_embeddings=True,
)
