"""seamless-m4t-large-v2 [audio] — SeamlessM4T v2 [arXiv:2308.11596].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206. Encoder-decoder
multimodal backbone: 24 bidirectional encoder layers over precomputed
speech-frame embeddings (conformer/mel frontend is the allowed STUB; see
DESIGN.md §3) + 24 causal decoder layers with cross-attention.
Adaptation note: learned/sinusoidal positions replaced by RoPE (framework
uniformity; recorded in DESIGN.md hardware-adaptation notes).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256_206,
    head_dim=64,
    qkv_bias=True,
    out_bias=True,
    norm="layernorm",
    act="gelu",
    glu=False,
    embed_scale=True,
    frontend="frame_stub",
    sliding_window_decode=4096,
)
