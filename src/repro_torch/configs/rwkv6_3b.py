"""rwkv6-3b [ssm] — RWKV-6 "Finch" [arXiv:2404.05892].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536; data-dependent
decay time-mix + squared-ReLU channel-mix. O(1) recurrent state.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # informational; time-mix uses rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65_536,
    rope_variant="none",
    norm="layernorm",
    block_pattern=tuple(["rwkv"] * 32),
    rwkv_head_dim=64,
)
