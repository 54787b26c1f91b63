"""Architecture registry: ``--arch <id>`` resolves here.

Only the architectures the port can run are registered; the JAX
package's other ids raise a ``KeyError`` that says they are not ported
yet (M-RoPE and the encoder-decoder stack come with later slices).
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "command-r-35b": "command_r_35b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-8b": "granite_8b",
    "grok-1-314b": "grok_1_314b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "repro-100m": "repro_100m",
    "rwkv6-3b": "rwkv6_3b",
}

# architectures of the JAX package that the port does not run yet
NOT_PORTED = ("qwen2-vl-72b", "seamless-m4t-large-v2")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch '{arch_id}' is not ported to repro_torch yet; "
                       f"ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
