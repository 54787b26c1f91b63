"""Architecture registry: ``--arch <id>`` resolves here.

The JAX package's ten assigned architectures (six families) and the
training-example model, each config a copy of the JAX package's
(``all_configs``, ``ASSIGNED``); and the port's own configurations,
which ``get_config`` resolves too: ``deepseek-v2-lite``, the published
DeepSeek-V2-Lite (dropless routing, YaRN), beside the JAX package's
``deepseek-v2-lite-16b``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "command-r-35b": "command_r_35b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "granite-8b": "granite_8b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "grok-1-314b": "grok_1_314b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "repro-100m": "repro_100m",
}

ASSIGNED = tuple(k for k in _MODULES if k != "repro-100m")

# the port's own configurations: no JAX counterpart
_PORT_ONLY = {"deepseek-v2-lite": "deepseek_v2_lite"}


def get_config(arch_id: str) -> ModelConfig:
    mods = {**_MODULES, **_PORT_ONLY}
    if arch_id not in mods:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(mods)}")
    mod = importlib.import_module(f"repro_torch.configs.{mods[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
