"""DeepSeek-V2-Lite's random weights made from the run's seed, on the
run's device, as ``inputs.weights`` makes a dense decoder's: one
generator, one normal draw a weight in the order of
``deepseek_layout.shapes``, into one flat fp32 buffer (every weight
256-byte aligned). The program and the reference get the same tensors.
"""
from __future__ import annotations

import math

import torch

import inputs
from reference import deepseek_layout as layout


def weights(m: dict, seed: int, device) -> dict:
    """name -> fp32 tensor (views of one buffer)."""
    shp = layout.shapes(m)
    offs, n = {}, 0
    for name, shape in shp.items():
        offs[name] = n
        n += -(-math.prod(shape) // inputs.ALIGN) * inputs.ALIGN
    buf = torch.empty(n, dtype=torch.float32, device=device)
    gen = inputs._generator(seed, 0, device)
    out = {}
    for name, (std, mean) in layout.init_spec(m).items():
        w = buf[offs[name]:offs[name] + math.prod(shp[name])].view(shp[name])
        torch.randn(shp[name], generator=gen, device=device, out=w)
        w.mul_(std)
        if mean:
            w.add_(mean)
        out[name] = w
    return out
