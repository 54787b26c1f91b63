"""Inputs made from the run's seed, on the run's device: the random
weights (one generator, one normal draw a weight, into one flat fp32
buffer) and token ids (a second generator). Both sides of a check get
the same tensors; making them again from the same seed gives the same
values.
"""
from __future__ import annotations

import torch

from reference import layout

ALIGN = 64          # elements: every weight starts 256-byte aligned


def _generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 2 + salt) % (1 << 63))


def weights(m: dict, seed: int, device) -> dict:
    """name -> fp32 tensor (views of one buffer), drawn as
    ``layout.init_spec`` says."""
    shp = layout.shapes(m)
    offs, n = {}, 0
    for name in layout.flat_order(m):
        offs[name] = n
        size = 1
        for d in shp[name]:
            size *= d
        n += -(-size // ALIGN) * ALIGN
    buf = torch.empty(n, dtype=torch.float32, device=device)
    gen = _generator(seed, 0, device)
    out = {}
    for name, (std, mean) in layout.init_spec(m).items():
        size = 1
        for d in shp[name]:
            size *= d
        w = buf[offs[name]:offs[name] + size].view(shp[name])
        torch.randn(shp[name], generator=gen, device=device, out=w)
        w.mul_(std)
        if mean:
            w.add_(mean)
        out[name] = w
    return out


class Tokens:
    """Token ids drawn in order from the seed: the i-th call gives the
    same ids for the same seed and shapes."""

    def __init__(self, seed: int, vocab: int, device):
        self.vocab, self.device = vocab, device
        self.gen = _generator(seed, 1, device)

    def draw(self, shape: tuple) -> torch.Tensor:
        return torch.randint(0, self.vocab, shape, generator=self.gen,
                             device=self.device, dtype=torch.int64)
