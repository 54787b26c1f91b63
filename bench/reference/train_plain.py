"""The reference training step without a codec: loss and gradient of the
fp32 model (``train.grads``), global-norm clipping to 1, then AdamW (b1
0.9, b2 0.95, eps 1e-8, no weight decay) with the bias corrections in
fp32, at a linear warm-up learning rate ``peak * t / warmup`` (t = 1, 2,
...; ``warmup`` > the steps run): ``train.run`` with the rq4 qdq and
its error feedback left out, the step of ``--compression none``.
"""
from __future__ import annotations

import torch

from . import layout
from .train import B1, B2, EPS, _norms, grads


def run(W: dict, m: dict, batches: list, opt: dict, *,
        precision: str = "fp32", rows: int = 1) -> dict:
    """Follow ``len(batches)`` steps from the weights ``W`` (not
    modified); returns what ``train.run`` returns."""
    order = layout.flat_order(m)
    params = {n: W[n].detach().clone() for n in order}
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    vel = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"loss": []}
    for t, (tokens, labels) in enumerate(batches, start=1):
        loss, g = grads(params, m, tokens, labels, precision=precision,
                        rows=rows)
        out["loss"].append(loss)
        if t == 1:
            out["raw_grad_norm"] = _norms(g)
        gn = torch.sqrt(sum(torch.sum(g[n] ** 2) for n in order))
        clip = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
        lr = opt["lr"] * t / opt["warmup"]
        bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** float(t)
        bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** float(t)
        for n in order:
            gq = g[n] * clip
            mom[n].mul_(B1).add_(gq, alpha=1 - B1)
            vel[n].mul_(B2).add_(gq * gq, alpha=1 - B2)
            u = (mom[n] / bc1) / (torch.sqrt(vel[n] / bc2) + EPS)
            params[n].add_(-lr * u)
        del g
        if t == 1:
            out["grad_norm"] = {n: float(torch.linalg.vector_norm(
                (mom[n] / (1 - B1)).double())) for n in order}
    out["update_norm"] = {n: float(torch.linalg.vector_norm(
        (params[n] - W[n]).double())) for n in order}
    return out
