"""The reference training step of compressed SGD with error feedback:
loss and gradient of the fp32 model (``model.loss_sum``, rows taken in
blocks and the gradients summed), global-norm clipping to 1, the rq4
qdq of the flat message plus the residual under ``fold_in(key, t)``
(``quant``), then AdamW (b1 0.9, b2 0.95, eps 1e-8, no weight decay)
with the bias corrections in fp32, at a linear warm-up learning rate
``peak * t / warmup`` (t = 1, 2, ...; ``warmup`` > the steps run).
"""
from __future__ import annotations

import torch

from . import layout, model, quant, threefry

B1, B2, EPS = 0.9, 0.95, 1e-8


def _norms(tree: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in
            tree.items()}


def grads(W: dict, m: dict, tokens, labels, *, precision: str,
          rows: int) -> tuple:
    """(mean loss, name -> gradient) over the batch, ``rows`` rows a
    block."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in W.items()}
    total = tokens.numel()
    loss = 0.0
    for r0 in range(0, tokens.shape[0], rows):
        block = model.loss_sum(leaves, m, tokens[r0:r0 + rows],
                               labels[r0:r0 + rows], precision=precision)
        (block / total).backward()
        loss += float(block.detach().double())
    return loss / total, {n: t.grad for n, t in leaves.items()}


def run(W: dict, m: dict, batches: list, seed: int, opt: dict, *,
        precision: str = "fp32", rows: int = 1) -> dict:
    """Follow ``len(batches)`` steps from the weights ``W`` (not
    modified). Returns each step's loss, the first step's gradient as
    AdamW gets it (per-leaf norms of m_1 / (1 - b1)), the raw first
    gradient's per-leaf norms, and the per-leaf norms of the
    parameters' change over the steps."""
    order = layout.flat_order(m)
    params = {n: W[n].detach().clone() for n in order}
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    vel = {n: torch.zeros_like(p) for n, p in params.items()}
    residual = torch.zeros(sum(p.numel() for p in params.values()),
                           dtype=torch.float32,
                           device=params[order[0]].device)
    key = threefry.key_of_seed(seed)
    out = {"loss": []}
    for t, (tokens, labels) in enumerate(batches, start=1):
        loss, g = grads(params, m, tokens, labels, precision=precision,
                        rows=rows)
        out["loss"].append(loss)
        if t == 1:
            out["raw_grad_norm"] = _norms(g)
        gn = torch.sqrt(sum(torch.sum(g[n] ** 2) for n in order))
        clip = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
        flat = torch.cat([(g[n] * clip).reshape(-1) for n in order])
        del g
        q, residual = quant.qdq_with_feedback(
            flat, residual, threefry.fold_in(key, t - 1))
        del flat
        lr = opt["lr"] * t / opt["warmup"]
        bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** float(t)
        bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** float(t)
        off = 0
        for n in order:
            p = params[n]
            gq = q[off:off + p.numel()].view_as(p)
            off += p.numel()
            mom[n].mul_(B1).add_(gq, alpha=1 - B1)
            vel[n].mul_(B2).add_(gq * gq, alpha=1 - B2)
            u = (mom[n] / bc1) / (torch.sqrt(vel[n] / bc2) + EPS)
            p.add_(-lr * u)
        del q
        if t == 1:
            out["grad_norm"] = {n: float(torch.linalg.vector_norm(
                (mom[n] / (1 - B1)).double())) for n in order}
    out["update_norm"] = {n: float(torch.linalg.vector_norm(
        (params[n] - W[n]).double())) for n in order}
    return out
