"""The reference of compressed SGD on the partitioned rq4 ring AllReduce
(the paper's Figure 3.3), N workers, one step after another:

  * worker w's gradient g_w (``model.loss_sum`` over its rows, mean over
    its tokens) is laid out as the flat message (``layout.flat_order``),
    edge-padded with its last element to N * P and cut into N
    partitions of P elements, P the message over N rounded up to the
    codec's granule;
  * with the step's key k and worker keys k_w = fold_in(k, w): worker w
    starts with Q(g_w[w]) under k_w; at hop h = 1 .. N - 1 it takes the
    partial sum of partition (w - h) mod N from worker w - 1 and makes
    Q(that + g_w[(w - h) mod N]) under fold_in(k_w, h), where Q is the
    rq4 qdq of a P-element message (``quant.qdq``: decoding an encoded
    message gives the qdq's values);
  * the finished partitions, gathered verbatim, divided by N, are the
    update u, and every worker takes p - lr u.

The step's key is fold_in(root, t) for step t = 0, 1, ..., root the raw
key of the seed.
"""
from __future__ import annotations

import torch

from . import layout, quant, threefry

GRANULE = (8 // quant.BITS) * quant.LANES


def allreduce(flats: list, key: tuple) -> torch.Tensor:
    """The ring's mean of the workers' flat gradients (as fp32)."""
    n, total = len(flats), flats[0].numel()
    part = -(-(-(-total // n)) // GRANULE) * GRANULE
    padded = []
    for f in flats:
        p = torch.empty(n * part, dtype=torch.float32, device=f.device)
        p[:total] = f
        p[total:] = f[total - 1]
        padded.append(p.view(n, part))
    wkeys = [threefry.fold_in(key, w) for w in range(n)]
    acc = [quant.qdq(padded[w][w], wkeys[w]) for w in range(n)]
    for h in range(1, n):
        acc = [quant.qdq(acc[(w - 1) % n] + padded[w][(w - h) % n],
                         threefry.fold_in(wkeys[w], h)) for w in range(n)]
    # worker w finished partition (w + 1) mod N
    out = torch.empty(n * part, dtype=torch.float32,
                      device=flats[0].device)
    for w in range(n):
        p = (w + 1) % n
        out[p * part:(p + 1) * part] = acc[w]
    return out[:total].div_(n)


def run(W: dict, m: dict, worker_batches: list, seed: int, lr: float, *,
        precision: str = "fp32", rows: int = 1) -> dict:
    """Follow len(worker_batches) steps; worker_batches[t][w] is worker
    w's (tokens, labels) at step t. Returns each step's per-worker
    losses, the per-leaf norms of the first step's update u as SGD gets
    it, the raw first gradients' per-leaf norms (the mean over the
    workers'), and the per-leaf norms of the parameters' change."""
    from . import train
    order = layout.flat_order(m)
    params = {n: W[n].detach().clone() for n in order}
    root = threefry.key_of_seed(seed)
    out = {"loss": []}
    for t, batches in enumerate(worker_batches):
        losses, flats = [], []
        raw = {}
        for tokens, labels in batches:
            loss, g = train.grads(params, m, tokens, labels,
                                  precision=precision, rows=rows)
            losses.append(loss)
            if t == 0:
                for name in order:
                    raw[name] = raw.get(name, 0) + g[name] / len(batches)
            flats.append(torch.cat([g[n].reshape(-1) for n in order]))
            del g
        out["loss"].append(losses)
        u = allreduce(flats, threefry.fold_in(root, t))
        del flats
        off = 0
        if t == 0:
            out["raw_grad_norm"] = {n: float(torch.linalg.vector_norm(
                raw[n].double())) for n in order}
            out["grad_norm"] = {}
        for name in order:
            p = params[name]
            un = u[off:off + p.numel()].view_as(p)
            off += p.numel()
            if t == 0:
                out["grad_norm"][name] = float(
                    torch.linalg.vector_norm(un.double()))
            params[name] = p - lr * un
        del u
    out["update_norm"] = {n: float(torch.linalg.vector_norm(
        (params[n] - W[n]).double())) for n in order}
    return out
