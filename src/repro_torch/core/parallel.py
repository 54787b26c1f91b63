"""N-worker data-parallel first-order training with swappable exchanges.

The port of ``repro.core.parallel``, the paper-faithful algorithm tier:
every worker has its own gradient stream, compression randomness, error
state and (for DSGD) model replica. JAX maps one worker's step over a
named axis (``vmap`` on one device, ``shard_map`` across devices) and
scans over steps. Here the steps are a Python loop, and the workers
either the rows of stacked tensors on one device (their gradients a
loop over the rows), or, with ``axis_name=`` a
``communicators.RankAxis`` (over a process group), one worker a rank: each rank runs JAX's
per-worker step for its own worker, the exchanges' collectives go
between the ranks, and x̄ and the consensus are all-reduces. The keys
are JAX's, so both packages draw the same batches and the same codec
bits:

    step_key = fold_in(PRNGKey(seed), t)
    batch keys = split(step_key, n_workers)      # row i samples with key i
    every exchange and gossip operator gets step_key

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import compression, prng, pytree
from repro_torch.core.communicators import (GossipMix, MbSGDExchange,
                                            worker_axis)
from repro_torch.device import resolve_device
from repro_torch.train.steps import value_and_grad

PyTree = Any


@dataclasses.dataclass(frozen=True)
class RunResult:
    losses: torch.Tensor       # (steps,) f at the (averaged) iterate
    grad_norms: torch.Tensor   # (steps,) ||f'(x_bar)||^2 (the paper's metric)
    params: PyTree             # final per-worker params, leading axis N
                               # (on ranks: this rank's worker's)
    consensus: torch.Tensor    # (steps,) mean ||x_n - x_bar||^2 (Lemma 5.2.4)
    comm_bytes_per_step: float = 0.0   # measured wire bytes one worker
                                       # puts on the wire per iteration


def _broadcast(params: PyTree, n: int, device) -> PyTree:
    return pytree.tree_map(
        lambda p: p.to(device).unsqueeze(0).repeat(
            (n,) + (1,) * p.dim()), params)


def _mean_w(p: torch.Tensor) -> torch.Tensor:
    """The mean over workers, accumulated in float64 and rounded once:
    rows that are bit-identical average to themselves exactly, so the
    consensus of identical workers is exactly 0."""
    return p.mean(dim=0, dtype=torch.float64).to(p.dtype)


def run_distributed(
    loss_fn: Callable[[PyTree, Any], torch.Tensor],
    full_loss_fn: Callable[[PyTree], torch.Tensor],
    full_grad_fn: Callable[[PyTree], PyTree],
    params0: PyTree,
    sample_batch: Callable[..., Any],
    *,
    n_workers: int,
    steps: int,
    lr: float,
    exchange: Any = None,
    gossip: Optional[GossipMix] = None,
    seed: int = 0,
    device=None,
    axis_name=None,
) -> RunResult:
    """Run ``steps`` iterations of (C/EC/A/D-)SGD with ``n_workers``.

    loss_fn(params, batch): one worker's minibatch loss.
    full_loss_fn / full_grad_fn: deterministic f and f' for metrics.
    sample_batch(key, worker): one worker-minibatch (``worker`` is the
        row index, the port's ``axis_index``; most samplers ignore it).
    exchange: gradient communicator (None + gossip => pure DSGD step).
    gossip: optional model-mixing operator applied after the SGD update,
        stateless (GossipMix) or stateful (DCD/ECD, ``init_stacked``).
    device: where the workers' stacked tensors live (``cuda`` unless
        the caller asks for the CPU).
    axis_name: None (the workers stacked on one device), or a
        ``RankAxis`` of ``n_workers`` ranks, this rank running
        its own worker (its batch is ``sample_batch(keys[rank], rank)``).

    ``RunResult.params`` holds the final stacked parameters (on ranks,
    this rank's worker's).
    """
    device = resolve_device(device)
    exchange = exchange if exchange is not None else MbSGDExchange()
    axis = worker_axis(axis_name)
    if axis is not None:
        if axis.n != n_workers:
            raise ValueError(f"{n_workers} workers on {axis.n} ranks")
        return _run_on_ranks(loss_fn, full_loss_fn, full_grad_fn, params0,
                             sample_batch, axis=axis, steps=steps, lr=lr,
                             exchange=exchange, gossip=gossip, seed=seed,
                             device=device)
    params_w = _broadcast(params0, n_workers, device)
    ex_state_w = exchange.init(params_w)
    stateful_gossip = gossip is not None and hasattr(gossip, "init_stacked")
    g_state_w = gossip.init_stacked(params_w) if stateful_gossip else ()
    root = prng.PRNGKey(seed)
    losses, gnorms, cons = [], [], []
    for t in range(steps):
        step_key = prng.fold_in(root, t)
        keys = prng.split(step_key, n_workers)
        grads = []
        for i in range(n_workers):
            params_i = pytree.tree_map(lambda p: p[i], params_w)
            _, g = value_and_grad(loss_fn, params_i,
                                  sample_batch(keys[i], i))
            grads.append(g)
        grads_w = pytree.tree_map(lambda *gs: torch.stack(gs), *grads)
        del grads
        upd, ex_state_w = exchange(grads_w, ex_state_w, step_key)
        del grads_w
        params_w = pytree.tree_map(lambda p, u: p - lr * u, params_w, upd)
        del upd
        if stateful_gossip:
            params_w, g_state_w = gossip(params_w, g_state_w, step_key)
        elif gossip is not None:
            params_w = gossip(params_w)
        x_bar = pytree.tree_map(_mean_w, params_w)
        losses.append(full_loss_fn(x_bar).detach())
        g_bar = full_grad_fn(x_bar)
        gnorms.append(sum(torch.sum(g ** 2)
                          for g in pytree.tree_leaves(g_bar)))
        cons.append(sum(torch.sum((p - m) ** 2) / p.shape[0]
                        for p, m in zip(pytree.tree_leaves(params_w),
                                        pytree.tree_leaves(x_bar))))
    comm = 0.0
    if hasattr(exchange, "message_bytes"):
        comm += float(exchange.message_bytes(params0, n_workers=n_workers))
    if gossip is not None:
        comm += float(gossip.message_bytes(params0, n_workers=n_workers))
    return RunResult(torch.stack(losses), torch.stack(gnorms), params_w,
                     torch.stack(cons), comm)


def _run_on_ranks(loss_fn, full_loss_fn, full_grad_fn, params0,
                  sample_batch, *, axis, steps, lr, exchange, gossip, seed,
                  device) -> RunResult:
    """``run_distributed`` with one worker a rank: JAX's per-worker step
    (``repro.core.parallel``'s ``one``) for worker ``axis.index``; x̄ is
    an all-reduce of the float64 params, rounded once (identical replicas
    average to themselves exactly), the consensus an all-reduce of each
    rank's squared distance from it."""
    n, me = axis.n, axis.index
    params = pytree.tree_map(lambda p: p.to(device).clone(), params0)
    ex_state = exchange.init(params, axis_name=axis)
    stateful_gossip = gossip is not None and hasattr(gossip, "init_stacked")
    g_state = gossip.init_stacked(params, axis_name=axis) \
        if stateful_gossip else ()
    layout = compression.FlatLayout.from_tree(params)
    root = prng.PRNGKey(seed)
    losses, gnorms, cons = [], [], []
    for t in range(steps):
        step_key = prng.fold_in(root, t)
        bkey = prng.split(step_key, n)[me]
        _, g = value_and_grad(loss_fn, params, sample_batch(bkey, me))
        upd, ex_state = exchange(g, ex_state, step_key, axis_name=axis)
        del g
        params = pytree.tree_map(lambda p, u: p - lr * u, params, upd)
        del upd
        if stateful_gossip:
            params, g_state = gossip(params, g_state, step_key,
                                     axis_name=axis)
        elif gossip is not None:
            params = gossip(params, axis_name=axis)
        flat = layout.flatten(params)
        x_bar_flat = axis.psum(flat.double()).div_(n).float()
        x_bar = layout.unflatten(x_bar_flat)
        losses.append(full_loss_fn(x_bar).detach())
        g_bar = full_grad_fn(x_bar)
        gnorms.append(sum(torch.sum(g ** 2)
                          for g in pytree.tree_leaves(g_bar)))
        dist2 = torch.stack([torch.sum((p - m) ** 2) for p, m in zip(
            pytree.tree_leaves(params), pytree.tree_leaves(x_bar))])
        cons.append(axis.psum(dist2).div_(n).sum())
    comm = 0.0
    if hasattr(exchange, "message_bytes"):
        comm += float(exchange.message_bytes(params0, n_workers=n))
    if gossip is not None:
        comm += float(gossip.message_bytes(params0, n_workers=n))
    return RunResult(torch.stack(losses), torch.stack(gnorms), params,
                     torch.stack(cons), comm)


# ---------------------------------------------------------------------------
# Canonical testbed: distributed least squares (the paper's §1.1.3 example,
# F_m = 1/2 (a_m^T x - b_m)^2) with controllable inner variance sigma and
# outer (across-worker) variance varsigma — the knobs of Assumptions 2 and 6.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Quadratic:
    a: torch.Tensor        # (M, d) design
    b: torch.Tensor        # (M,) targets
    worker_slices: int     # workers partition rows (varsigma > 0) if > 1

    @staticmethod
    def make(key, *, m: int = 1024, d: int = 32, noise: float = 0.1,
             heterogeneity: float = 0.0, n_workers: int = 1,
             device=None) -> "Quadratic":
        """JAX's problem from the same key: ``prng.normal`` draws (allclose
        to ``jax.random.normal``, see there), the same arithmetic."""
        device = resolve_device(device)
        k1, k2, k3, k4 = prng.split(key, 4)
        a = prng.normal(k1, (m, d), device=device) / float(
            np.float32(np.sqrt(d)))
        x_true = prng.normal(k2, (d,), device=device)
        b = a @ x_true + noise * prng.normal(k3, (m,), device=device)
        if heterogeneity > 0:
            # shift each worker's targets -> nonzero outer variance varsigma
            shifts = heterogeneity * prng.normal(k4, (n_workers,),
                                                 device=device)
            rows = shifts.repeat_interleave(m // n_workers)
            rows = torch.cat([rows, rows[-1:].expand(m - rows.shape[0])])
            b = b + rows
        return Quadratic(a, b, n_workers)

    def full_loss(self, x: torch.Tensor) -> torch.Tensor:
        r = self.a @ x - self.b
        return 0.5 * torch.mean(r ** 2)

    def full_grad(self, x: torch.Tensor) -> torch.Tensor:
        return value_and_grad(lambda p, _: self.full_loss(p), x, None)[1]

    def lipschitz(self) -> float:
        """L = lambda_max(A^T A / M)."""
        h = (self.a.T @ self.a) / self.a.shape[0]
        return float(torch.linalg.eigvalsh(h)[-1])

    def minimum(self) -> torch.Tensor:
        sol = torch.linalg.lstsq(self.a, self.b[:, None]).solution[:, 0]
        return self.full_loss(sol)

    def loss_on(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        idx = idx.to(self.a.device).long()
        r = self.a[idx] @ x - self.b[idx]
        return 0.5 * torch.mean(r ** 2)

    def make_sampler(self, batch: int, *, worker_partition: bool = False,
                     n_workers: int = 1) -> Callable[..., torch.Tensor]:
        """sample_batch(key, worker) -> row indices.

        worker_partition=True gives each worker a disjoint row range
        (decentralized data, D_n of Eq. 3.7) by its row index."""
        m = self.a.shape[0]
        if not worker_partition:
            return lambda key, worker: prng.randint(key, (batch,), 0, m)
        rows_per = m // n_workers

        def sampler(key, worker):
            return worker * rows_per + prng.randint(key, (batch,), 0,
                                                    rows_per)

        return sampler


class LocalExchange:
    """No gradient exchange: plain local SGD step (the D/DCD/ECD-SGD
    gradient tier — all communication happens in the gossip operator)."""

    name = "local"

    def init(self, params_w, *, axis_name=None):
        return ()

    def __call__(self, grad, state, key, *, axis_name=None):
        return grad, state


def run_quadratic(method: str, *, n_workers: int = 8, steps: int = 300,
                  lr: float = 0.1, batch: int = 4, seed: int = 0,
                  d: int = 32, heterogeneity: float = 0.0,
                  exchange_kw: dict | None = None,
                  gossip_topology: str | None = None,
                  gossip_w=None, device=None, axis_name=None) -> RunResult:
    """One-call entry point: method in {gd, sgd, mbsgd, csgd_ps, csgd_ring,
    ecsgd, asgd, dsgd, dcd, ecd}, as the JAX package's; ``axis_name`` (a
    ``RankAxis`` over a process group of ``n_workers`` ranks) runs one
    worker a rank (``run_distributed``).

    dsgd/dcd/ecd accept ``gossip_topology`` in {'ring', 'torus', 'full'}
    or an explicit doubly stochastic ``gossip_w``; ``exchange_kw`` goes
    to the exchange (``{'compressor': ...}``, asgd's ``tau`` /
    ``schedule``). ``d`` sets the quadratic's dimension."""
    from repro_torch.core import communicators as C

    device = resolve_device(device)
    prob = Quadratic.make(prng.PRNGKey(seed), d=d, n_workers=n_workers,
                          heterogeneity=heterogeneity, device=device)
    x0 = torch.zeros(prob.a.shape[1], device=device)
    exchange_kw = dict(exchange_kw or {})

    gossip = None
    if method == "gd":
        m = prob.a.shape[0]
        exchange, n_workers = C.MbSGDExchange(), 1
        sampler = lambda key, worker: torch.arange(m)  # noqa: E731
    elif method in ("sgd", "mbsgd"):
        exchange = C.MbSGDExchange()
        n_workers = 1 if method == "sgd" else n_workers
        sampler = prob.make_sampler(batch)
    elif method == "csgd_ps":
        exchange = C.CSGDPSExchange(**exchange_kw)
        sampler = prob.make_sampler(batch)
    elif method == "csgd_ring":
        exchange = C.CSGDRingExchange(**exchange_kw)
        sampler = prob.make_sampler(batch)
    elif method == "ecsgd":
        exchange = C.ECSGDExchange(**exchange_kw)
        sampler = prob.make_sampler(batch)
    elif method == "asgd":
        exchange = C.DelayedExchange(inner=C.MbSGDExchange(), **exchange_kw)
        sampler = prob.make_sampler(batch)
    elif method == "dsgd":
        # DSGD does NOT all-reduce gradients: local step + gossip
        exchange = LocalExchange()
        gossip = GossipMix(topology=gossip_topology or "ring", w=gossip_w)
        sampler = prob.make_sampler(batch, worker_partition=True,
                                    n_workers=n_workers)
    elif method in ("dcd", "ecd"):
        exchange = LocalExchange()
        cls = C.DCDGossipExchange if method == "dcd" else C.ECDGossipExchange
        gossip = cls(topology=gossip_topology or "ring", w=gossip_w,
                     **exchange_kw)
        sampler = prob.make_sampler(batch, worker_partition=True,
                                    n_workers=n_workers)
    else:
        raise ValueError(f"unknown method {method}")

    return run_distributed(
        prob.loss_on, prob.full_loss, prob.full_grad, x0, sampler,
        n_workers=n_workers, steps=steps, lr=lr, exchange=exchange,
        gossip=gossip, seed=seed, device=device, axis_name=axis_name)
