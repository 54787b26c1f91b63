"""Hand-rolled first-order optimizers (the port of
``repro.optim.optimizers``).

All optimizers share one interface, the JAX package's:

    opt = sgd(lr) | momentum_sgd(lr, beta) | adamw(lr, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

with the same state trees (``{"step"}``, ``{"step", "m"}``,
``{"step", "m", "v"}``), so a JAX optimizer state carries across leaf
for leaf. ``step`` is a 0-d int32 tensor on the CPU: the schedule and the
bias corrections are host scalars, and no step reads the card back.

Memory: the moment buffers are updated IN PLACE (``update`` returns the
same tensors in the new state), and ``apply_updates`` adds into the
parameters in place and returns them. JAX builds new arrays instead; the
values are the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Union

import torch

from repro_torch.core import pytree

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    name: str = "opt"


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _eta(lr: Union[float, Schedule], step: torch.Tensor):
    """The learning rate at ``step``: a float32 host scalar tensor for a
    schedule, the float itself otherwise."""
    return lr(step) if callable(lr) else lr


def sgd(lr: Union[float, Schedule]) -> Optimizer:
    """Plain SGD — the paper's Eq. (1.10); lr may be a schedule fn(step)."""

    def init(params):
        return {"step": _step0()}

    def update(grads, state, params):
        step = state["step"]
        eta = _eta(lr, step)
        updates = pytree.tree_map(lambda g: (-eta * g).to(g.dtype), grads)
        return updates, {"step": step + 1}

    return Optimizer(init, update, "sgd")


def momentum_sgd(lr: Union[float, Schedule], beta: float = 0.9, *,
                 moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"step": _step0(),
                "m": pytree.tree_map(
                    lambda p: torch.zeros_like(p, dtype=moment_dtype),
                    params)}

    def update(grads, state, params):
        step = state["step"]
        eta = _eta(lr, step)

        def upd(m, g, p):
            m.mul_(beta).add_(g.to(moment_dtype))
            return (-eta * m).to(p.dtype)

        updates = pytree.tree_map(upd, state["m"], grads, params)
        return updates, {"step": step + 1, "m": state["m"]}

    return Optimizer(init, update, "momentum")


def adamw(lr: Union[float, Schedule], *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=moment_dtype)  # noqa: E731
        return {"step": _step0(), "m": pytree.tree_map(z, params),
                "v": pytree.tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = _eta(lr, step)
        sf = step.float()
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** sf
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** sf

        def upd(m, v, g, p):
            g32 = g.float()
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).add_(g32 * g32, alpha=1 - b2)
            u = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-eta * u).to(p.dtype)

        updates = pytree.tree_map(upd, state["m"], state["v"], grads,
                                  params)
        return updates, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update, "adamw")


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``params + updates``, added into the parameters in place."""
    return pytree.tree_map(lambda p, u: p.add_(u), params, updates)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> tuple[PyTree, torch.Tensor]:
    leaves = pytree.tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return pytree.tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def cosine_schedule(peak_lr: float, *, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1) -> Schedule:
    """Linear warm-up, then a cosine decay to ``floor * peak_lr``."""

    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)

    return lr


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum_sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise KeyError(f"unknown optimizer '{name}'")
