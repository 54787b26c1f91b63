"""Faults planted in the program's timed path, to show that the check
fails them: a training step that returns its state unchanged, one that
leaves out half of the batch (the mean taken over the rest), a prefill
whose answer is altered where it is made (its prompt's last token
changed), and on the ring a gradient of half the rows, an exchange left
out (each rank steps on its own gradient) or one that returns no
update (the state unchanged)."""
from __future__ import annotations

import contextlib


def _unchanged(make):
    def factory(*a, **kw):
        real = make(*a, **kw)

        def step(state, batch):
            from repro_torch.train import steps
            dev = state["params"]["embed"].device
            _, metrics = real(steps.state_to(state, dev), batch)
            return state, metrics
        return step
    return factory


def _half_batch(make):
    def factory(*a, **kw):
        real = make(*a, **kw)

        def step(state, batch):
            half = batch["tokens"].shape[0] // 2
            return real(state, {k: v[:half] for k, v in batch.items()})
        return step
    return factory


def _token(make):
    def factory(*a, **kw):
        real = make(*a, **kw)

        def prefill(params, batch):
            toks = batch["tokens"].clone()
            toks[:, -1] = (toks[:, -1] + 1) % params["embed"].shape[0]
            return real(params, {**batch, "tokens": toks})
        return prefill
    return factory


def _half_rows(value_and_grad):
    def half(loss_fn, params, batch):
        n = batch["tokens"].shape[0] // 2
        return value_and_grad(loss_fn, params,
                              {k: v[:n] for k, v in batch.items()})
    return half


def _no_exchange(call):
    def local(self, grad, state, key, *, axis_name=None):
        return grad, state
    return local


def _no_update(call):
    def zero(self, grad, state, key, *, axis_name=None):
        from repro_torch.core import pytree
        u, state = call(self, grad, state, key, axis_name=axis_name)
        return pytree.tree_map(lambda x: x * 0, u), state
    return zero


def _steps():
    from repro_torch.train import steps
    return steps


def _ring():
    from repro_torch.core import communicators
    return communicators.CSGDRingExchange


FAULTS = {"unchanged": (_steps, "make_train_step", _unchanged),
          "half_batch": (_steps, "make_train_step", _half_batch),
          "token": (_steps, "make_prefill_step", _token),
          "ring_half_batch": (_steps, "value_and_grad", _half_rows),
          "no_exchange": (_ring, "__call__", _no_exchange),
          "ring_unchanged": (_ring, "__call__", _no_update)}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` in place, for the block."""
    owner, attr, wrap = FAULTS[name]
    target = owner()
    orig = getattr(target, attr)
    setattr(target, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(target, attr, orig)
