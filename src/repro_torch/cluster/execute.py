"""Replay a scheduler ``Trace`` against REAL training.

The port of ``repro.cluster.execute``. The scheduler decides *when* and
*at what staleness* every gradient lands; this module makes those
gradients real: per-worker replicas compute minibatch gradients (the
§1.1.3 quadratic or the repro-100m LM through
``train.steps.make_loss_fn``), every gradient ships through the fused
flat-buffer codec (``Codec.flat_qdq`` — ONE bucketed message per
transfer, same bits as decode(encode(.)); K1 + K4 on the card), and
updates are applied in trace order at the trace's recorded staleness.
The result is a loss-vs-simulated-wall-clock curve.

JAX maps one worker's step over the worker axis with ``vmap``; here the
model is one flat fp32 buffer in the ``FlatLayout`` of its tree (the
tree the gradient function sees is views of it), the workers are the
rows of an (n, total) buffer, and their gradients a loop over the rows.
The keys are JAX's, so both packages draw the same batches and the same
codec bits:

    worker key  wkey(w, s) = fold_in(fold_in(PRNGKey(seed), w), s)
    codec key   fold_in(wkey(w, s), 7)
    rejoin pull fold_in(wkey(w, r), 999983)

Replay semantics per protocol (dispatch on ``Trace.protocol``):

  sync_ps   one model; per round all N workers' codec'd gradients are
            averaged into one update (or aggregated over the round's
            quorum by the trace's aggregator).
  async_ps  one model + a version history window; update k uses the
            gradient computed at ``params[version_pulled]`` and applies
            it to ``params[version_applied]`` — measured staleness, not
            a worst-case FIFO. Versions that leave the window are freed.
  local_sgd per-worker replicas take H codec'd local steps, then
            average at each sync event.
  dsgd      per-worker replicas take one local step per round, then mix
            X <- W X with the SAME matrix the scheduler costed.
  dcd/ecd   difference-compressed DSGD: per-worker PUBLIC copies x̂ are
            mixed (W X̂), each worker broadcasts the fused-flat-quantized
            delta of its half-step against x̂, and every copy advances by
            the DECODED delta, with the trace's own codec sizing the
            wire. ecd adds the flat fp32 residual (error feedback).
  laq       the server keeps each worker's last uploaded (codec'd)
            gradient; only the trace's senders refresh theirs each round
            — the others are reused stale, the LAQ relaxation.

Where a row's result is discarded (a worker absent from a fault round,
a LAQ worker that does not send), the replay does not compute it: the
result is the same, and every codec call is one the trace charged.
Entry points (the workloads) run on ``cuda`` unless the caller passes
``device="cpu"``; ``replay`` runs where the workload's parameters are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cluster import aggregators, faults
from repro_torch.cluster.scheduler import Trace
from repro_torch.core import compression, prng, pytree
from repro_torch.device import resolve_device

PyTree = Any


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Workload:
    """One trainable problem: initial params, a per-worker minibatch
    gradient (key -> batch is drawn inside), and a deterministic eval
    loss for the curves."""

    name: str
    params0: PyTree
    grad_fn: Callable[[PyTree, torch.Tensor], PyTree]
    eval_loss: Callable[[PyTree], torch.Tensor]


def quadratic_workload(*, n_workers: int = 8, d: int = 32, m: int = 1024,
                       batch: int = 4, noise: float = 0.1,
                       heterogeneity: float = 0.0, seed: int = 0,
                       device=None) -> Workload:
    """The paper's §1.1.3 distributed least-squares testbed."""
    from repro_torch.core import parallel

    prob = parallel.Quadratic.make(
        prng.PRNGKey(seed), m=m, d=d, noise=noise,
        heterogeneity=heterogeneity, n_workers=n_workers,
        device=resolve_device(device))
    return problem_workload(prob, batch=batch)


def problem_workload(prob, *, batch: int = 4) -> Workload:
    """The workload of a given least-squares problem (a
    ``parallel.Quadratic``), on the device its (a, b) lie on: the same
    problem on two devices, or JAX's carried across with
    ``interop.quadratic_from_jax``, gives the same workload."""
    from repro_torch.train.steps import value_and_grad

    device = prob.a.device
    m, d = prob.a.shape

    def grad_fn(params, key):
        idx = prng.randint(key, (batch,), 0, m, device=device)
        return value_and_grad(prob.loss_on, params, idx)[1]

    def eval_loss(params):
        with torch.no_grad():
            return prob.full_loss(params)

    return Workload("quadratic", torch.zeros((d,), device=device), grad_fn,
                    eval_loss)


def lm_workload(*, smoke: bool = True, batch: int = 2, seq: int = 32,
                seed: int = 0, device=None) -> Workload:
    """repro-100m language model (``reduced()`` dims under smoke) through
    the production loss path (train.steps.make_loss_fn); batches are
    synthetic next-token streams drawn from the key. The parameters come
    from the port's own generator (other numbers than JAX's under the
    same seed: carry JAX's across with ``interop.params_from_jax`` and
    ``dataclasses.replace(workload, params0=...)``)."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import steps as train_steps

    device = resolve_device(device)
    cfg = configs.get_config("repro-100m")
    if smoke:
        cfg = cfg.reduced(n_layers=2, d_model=128, vocab=256)
    loss = train_steps.make_loss_fn(cfg)
    params0 = transformer.init(
        cfg, train_steps.init_generator(prng.PRNGKey(seed), device))

    def make_batch(key):
        tokens = prng.randint(key, (batch, seq + 1), 0, cfg.vocab,
                              device=device)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def grad_fn(params, key):
        return train_steps.value_and_grad(loss, params, make_batch(key))[1]

    eval_batch = make_batch(prng.PRNGKey(seed + 1))

    def eval_loss(params):
        with torch.no_grad():
            return loss(params, eval_batch)

    return Workload("repro-100m" + ("-reduced" if smoke else ""),
                    params0, grad_fn, eval_loss)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterRunResult:
    """A loss-vs-simulated-wall-clock curve plus the trace's vitals."""

    protocol: str
    t_wall: np.ndarray          # eval times (simulated seconds)
    losses: np.ndarray          # eval loss at those times
    updates_applied: int
    max_staleness: int
    makespan: float
    n_wire_messages: int

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1])

    def time_to(self, target: float) -> float:
        """First simulated time the eval loss reaches `target` (inf if
        never) — the time-to-loss metric of the cluster benchmark."""
        hit = np.nonzero(self.losses <= target)[0]
        return float(self.t_wall[hit[0]]) if hit.size else float("inf")

    def loss_at(self, t: float) -> float:
        """Eval loss of the last evaluation at simulated time <= ``t``
        (the first recorded loss if none) — the equal-wall-clock
        comparison point the fault acceptance tests use."""
        idx = int(np.searchsorted(self.t_wall, t, side="right")) - 1
        return float(self.losses[max(idx, 0)])


@dataclasses.dataclass(frozen=True)
class _Run:
    """What every protocol's replay shares: the flat model layout, the
    keys, the codec'd gradient and the eval."""

    workload: Workload
    cdc: compression.Codec
    layout: compression.FlatLayout
    root: torch.Tensor
    n: int
    lr: float
    eval_every: int

    @property
    def device(self) -> torch.device:
        return pytree.tree_leaves(self.workload.params0)[0].device

    def x0(self) -> torch.Tensor:
        return self.layout.flatten(self.workload.params0)

    def stacked(self, x: torch.Tensor) -> torch.Tensor:
        """(n, total) rows, each a copy of ``x``."""
        return x.unsqueeze(0).repeat(self.n, 1)

    def wkey(self, worker: int, step: int) -> torch.Tensor:
        return prng.fold_in(prng.fold_in(self.root, worker), step)

    def grad(self, x: torch.Tensor, key) -> torch.Tensor:
        """One worker's flat fp32 gradient at the flat model ``x``."""
        return self.layout.flatten(
            self.workload.grad_fn(self.layout.unflatten(x), key))

    def qgrad(self, x: torch.Tensor, key) -> torch.Tensor:
        """One worker's gradient through the fused flat-codec wire (the
        flattened gradient is this call's own, so K4 may write over
        it)."""
        return self.cdc.flat_qdq(self.grad(x, key), prng.fold_in(key, 7),
                                 donate=True)

    def qgrads(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """All n workers' codec'd gradients at one model -> (n, total)."""
        out = torch.empty((self.n, self.layout.total), dtype=torch.float32,
                          device=x.device)
        for w in range(self.n):
            out[w] = self.qgrad(x, self.wkey(w, step))
        return out

    def qmodel(self, x: torch.Tensor, key) -> torch.Tensor:
        """A model pulled through the compressed-checkpoint wire — the
        payload a crashed replica rejoins with. ``x`` stays live, so K4
        never writes over it."""
        return self.cdc.flat_qdq(x, key)

    def rejoin_key(self, worker: int, rnd: int) -> torch.Tensor:
        return prng.fold_in(self.wkey(worker, rnd), 999983)

    def loss(self, x: torch.Tensor) -> float:
        return float(self.workload.eval_loss(self.layout.unflatten(x)))

    def evals(self, i: int, count: int) -> bool:
        return (i + 1) % self.eval_every == 0 or i == count - 1

    def row_mask(self, workers) -> torch.Tensor:
        m = np.zeros((self.n,), np.float32)
        m[list(workers)] = 1.0
        return torch.from_numpy(m).to(self.device)

    def matrix(self, w) -> torch.Tensor:
        return torch.as_tensor(np.asarray(w), dtype=torch.float32,
                               device=self.device)


def replay(trace: Trace, workload: Workload, *, codec: str = "rq4",
           lr: float = 0.1, eval_every: int = 1, seed: int = 0,
           mixing_w: Optional[np.ndarray] = None) -> ClusterRunResult:
    """Train `workload` exactly as `trace` dictates; see module docstring.

    ``eval_every`` thins the eval cadence (every k applied updates for
    async, every k rounds otherwise). ``mixing_w`` overrides the
    dsgd/dcd/ecd replay matrix (default: the matrix the trace was
    scheduled with — decentralized traces carry W in their extras).
    Note for dcd/ecd traces: the broadcast delta is compressed with the
    TRACE's own codec (the one its wire ledger was sized with), not this
    ``codec`` argument, which only shapes the gradient path of the other
    protocols — keeping the replayed bits consistent with the charged
    bytes."""
    run = _Run(workload, compression.codec(codec),
               compression.FlatLayout.from_tree(workload.params0),
               prng.PRNGKey(seed), trace.n_workers, lr, eval_every)
    replays = {"sync_ps": _replay_sync, "async_ps": _replay_async,
               "local_sgd": _replay_local_sgd, "dsgd": _replay_dsgd,
               "dcd": _replay_dcd, "ecd": _replay_ecd, "laq": _replay_laq}
    if trace.protocol not in replays:
        raise KeyError(f"no replay for protocol '{trace.protocol}'")
    with obs.span(f"replay.{trace.protocol}",
                  args={"workload": workload.name, "codec": codec,
                        "n_workers": run.n}):
        ts, losses = replays[trace.protocol](trace, run, mixing_w=mixing_w)
    if obs.enabled("metrics"):
        p = trace.protocol
        obs.counter("replay.updates", protocol=p).inc(trace.n_updates)
        obs.gauge("replay.final_loss", protocol=p,
                  workload=workload.name).set(float(losses[-1]))
        obs.histogram("replay.eval_loss", protocol=p,
                      workload=workload.name).observe_many(
                          float(v) for v in losses)
    obs.flight_record("replay.done", protocol=trace.protocol,
                      workload=workload.name, codec=codec,
                      final_loss=float(losses[-1]), n_evals=len(losses))
    return ClusterRunResult(trace.protocol, np.asarray(ts),
                            np.asarray(losses, dtype=float),
                            trace.n_updates, trace.max_staleness,
                            trace.makespan, len(trace.messages))


def _sync_times(trace, kinds=("sync", "gossip")):
    return [e.t_wall for e in trace.events if e.kind in kinds]


def _byzantine_transform(byz, bscale, run: _Run):
    """Per-round gradient sabotage for the trace's Byzantine roster:
    ``sign_flip`` rows send ``-g``, ``scale`` rows ``bscale * g``,
    ``random`` rows ``bscale``-sized keyed noise, leaf i of worker w
    drawn under fold_in(key_w, 104729 + i). Returns None when the roster
    is empty, so the honest replay is untouched."""
    if not byz:
        return None
    n = run.n
    sign_m = run.row_mask([w for w, m in byz if m == "sign_flip"])
    scale_m = run.row_mask([w for w, m in byz if m == "scale"])
    rand_rows = [w for w, m in byz if m == "random"]
    fac = 1.0 - 2.0 * sign_m + (bscale - 1.0) * scale_m       # (n,)
    lay = run.layout

    def transform(q_w, step):
        v = q_w * fac.reshape(n, 1)
        for w in rand_rows:
            key = run.wkey(w, step)
            for i, (off, size, shape) in enumerate(zip(
                    lay.offsets, lay.sizes, lay.shapes)):
                v[w, off:off + size] = bscale * prng.normal(
                    prng.fold_in(key, 104729 + i), shape,
                    device=v.device).reshape(-1)
        return v

    return transform


def _replay_sync(trace, run: _Run, *, mixing_w):
    del mixing_w
    rounds = trace.extra("rounds")
    contributors = trace.extra_or("contributors")
    agg_name = trace.extra_or("aggregator", "mean") or "mean"
    byz = tuple(trace.extra_or("byzantine", ()) or ())
    bscale = float(trace.extra_or("byzantine_scale", 1.0) or 1.0)
    agg_fn = aggregators.aggregator(agg_name)
    sabotage = _byzantine_transform(byz, bscale, run)
    # the masked path also serves robust rules / Byzantine rosters on a
    # full barrier (mask = everyone)
    masked = (contributors is not None or agg_name != "mean"
              or sabotage is not None)

    x = run.x0()
    full = run.row_mask(range(run.n))
    ts, losses = [], []
    t_sync = _sync_times(trace)
    for r in range(rounds):
        q_w = run.qgrads(x, r)
        if not masked:
            upd = q_w.mean(0)
        else:
            # graceful degradation: aggregate the quorum's gradients
            # only; an empty round leaves the model untouched (zero
            # update — the scheduler ledgered it as a QuorumShortfall)
            if sabotage is not None:
                q_w = sabotage(q_w, r)
            mask = (run.row_mask(contributors[r])
                    if contributors is not None else full)
            upd = agg_fn(q_w, mask)
        del q_w
        x = x - run.lr * upd
        del upd
        if run.evals(r, rounds):
            ts.append(t_sync[r])
            losses.append(run.loss(x))
    return ts, losses


def _replay_async(trace, run: _Run, *, mixing_w):
    # faults need no special handling here: the scheduler already folded
    # drops/retries/crashes into the update-event sequence (a crashed
    # worker simply contributes no events while down; its rejoin pull is
    # the next version it computes against)
    del mixing_w
    events = trace.updates()
    keep = trace.max_staleness + 2
    x = run.x0()
    hist = {0: x}
    version = 0
    ts, losses = [], []
    for i, e in enumerate(events):
        if e.version_applied != version:
            raise ValueError("trace apply order is inconsistent "
                             f"({e.version_applied} != {version})")
        x = x - run.lr * run.qgrad(hist[e.version_pulled],
                                   run.wkey(e.worker, e.step))
        version += 1
        hist[version] = x
        hist.pop(version - keep, None)
        if run.evals(i, len(events)):
            ts.append(e.t_wall)
            losses.append(run.loss(x))
    return ts, losses


def _local_steps(run: _Run, x_w: torch.Tensor, rows, step: int) -> None:
    """One codec'd SGD step of each listed row, in place (a row's step
    reads only that row)."""
    for w in rows:
        x_w[w] = x_w[w] - run.lr * run.qgrad(x_w[w], run.wkey(w, step))


def _replay_local_sgd(trace, run: _Run, *, mixing_w):
    del mixing_w
    n = run.n
    rounds, h = trace.extra("rounds"), trace.extra("period_h")
    present = trace.extra_or("present")
    ts, losses = [], []
    t_sync = _sync_times(trace)

    if present is None:
        x_w = run.stacked(run.x0())
        for r in range(rounds):
            for k in range(h):
                _local_steps(run, x_w, range(n), r * h + k)
            x_w = run.stacked(x_w.mean(0))
            if run.evals(r, rounds):
                ts.append(t_sync[r])
                losses.append(run.loss(x_w.mean(0)))
        return ts, losses

    # -- fault path: present rows step, the quorum's contributors are
    # averaged into the PS model, receivers adopt it, rejoiners pull it
    # through the compressed-checkpoint wire
    contributors = trace.extra("contributors")
    receivers = trace.extra("receivers")
    rejoiners = trace.extra("rejoiners")
    model = run.x0()        # the PS's broadcast copy
    x_w = run.stacked(model)
    for r in range(rounds):
        for w, _donor in rejoiners[r]:
            x_w[w] = run.qmodel(model, run.rejoin_key(w, r))
        for k in range(h):
            _local_steps(run, x_w, present[r], r * h + k)
        if contributors[r]:
            model = aggregators.mean(x_w, run.row_mask(contributors[r]))
        for w in receivers[r]:
            x_w[w] = model
        if run.evals(r, rounds):
            ts.append(t_sync[r])
            losses.append(run.loss(model))
    return ts, losses


def _replay_dsgd(trace, run: _Run, *, mixing_w):
    n = run.n
    rounds = trace.extra("rounds")
    if mixing_w is None:
        # the matrix the scheduler costed rides in the trace itself
        mixing_w = np.asarray(trace.extra("w"))
    present = trace.extra_or("present")
    x_w = run.stacked(run.x0())
    ts, losses = [], []
    t_sync = _sync_times(trace)

    if present is None:
        w_mat = run.matrix(mixing_w)
        for r in range(rounds):
            _local_steps(run, x_w, range(n), r)
            x_w = w_mat @ x_w       # X <- W X on the worker axis (Eq. 5.2)
            if run.evals(r, rounds):
                ts.append(t_sync[r])
                losses.append(run.loss(x_w.mean(0)))
        return ts, losses

    # -- fault path: each membership epoch re-derives W over the live
    # set (the same matrix the scheduler validated through the Birkhoff
    # decomposition); a lost gossip message returns its weight to the
    # receiver's self-weight (the sender's column just leaks — that send
    # was paid and vanished); rejoiners pull their donor's model through
    # the compressed-checkpoint wire
    rejoiners = trace.extra("rejoiners")
    dropped = trace.extra("dropped_edges")
    base_w = np.asarray(np.asarray(mixing_w), dtype=float)
    for r in range(rounds):
        for w, donor in rejoiners[r]:
            if donor >= 0:
                x_w[w] = run.qmodel(x_w[donor], run.rejoin_key(w, r))
        w_eff = faults.live_mixing_matrix(base_w, present[r])
        for src, dst in dropped[r]:
            w_eff[dst, dst] += w_eff[dst, src]
            w_eff[dst, src] = 0.0
        _local_steps(run, x_w, present[r], r)
        x_w = run.matrix(w_eff) @ x_w
        if run.evals(r, rounds):
            rows = list(present[r]) or list(range(n))
            ts.append(t_sync[r])
            losses.append(run.loss(x_w[rows].mean(0)))
    return ts, losses


def _replay_compressed_decentralized(trace, run: _Run, *, mixing_w, ec):
    """Shared DCD/ECD replay: stacked PUBLIC copies x̂_w advance by the
    decoded quantized delta of each worker's half-step (gradients are NOT
    compressed — only the broadcast delta is, exactly the
    DCD/ECDGossipExchange wire), mixed with the trace's own W and sized
    by the trace's own codec.

    Fault traces: deltas are RELIABLE (the scheduler retried every drop),
    so the only degradation is membership — each epoch mixes with the
    re-derived live matrix, absent workers' public copies freeze, and
    rejoiners pull their donor's x̂ through the compressed-checkpoint
    wire (error-feedback residual reset to zero: the errors it accrued
    before crashing died with it)."""
    n = run.n
    rounds = trace.extra("rounds")
    if mixing_w is None:
        mixing_w = np.asarray(trace.extra("w"))
    cdc = compression.codec(trace.extra("codec"))   # guaranteed by scheduler
    present = trace.extra_or("present")
    rejoiners = trace.extra_or("rejoiners")
    base_w = np.asarray(np.asarray(mixing_w), dtype=float)
    xhat_w = run.stacked(run.x0())
    err_w = torch.zeros_like(xhat_w) if ec else None
    ts, losses = [], []
    t_sync = _sync_times(trace)
    for r in range(rounds):
        if present is None:
            rows, w_mat = range(n), run.matrix(base_w)
        else:
            for w, donor in rejoiners[r]:
                if donor >= 0:
                    xhat_w[w] = cdc.flat_qdq(xhat_w[donor],
                                             run.rejoin_key(w, r))
                    if ec:
                        err_w[w] = 0.0
            rows = present[r]
            w_mat = run.matrix(faults.live_mixing_matrix(base_w, rows))
        # an absent row's gradient and delta are zero (its public copy
        # freezes, its residual stays)
        g_w = torch.zeros_like(xhat_w)
        for w in rows:
            g_w[w] = run.grad(xhat_w[w], run.wkey(w, r))
        v = w_mat @ xhat_w - run.lr * g_w - xhat_w
        del g_w
        if ec:
            v = v + err_w
        q = torch.zeros_like(v)
        for w in rows:
            q[w] = cdc.flat_qdq(v[w], prng.fold_in(run.wkey(w, r), 7))
        xhat_w = xhat_w + q
        if ec:
            for w in rows:
                err_w[w] = v[w] - q[w]
        del v, q
        if run.evals(r, rounds):
            live = list(rows) or list(range(n))
            ts.append(t_sync[r])
            losses.append(run.loss(xhat_w[live].mean(0)))
    return ts, losses


def _replay_dcd(trace, run: _Run, *, mixing_w):
    return _replay_compressed_decentralized(trace, run, mixing_w=mixing_w,
                                            ec=False)


def _replay_ecd(trace, run: _Run, *, mixing_w):
    return _replay_compressed_decentralized(trace, run, mixing_w=mixing_w,
                                            ec=True)


def _replay_laq(trace, run: _Run, *, mixing_w):
    # fault traces need no special handling: the senders-by-round table
    # below is read from the update events, which already carry only the
    # contributions that survived drops/timeouts/crashes
    del mixing_w
    rounds = trace.extra("rounds")
    senders_by_round = np.zeros((rounds, run.n), bool)
    for e in trace.updates():
        senders_by_round[e.step, e.worker] = True
    x = run.x0()
    stored_w = torch.zeros((run.n, run.layout.total), dtype=torch.float32,
                           device=x.device)
    ts, losses = [], []
    t_sync = _sync_times(trace)
    for r in range(rounds):
        # only the trace's senders refresh their stored gradient; the
        # server reuses the rest stale (the LAQ relaxation)
        for w in np.flatnonzero(senders_by_round[r]):
            stored_w[w] = run.qgrad(x, run.wkey(int(w), r))
        x = x - run.lr * stored_w.mean(0)
        if run.evals(r, rounds):
            ts.append(t_sync[r])
            losses.append(run.loss(x))
    return ts, losses
