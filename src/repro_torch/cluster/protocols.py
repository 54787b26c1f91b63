"""Protocol registry for the virtual cluster — mirrors ``EXCHANGES``.

Each protocol is a frozen dataclass holding its hyper-parameters (local
period H, gossip matrix, LAQ skip, ...) with two duties:

  * ``schedule(spec, *, rounds=..., horizon=...)`` — run the discrete-
    event loop of ``repro_torch.cluster.scheduler`` and return a ``Trace``;
  * name the replay semantics ``repro_torch.cluster.execute.replay`` dispatches
    on (``Trace.protocol``).

``PROTOCOLS`` / ``make_protocol`` follow the exact conventions of
``repro_torch.core.communicators.EXCHANGES`` / ``make_exchange`` so the two
registries read the same:

    make_protocol("local_sgd", period_h=8).schedule(spec, rounds=20)

``staleness_schedule`` bridges the scheduler back into the algorithm
tier: it converts a measured async trace into the per-worker delay table
a trace-driven ``DelayedExchange(schedule=...)`` replays (Assumption 5
with D(t) taken from the cluster instead of the worst case).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.cluster import scheduler
from repro_torch.cluster.scheduler import ClusterSpec, Trace
from repro_torch.core.registry import Registry, make_factory


@dataclasses.dataclass(frozen=True)
class SyncPS:
    """Synchronous parameter server (§1.3.2): the barrier baseline.

    ``ClusterSpec(allreduce="ring")`` swaps the PS uplink+broadcast for
    the partitioned ring AllReduce (2(N-1) rounds of size/N partition
    messages — the same wire pattern and 2M(N-1)/N per-worker bytes as
    ``CSGDRingExchange``); the protocol semantics (barrier, staleness 0)
    are unchanged, only the comm costing differs.

    ``aggregator`` names the PS aggregation rule from
    ``cluster.aggregators`` (mean / norm_clip / trimmed_mean /
    coordinate_median) — the robust-aggregation knob the Byzantine
    scenarios turn; the replay trains under the named rule."""

    name: str = "sync_ps"
    timeout: Optional[float] = None     # graceful degradation: per-round
    quorum: Optional[int] = None        # deadline + backup-worker quorum
    aggregator: str = "mean"            # robust aggregation rule

    def schedule(self, spec: ClusterSpec, *, rounds: int = 1,
                 horizon: Optional[float] = None,
                 plan: Optional[scheduler.F.FaultPlan] = None) -> Trace:
        del horizon
        return scheduler.schedule_sync_ps(spec, rounds=rounds, plan=plan,
                                          timeout=self.timeout,
                                          quorum=self.quorum,
                                          aggregator=self.aggregator)


@dataclasses.dataclass(frozen=True)
class AsyncPS:
    """Asynchronous parameter server (§4.1): no barrier, real staleness."""

    name: str = "async_ps"

    def schedule(self, spec: ClusterSpec, *, rounds: Optional[int] = None,
                 horizon: Optional[float] = None,
                 plan: Optional[scheduler.F.FaultPlan] = None) -> Trace:
        if horizon is None:
            if rounds is None:
                raise ValueError("async_ps needs horizon= (or rounds= to "
                                 "borrow the sync-PS makespan)")
            # equal-wall-clock convention: run as long as sync-PS would
            # UNDER THE SAME PLAN (faults slow both sides equally)
            horizon = scheduler.schedule_sync_ps(spec, rounds=rounds,
                                                 plan=plan).makespan
        return scheduler.schedule_async_ps(spec, horizon=horizon,
                                           plan=plan)


@dataclasses.dataclass(frozen=True)
class LocalSGD:
    """Local SGD with period H: H local steps between averaging rounds
    (averaging costed as PS or, with ``ClusterSpec(allreduce="ring")``,
    as the partitioned ring AllReduce)."""

    period_h: int = 8
    name: str = "local_sgd"
    timeout: Optional[float] = None
    quorum: Optional[int] = None

    def schedule(self, spec: ClusterSpec, *, rounds: int = 1,
                 horizon: Optional[float] = None,
                 plan: Optional[scheduler.F.FaultPlan] = None) -> Trace:
        del horizon
        return scheduler.schedule_local_sgd(spec, period_h=self.period_h,
                                            rounds=rounds, plan=plan,
                                            timeout=self.timeout,
                                            quorum=self.quorum)


@dataclasses.dataclass(frozen=True)
class Decentralized:
    """DSGD gossip rounds (§5.1) over any ``mixing.py`` matrix.

    ``topology`` in {'ring', 'torus', 'full'} builds the matrix from the
    axis size; an explicit ``w`` (nested tuple / array) wins. The same
    matrix drives both the comm cost (deg(W) sends per round) and the
    replay's mixing step, and matches what ``GossipMix`` lowers to
    ppermutes."""

    topology: str = "ring"
    w: Any = None
    name: str = "dsgd"

    def __post_init__(self):
        if self.w is not None:
            w = np.asarray(self.w, dtype=float)
            object.__setattr__(self, "w",
                               tuple(tuple(row) for row in w.tolist()))

    def matrix(self, n: int) -> np.ndarray:
        from repro_torch.core import mixing

        if self.w is not None:
            w = np.asarray(self.w)
            if w.shape != (n, n):
                raise ValueError(f"W is {w.shape}, cluster has {n} workers")
            return w
        if self.topology == "ring":
            return mixing.ring(n)
        if self.topology == "torus":
            return mixing.torus_2d(*mixing.near_square_factors(n))
        if self.topology == "full":
            return mixing.fully_connected(n)
        raise ValueError(f"unknown topology {self.topology}")

    def schedule(self, spec: ClusterSpec, *, rounds: int = 1,
                 horizon: Optional[float] = None,
                 plan: Optional[scheduler.F.FaultPlan] = None) -> Trace:
        del horizon
        return scheduler.schedule_decentralized(
            spec, rounds=rounds, w=self.matrix(spec.n_workers), plan=plan)


@dataclasses.dataclass(frozen=True)
class CompressedDecentralized(Decentralized):
    """Difference-compressed DSGD (DCD-PSGD): same gossip rounds as
    ``Decentralized`` — deg(W) sends per worker per round — but every
    message is the codec's MEASURED wire bytes of the quantized model
    delta instead of the full fp32 model, and the replay applies the
    ``DCDGossipExchange`` semantics (public copies advanced by decoded
    deltas, bit-identical on every holder)."""

    compressor: str = "rq4"
    name: str = "dcd"

    def schedule(self, spec: ClusterSpec, *, rounds: int = 1,
                 horizon: Optional[float] = None,
                 plan: Optional[scheduler.F.FaultPlan] = None) -> Trace:
        del horizon
        return scheduler.schedule_decentralized(
            spec, rounds=rounds, w=self.matrix(spec.n_workers),
            codec=self.compressor, protocol=self.name, plan=plan)


@dataclasses.dataclass(frozen=True)
class ECDecentralized(CompressedDecentralized):
    """Error-compensated compressed DSGD (the ``ECDGossipExchange``
    semantics): a flat fp32 residual feeds the compression error of each
    broadcast back into the next one, so biased codecs (the default
    1-bit ``sign1``) survive decentralized mixing."""

    compressor: str = "sign1"
    name: str = "ecd"


@dataclasses.dataclass(frozen=True)
class LAQ:
    """Lazily aggregated sync PS: each worker uploads every `skip`-th
    round; the server reuses stored gradients in between."""

    skip: int = 2
    name: str = "laq"
    timeout: Optional[float] = None
    quorum: Optional[int] = None

    def schedule(self, spec: ClusterSpec, *, rounds: int = 1,
                 horizon: Optional[float] = None,
                 plan: Optional[scheduler.F.FaultPlan] = None) -> Trace:
        del horizon
        return scheduler.schedule_laq(spec, rounds=rounds, skip=self.skip,
                                      plan=plan, timeout=self.timeout,
                                      quorum=self.quorum)


PROTOCOLS: Registry = Registry("protocol", {
    "sync_ps": SyncPS,
    "async_ps": AsyncPS,
    "local_sgd": LocalSGD,
    "dsgd": Decentralized,
    "dcd": CompressedDecentralized,
    "ecd": ECDecentralized,
    "laq": LAQ,
})

make_protocol = make_factory(PROTOCOLS)


def staleness_schedule(trace: Trace, *, tau: Optional[int] = None
                       ) -> np.ndarray:
    """Per-worker staleness table for ``DelayedExchange(schedule=...)``.

    Row w holds worker w's measured staleness sequence from the trace,
    clipped to ``tau`` (default: the trace's own max — Assumption 5's
    bound as observed) and padded by repeating its last value so every
    row has equal length T. Feeding this to the algorithm tier replays
    the cluster's delay distribution through a vmapped exchange instead
    of the fixed worst-case FIFO."""
    ups = trace.updates()
    if not ups:
        raise ValueError("trace has no update events")
    bound = trace.max_staleness if tau is None else tau
    rows = []
    t_max = max(len(trace.updates_of(w)) for w in range(trace.n_workers))
    for w in range(trace.n_workers):
        s = [min(e.staleness, bound) for e in trace.updates_of(w)] or [0]
        s = s + [s[-1]] * (t_max - len(s))
        rows.append(s)
    return np.asarray(rows, dtype=int)
