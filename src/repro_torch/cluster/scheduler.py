"""Discrete-event scheduler for a virtual cluster of heterogeneous workers.

This generalizes ``eventsim.async_ps_timeline`` (a closed-form heapq
walk-through of Figure 4.2) into a protocol-pluggable event loop over the
same §1.3 switch model: N workers with per-(worker, step) compute times —
deterministic straggler multipliers x seeded lognormal jitter — exchange
messages whose port occupancy is costed by ``eventsim.simulate`` (round
protocols) or the PS send/recv ports directly (the async loop). Every
protocol emits a ``Trace``:

  * ``events`` — one ``TraceEvent`` per applied gradient
    ``(worker, step, version_pulled, version_applied, staleness, t_wall)``,
    sorted by apply time. ``staleness = version_applied - version_pulled``
    is the paper's D(t) (Assumption 5); sync protocols keep it 0.
  * ``comm`` / ``messages`` — the ``eventsim.Delivery`` and per-wire
    ``eventsim.MsgRecord`` ledgers of every transfer, so scheduler and
    eventsim timings cross-check: the sync-PS makespan with zero compute
    IS ``eventsim.single_ps_makespan`` (same simulate() calls, asserted
    in tests/test_cluster.py to 1e-9).

The trace is pure timing/ordering — no gradients exist here. Feeding it to
``repro_torch.cluster.execute.replay`` turns it into REAL training (vmapped
per-worker replicas, fused flat-codec gradient path) with loss plotted
against this file's simulated wall-clock.

Protocols (see ``repro_torch.cluster.protocols`` for the registry objects):

  sync_ps        rounds of compute -> uplink -> gated broadcast (§1.3.2)
  async_ps       free-running pull/compute/push per worker (§4.1)
  local_sgd      H local steps between averaging rounds (§4/LocalSGD)
  decentralized  gossip rounds over ANY mixing.py matrix W (§5.1); with a
                 codec, the deg(W) per-round sends are sized at the
                 codec's measured wire bytes — the DCD/ECD compressed-
                 delta gossip tier (protocols "dcd"/"ecd")
  laq            sync PS where each worker uploads every `skip`-th round
                 (round-robin lazy aggregation a la LAQ, arXiv 1909.07588;
                 the server reuses the stored gradient in between)
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.obs import flight as obs_flight
from repro_torch.cluster import faults as F
from repro_torch.core import eventsim

PS = -1   # symbolic parameter-server id in TraceEvents (msgs use index n)


# ---------------------------------------------------------------------------
# Telemetry taps (no-ops unless repro_torch.obs is enabled; see obs/state.py)
# ---------------------------------------------------------------------------


def _span_compute(worker: int, step: int, t0: float, t1: float) -> None:
    """Live compute span for the timeline — the one row the wire/fault
    ledgers cannot reconstruct post-hoc. Callers guard on
    ``obs.enabled("trace")`` so the off path stays one dict lookup."""
    obs.tracer().sim_span("compute", worker=worker, lane="compute",
                          t0=t0, t1=t1, cat="sim,compute",
                          args={"step": step})


def _observe_trace(trace: Trace) -> Trace:
    """Metrics/flight tap every ``schedule_*`` return passes through."""
    if obs.enabled("metrics"):
        p = trace.protocol
        obs.counter("cluster.traces", protocol=p).inc()
        obs.gauge("cluster.makespan_s", protocol=p).set(trace.makespan)
        stale = obs.histogram("cluster.staleness", protocol=p)
        n_updates = 0
        for e in trace.events:
            if e.kind == "update":
                n_updates += 1
                stale.observe(e.staleness)
        obs.counter("cluster.updates", protocol=p).inc(n_updates)
        by_status: dict = {}
        mb = 0.0
        for d in trace.comm:
            s = getattr(d, "status", "ok")
            by_status[s] = by_status.get(s, 0) + 1
            mb += d.size
        for s, c in by_status.items():
            obs.counter("cluster.wire_msgs", protocol=p, status=s).inc(c)
        obs.counter("cluster.wire_mb", protocol=p).inc(mb)
        led = trace.faults
        if led is not None:
            for name, v in led.summary().items():
                obs.counter(f"cluster.faults.{name}", protocol=p).inc(v)
    if obs.enabled("flight"):
        obs.flight_record("scheduler.trace", protocol=trace.protocol,
                          n_workers=trace.n_workers,
                          makespan=trace.makespan,
                          n_events=len(trace.events),
                          n_comm=len(trace.comm))
    return trace


# ---------------------------------------------------------------------------
# Cluster description: who computes how fast, what a message costs
# ---------------------------------------------------------------------------


def straggler_multipliers(n: int, *, straggler: Optional[int] = None,
                          factor: float = 4.0) -> tuple:
    """Per-worker speed multipliers: all 1.0 with worker `straggler`
    (default: the last one) `factor`x slower — the Figure 4.1/4.2 setup."""
    m = [1.0] * n
    m[straggler if straggler is not None else n - 1] = factor
    return tuple(m)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """N heterogeneous workers hanging off one §1.3 switch.

    ``multipliers`` is the deterministic straggler model (per-worker slow-
    down of the base ``t_compute``); ``jitter`` adds seeded lognormal
    noise per (worker, step) — ``exp(N(0, jitter))``, median 1 — so
    stragglers can be persistent, stochastic, or both. ``size_mb`` is the
    fp32 gradient/model message; pass ``codec`` to replace it with the
    measured wire size of the packed payload (``Codec.wire_bytes``),
    exactly like the eventsim builders.
    """

    n_workers: int = 8
    t_compute: float = 1.0
    multipliers: tuple = ()        # () -> homogeneous
    jitter: float = 0.0            # lognormal sigma
    t_lat: float = 1e-2
    t_tr: float = 2e-3             # s/MB at the NIC
    size_mb: float = 1.0
    codec: Optional[str] = None    # measured wire size instead of size_mb
    n_messages: int = 1            # wire messages per logical transfer
    allreduce: str = "ps"          # "ps" | "ring" — how sync/local-SGD
                                   # averaging rounds are costed: PS
                                   # uplink+broadcast, or the partitioned
                                   # ring (2(N-1) rounds of size/N chunks,
                                   # matching CSGDRingExchange)
    seed: int = 0

    def __post_init__(self):
        if self.allreduce not in ("ps", "ring"):
            raise ValueError(f"unknown allreduce '{self.allreduce}'; "
                             "have 'ps', 'ring'")

    def multiplier(self, worker: int) -> float:
        if not self.multipliers:
            return 1.0
        return float(self.multipliers[worker])

    def compute_time(self, worker: int, step: int) -> float:
        """Duration of one local gradient computation. Deterministic in
        (seed, worker, step) regardless of event-loop visit order."""
        base = self.t_compute * self.multiplier(worker)
        if self.jitter > 0.0:
            rng = np.random.default_rng((self.seed, worker, step))
            base *= float(rng.lognormal(0.0, self.jitter))
        return base

    def msg_mb(self) -> float:
        """Wire MB of one gradient/model message (codec-measured if set).

        Delegates to eventsim's chunk sizing so scheduler and eventsim
        makespans stay bit-identical (the 1e-9 cross-check)."""
        return eventsim._msg_mb(self.size_mb, 1.0, self.codec)

    def partition_msg_mb(self) -> float:
        """Wire MB of ONE ring partition message (1/n_workers of the
        buffer, codec-measured if set) — the chunk each of the 2(N-1)
        partitioned-AllReduce rounds moves per worker. Same sizing as
        ``eventsim.csgd_ring_makespan``'s, by construction."""
        return eventsim._msg_mb(self.size_mb, 1.0, self.codec,
                                n_chunks=self.n_workers)

    def msg_cost(self) -> float:
        """Port occupancy of one logical transfer."""
        return self.n_messages * self.t_lat + self.msg_mb() * self.t_tr


# ---------------------------------------------------------------------------
# Trace schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One applied gradient (kind='update') or a barrier marker.

    kind:            'update' | 'sync' (averaging barrier) | 'gossip'
                     | 'rejoin' (a worker restarting/joining pulled the
                     current model through the checkpoint wire)
    worker:          worker id (PS = -1 for barrier markers)
    step:            worker-local step index
    version_pulled:  model version the gradient was computed at
    version_applied: model version it was applied to
    staleness:       version_applied - version_pulled (Assumption 5's D(t))
    t_wall:          simulated wall-clock of the apply
    """

    kind: str
    worker: int
    step: int
    version_pulled: int
    version_applied: int
    staleness: int
    t_wall: float


@dataclasses.dataclass(frozen=True)
class Trace:
    protocol: str
    n_workers: int
    events: tuple                  # TraceEvent, sorted by t_wall
    comm: tuple                    # eventsim.Delivery ledger
    messages: tuple                # eventsim.MsgRecord per-wire ledger
    makespan: float
    extras: tuple = ()             # protocol knobs as (name, value) pairs
    faults: Optional[F.FaultLedger] = None   # fault accounting (None:
                                   # scheduled without a FaultPlan)

    def updates(self) -> list:
        return [e for e in self.events if e.kind == "update"]

    @property
    def n_updates(self) -> int:
        return len(self.updates())

    @property
    def max_staleness(self) -> int:
        ups = self.updates()
        return max((e.staleness for e in ups), default=0)

    def updates_of(self, worker: int) -> list:
        return [e for e in self.updates() if e.worker == worker]

    def extra(self, name: str):
        return dict(self.extras)[name]

    def extra_or(self, name: str, default=None):
        return dict(self.extras).get(name, default)


def _sorted_events(events: list) -> tuple:
    return tuple(sorted(events, key=lambda e: (e.t_wall, e.worker, e.step)))


# ---------------------------------------------------------------------------
# Round-synchronous protocols (compute phase + eventsim-costed comm phase)
# ---------------------------------------------------------------------------


def _ring_allreduce_round(spec: ClusterSpec, t0: float,
                          r: int) -> eventsim.SimResult:
    """One bulk-synchronous partitioned ring AllReduce, gated at t0 (the
    slowest worker's compute): 2(n-1) rounds — n-1 reduce-scatter + n-1
    all-gather — each moving ONE size/n partition per worker to its right
    neighbor, the exact wire pattern of ``CSGDRingExchange``. Makespan is
    t0 + 2(n-1)(n_messages*t_lat + chunk*t_tr); the per-wire ledger
    records 2(n-1) sends per worker per iteration."""
    n = spec.n_workers
    chunk = spec.partition_msg_mb()
    msgs = [eventsim.Msg(t0, w, (w + 1) % n, chunk,
                         f"{'reduce' if h < n - 1 else 'gather'}{r}.{h}",
                         spec.n_messages)
            for h in range(2 * (n - 1)) for w in range(n)]
    return eventsim.simulate(msgs, t_lat=spec.t_lat, t_tr=spec.t_tr)


@obs_flight.guarded("scheduler.sync_ps")
def schedule_sync_ps(spec: ClusterSpec, *, rounds: int = 1,
                     plan: Optional[F.FaultPlan] = None,
                     timeout: Optional[float] = None,
                     quorum: Optional[int] = None,
                     aggregator: str = "mean") -> Trace:
    """§1.3.2 synchronous PS: every round is compute -> uplink (serialized
    at the PS recv port) -> broadcast gated on full aggregation.

    With zero compute and one round this is *identical arithmetic* to
    ``eventsim.single_ps_makespan`` (same two simulate() calls), which is
    the scheduler<->eventsim cross-check tests pin to 1e-9.

    ``spec.allreduce == "ring"`` replaces the PS exchange with the
    partitioned ring AllReduce (2(n-1) rounds of size/n chunks, gated on
    the slowest worker — the bulk-synchronous decomposition of
    ``CSGDRingExchange``); with zero compute its makespan equals
    ``eventsim.csgd_ring_makespan`` exactly.

    Graceful degradation (``plan`` / ``timeout`` / ``quorum``): with a
    ``FaultPlan`` the round runs over the live membership (crashed
    workers skip rounds and rejoin through a checkpoint pull; dropped
    uplinks are lost — the broadcast is reliable and retries);
    ``quorum``/``timeout`` turn the barrier into backup-worker
    aggregation — the PS closes each round at the earlier of the
    ``quorum``-th arrival and ``t_round_start + timeout``, discarding
    stragglers (ledgered as timeouts). ``aggregator`` names the robust
    aggregation rule (``cluster.aggregators``) the replay applies at the
    PS — the schedule's timing is rule-independent (every rule reads the
    same contributions), but the choice rides in the trace extras so
    ``execute.replay`` trains under it. Healthy full-barrier arithmetic
    is bit-identical to before when plan/timeout/quorum are None and the
    aggregator is the default mean.
    """
    if (plan is not None or timeout is not None or quorum is not None
            or aggregator != "mean"):
        return _schedule_ps_rounds(spec, rounds=rounds, plan=plan,
                                   timeout=timeout, quorum=quorum,
                                   protocol="sync_ps",
                                   aggregator=aggregator)
    n, ps, s = spec.n_workers, spec.n_workers, spec.msg_mb()
    t = 0.0
    version = 0
    events: list = []
    comm: list = []
    recs: list = []
    for r in range(rounds):
        done = [t + spec.compute_time(w, r) for w in range(n)]
        if obs.enabled("trace"):
            for w in range(n):
                _span_compute(w, r, t, done[w])
        if obs.enabled("metrics"):
            obs.histogram("cluster.straggler_lag_s",
                          protocol="sync_ps").observe(max(done) - min(done))
        if spec.allreduce == "ring":
            res = _ring_allreduce_round(spec, max(done), r)
            comm += list(res.deliveries)
            recs += list(res.messages)
            t = res.makespan if res.deliveries else max(done)
            for w in range(n):
                events.append(TraceEvent("update", w, r, version, version,
                                         0, t))
            version += 1
            events.append(TraceEvent("sync", PS, r, version - 1, version,
                                     0, t))
            continue
        up = eventsim.simulate(
            [eventsim.Msg(done[w], w, ps, s, f"agg{r}", spec.n_messages)
             for w in range(n)], t_lat=spec.t_lat, t_tr=spec.t_tr)
        t_agg = up.makespan
        down = eventsim.simulate(
            [eventsim.Msg(t_agg, ps, w, s, f"bc{r}", spec.n_messages)
             for w in range(n)], t_lat=spec.t_lat, t_tr=spec.t_tr)
        comm += list(up.deliveries) + list(down.deliveries)
        recs += list(up.messages) + list(down.messages)
        for d in up.deliveries:
            events.append(TraceEvent("update", d.src, r, version, version,
                                     0, d.t_end))
        version += 1
        t = down.makespan
        events.append(TraceEvent("sync", PS, r, version - 1, version, 0, t))
    return _observe_trace(Trace(
        "sync_ps", n, _sorted_events(events), tuple(comm), tuple(recs), t,
        (("rounds", rounds), ("allreduce", spec.allreduce))))


@obs_flight.guarded("scheduler.local_sgd")
def schedule_local_sgd(spec: ClusterSpec, *, period_h: int = 8,
                       rounds: int = 1,
                       plan: Optional[F.FaultPlan] = None,
                       timeout: Optional[float] = None,
                       quorum: Optional[int] = None) -> Trace:
    """Local SGD: H local steps per worker between model-averaging rounds
    (the §4 relaxation that trades staleness for H-fold fewer barriers).
    Each local step is an applied update on that worker's replica; the
    averaging round is a PS-pattern exchange of the MODEL —
    or the partitioned ring AllReduce when ``spec.allreduce == "ring"``
    (2(n-1) rounds of size/n chunks, same as schedule_sync_ps).
    ``plan``/``timeout``/``quorum`` follow ``schedule_sync_ps``: live
    workers take their H steps, the averaging round aggregates the first
    K uploads, the broadcast retries, rejoiners pull a checkpoint."""
    if plan is not None or timeout is not None or quorum is not None:
        return _schedule_ps_rounds(spec, rounds=rounds, plan=plan,
                                   timeout=timeout, quorum=quorum,
                                   protocol="local_sgd",
                                   period_h=period_h)
    n, ps, s = spec.n_workers, spec.n_workers, spec.msg_mb()
    t = 0.0
    version = 0
    events: list = []
    comm: list = []
    recs: list = []
    for r in range(rounds):
        done = [t] * n
        for h in range(period_h):
            step = r * period_h + h
            for w in range(n):
                t_h0 = done[w]
                done[w] += spec.compute_time(w, step)
                if obs.enabled("trace"):
                    _span_compute(w, step, t_h0, done[w])
                events.append(TraceEvent("update", w, step, version,
                                         version, 0, done[w]))
        if spec.allreduce == "ring":
            res = _ring_allreduce_round(spec, max(done), r)
            comm += list(res.deliveries)
            recs += list(res.messages)
            t = res.makespan if res.deliveries else max(done)
        else:
            up = eventsim.simulate(
                [eventsim.Msg(done[w], w, ps, s, f"agg{r}",
                              spec.n_messages)
                 for w in range(n)], t_lat=spec.t_lat, t_tr=spec.t_tr)
            down = eventsim.simulate(
                [eventsim.Msg(up.makespan, ps, w, s, f"bc{r}",
                              spec.n_messages)
                 for w in range(n)], t_lat=spec.t_lat, t_tr=spec.t_tr)
            comm += list(up.deliveries) + list(down.deliveries)
            recs += list(up.messages) + list(down.messages)
            t = down.makespan
        version += 1
        events.append(TraceEvent("sync", PS, r, version - 1, version, 0, t))
    return _observe_trace(Trace(
        "local_sgd", n, _sorted_events(events), tuple(comm), tuple(recs),
        t, (("rounds", rounds), ("period_h", period_h),
            ("allreduce", spec.allreduce))))


@obs_flight.guarded("scheduler.decentralized")
def schedule_decentralized(spec: ClusterSpec, *, rounds: int = 1,
                           w: Optional[np.ndarray] = None,
                           codec: Optional[str] = None,
                           protocol: str = "dsgd",
                           plan: Optional[F.FaultPlan] = None) -> Trace:
    """§5.1 DSGD gossip rounds over any mixing matrix W (default: the
    paper's ring W2): each round every worker takes one local step, then
    ships its FULL model to each W-neighbor (deg(W) sends, serialized at
    its send port — O(1) in N for sparse W).

    ``codec`` switches the per-neighbor message from the fp32 model to
    the codec's MEASURED wire bytes — the compressed-delta gossip of
    ``DCDGossipExchange``/``ECDGossipExchange`` (the degree-many sends
    per round are unchanged; only their size shrinks). ``protocol``
    names the replay semantics (``"dcd"``/``"ecd"`` dispatch the
    difference-compressed replays in ``execute.py``).

    Elastic membership (``plan``): every round runs over the live set;
    at each membership epoch the mixing matrix is re-derived —
    ``faults.epoch_matrix`` folds absent workers' mass into the
    survivors' self-weights and re-validates the result through
    ``mixing.birkhoff_decomposition``, so W stays symmetric doubly
    stochastic over whoever is actually present. Plain DSGD tolerates
    message loss (a dropped model just isn't mixed that round — the
    receiver keeps its own weight); DCD/ECD deltas are RELIABLE (a lost
    delta would fork the public replicas, so drops retry with backoff —
    loss becomes latency, not error). Rejoiners pull the model from
    their lowest-id live peer through the compressed-checkpoint wire.
    """
    from repro_torch.core import mixing

    if protocol != "dsgd" and codec is None:
        # a compressed trace must carry the codec its ledger was sized
        # with, or the replay would quantize what the ledger charged fp32
        raise ValueError(f"protocol '{protocol}' needs codec=")
    n = spec.n_workers
    s = (eventsim._msg_mb(spec.size_mb, 1.0, codec) if codec is not None
         else spec.msg_mb())
    w_mat = mixing.ring(n) if w is None else np.asarray(w)
    w_rows = tuple(tuple(row) for row in w_mat.tolist())
    if plan is not None:
        return _schedule_decentralized_faulty(
            spec, rounds=rounds, w_mat=w_mat, w_rows=w_rows, s=s,
            codec=codec, protocol=protocol, plan=plan)
    nbrs = [[j for j in range(n) if j != i and abs(w_mat[j, i]) > 1e-12]
            for i in range(n)]   # i sends to every j weighting x_i
    t = 0.0
    events: list = []
    comm: list = []
    recs: list = []
    for r in range(rounds):
        done = [t + spec.compute_time(i, r) for i in range(n)]
        for i in range(n):
            if obs.enabled("trace"):
                _span_compute(i, r, t, done[i])
            events.append(TraceEvent("update", i, r, r, r, 0, done[i]))
        res = eventsim.simulate(
            [eventsim.Msg(done[i], i, j, s, f"gossip{r}", spec.n_messages)
             for i in range(n) for j in nbrs[i]],
            t_lat=spec.t_lat, t_tr=spec.t_tr)
        comm += list(res.deliveries)
        recs += list(res.messages)
        t = res.makespan
        events.append(TraceEvent("gossip", PS, r, r, r + 1, 0, t))
    # the trace carries W itself (nested tuple) so the replay mixes with
    # exactly the matrix whose comm cost was charged here; compressed
    # protocols also carry the codec their messages were sized with
    return _observe_trace(Trace(
        protocol, n, _sorted_events(events), tuple(comm), tuple(recs), t,
        (("rounds", rounds), ("degree", mixing.degree(w_mat)),
         ("w", w_rows), ("codec", codec))))


def _schedule_decentralized_faulty(spec: ClusterSpec, *, rounds: int,
                                   w_mat: np.ndarray, w_rows: tuple,
                                   s: float, codec: Optional[str],
                                   protocol: str,
                                   plan: F.FaultPlan) -> Trace:
    """Gossip rounds over elastic membership; see schedule_decentralized.

    Extras carry per-round ``present`` (the live mixers — the replay
    re-derives each epoch's W from these with the same
    ``faults.live_mixing_matrix`` that costed it), ``rejoiners`` as
    ``(worker, donor)`` pairs, and — DSGD only — ``dropped_edges``: the
    ``(src, dst)`` gossip messages that were lost, whose weight the
    receiving replay folds back into its self-weight."""
    from repro_torch.core import mixing

    n = spec.n_workers
    reliable = protocol in ("dcd", "ecd")
    led = F._LedgerBuilder()
    t = 0.0
    events: list = []
    comm: list = []
    recs: list = []
    present_rounds: list = []
    rejoin_rounds: list = []
    dropped_rounds: list = []
    has_state = set(plan.alive_at(0.0))
    prev_present: Optional[tuple] = None
    w_live = w_mat
    for r in range(rounds):
        t_start = t
        up_now = [w for w in range(n) if plan.is_up(w, t_start)]
        for w in range(n):
            if w not in up_now:
                has_state.discard(w)
        # -- rejoiners pull a compressed checkpoint from a live peer;
        # a pull whose per-array CRC fails on arrival (plan.
        # bad_checkpoint) is ledgered as a checksum CorruptRecord and
        # re-fetched from the NEXT donor (tag suffix ``.d<i>``) — the
        # last live donor's copy is taken as-is (no one else to ask)
        rejoiners = sorted(w for w in up_now if w not in has_state)
        t_ready = {w: t_start for w in up_now}
        rejoin_pairs = []
        ck_msgs = []
        bad_msgs = []
        bad_status: dict = {}
        ck_tag: dict = {}
        for w in rejoiners:
            donors = sorted(x for x in up_now
                            if x != w and x in has_state)
            if not donors:
                rejoin_pairs.append((w, PS))
                continue
            t_req = t_start
            for di, donor in enumerate(donors):
                tag = (f"ckpt{r}.{w}" if di == 0
                       else f"ckpt{r}.{w}.d{di}")
                if (di < len(donors) - 1
                        and plan.bad_checkpoint(donor, w, r)):
                    bad_msgs.append(eventsim.Msg(
                        t_req, donor, w, spec.msg_mb(), tag,
                        spec.n_messages))
                    bad_status[(donor, w, tag)] = "corrupted"
                    led.corrupt.append(F.CorruptRecord(
                        t_req, donor, w, spec.msg_mb(), tag, di,
                        "checksum"))
                    t_req += spec.msg_cost() + plan.retry_wait(di + 1)
                    continue
                rejoin_pairs.append((w, donor))
                ck_msgs.append(eventsim.Msg(t_req, donor, w,
                                            spec.msg_mb(), tag,
                                            spec.n_messages))
                ck_tag[w] = (donor, tag)
                break
        if ck_msgs or bad_msgs:
            wire, statuses, delivered = F.inject(
                ck_msgs, plan, led, reliable=True,
                est_cost=spec.msg_cost())
            wire += bad_msgs
            statuses.update(bad_status)
            res = eventsim.simulate(wire, t_lat=spec.t_lat,
                                    t_tr=spec.t_tr, statuses=statuses)
            comm += list(res.deliveries)
            recs += list(res.messages)
            ends = {(d.src, d.dst, d.tag): d.t_end
                    for d in res.deliveries}
            for w, (donor, tag) in ck_tag.items():
                t_ready[w] = ends[(donor, w,
                                   delivered[(donor, w, tag)])]
        for (w, donor) in rejoin_pairs:
            led.rejoins.append(F.RejoinRecord(t_ready[w], w, r, donor))
            events.append(TraceEvent("rejoin", w, r, r, r, 0,
                                     t_ready[w]))
            has_state.add(w)
        # -- compute (a crash inside the span kills the round's work)
        participants = []
        done = {}
        for w in up_now:
            d = t_ready[w] + spec.compute_time(w, r)
            if plan.down_in(w, t_ready[w], d):
                led.lost_compute.append((w, t_ready[w]))
                has_state.discard(w)
                continue
            if obs.enabled("trace"):
                _span_compute(w, r, t_ready[w], d)
            participants.append(w)
            done[w] = d
        # -- membership epoch: re-derive + re-validate W over the live set
        if prev_present is None or tuple(participants) != prev_present:
            w_live, n_terms = F.epoch_matrix(w_mat, participants)
            led.epochs.append(F.EpochRecord(t_start, r,
                                            tuple(participants),
                                            n_terms))
        prev_present = tuple(participants)
        for w in participants:
            events.append(TraceEvent("update", w, r, r, r, 0, done[w]))
        # -- gossip over the epoch matrix's support
        gossip = [eventsim.Msg(done[i], i, j, s, f"gossip{r}",
                               spec.n_messages)
                  for i in participants for j in participants
                  if j != i and abs(w_live[j, i]) > 1e-12]
        _, arrival = _simulate_injected(spec, gossip, plan, led,
                                        reliable=reliable, comm=comm,
                                        recs=recs)
        dropped = tuple((m.src, m.dst) for m in gossip
                        if (m.src, m.dst, m.tag) not in arrival)
        t = max([t_start] + [done[w] for w in participants]
                + list(arrival.values()))
        events.append(TraceEvent("gossip", PS, r, r, r + 1, 0, t))
        present_rounds.append(tuple(participants))
        rejoin_rounds.append(tuple(rejoin_pairs))
        dropped_rounds.append(dropped)
    return _observe_trace(Trace(
        protocol, n, _sorted_events(events), tuple(comm), tuple(recs), t,
        (("rounds", rounds), ("degree", mixing.degree(w_mat)),
         ("w", w_rows), ("codec", codec),
         ("present", tuple(present_rounds)),
         ("rejoiners", tuple(rejoin_rounds)),
         ("dropped_edges", tuple(dropped_rounds))),
        led.freeze()))


@obs_flight.guarded("scheduler.laq")
def schedule_laq(spec: ClusterSpec, *, rounds: int = 1, skip: int = 2,
                 plan: Optional[F.FaultPlan] = None,
                 timeout: Optional[float] = None,
                 quorum: Optional[int] = None) -> Trace:
    """LAQ-style lazy aggregation (arXiv 1909.07588), deterministic
    round-robin variant: worker w uploads only on rounds where
    ``(r - w) % skip == 0``; in between the server reuses w's stored
    gradient (the replay does exactly that). The broadcast still reaches
    everyone, so versions advance every round but the uplink carries
    ~n/skip messages instead of n. The gradient-norm trigger of real LAQ
    needs the training loop (execute.py) — the scheduler models its
    communication-thinning effect.

    Under a ``plan``, a dropped upload IS the LAQ relaxation: the server
    simply keeps serving that worker's stored gradient one ``skip``
    cycle longer (no retry on the uplink; the broadcast retries)."""
    if plan is not None or timeout is not None or quorum is not None:
        return _schedule_ps_rounds(spec, rounds=rounds, plan=plan,
                                   timeout=timeout, quorum=quorum,
                                   protocol="laq", laq_skip=skip)
    n, ps, s = spec.n_workers, spec.n_workers, spec.msg_mb()
    t = 0.0
    version = 0
    last_sent = [0] * n
    events: list = []
    comm: list = []
    recs: list = []
    for r in range(rounds):
        senders = [w for w in range(n) if (r - w) % skip == 0]
        done = {w: t + spec.compute_time(w, r) for w in senders}
        if obs.enabled("trace"):
            for w in senders:
                _span_compute(w, r, t, done[w])
        up = eventsim.simulate(
            [eventsim.Msg(done[w], w, ps, s, f"agg{r}", spec.n_messages)
             for w in senders], t_lat=spec.t_lat, t_tr=spec.t_tr)
        t_agg = up.makespan if senders else t
        down = eventsim.simulate(
            [eventsim.Msg(t_agg, ps, w, s, f"bc{r}", spec.n_messages)
             for w in range(n)], t_lat=spec.t_lat, t_tr=spec.t_tr)
        comm += list(up.deliveries) + list(down.deliveries)
        recs += list(up.messages) + list(down.messages)
        for d in up.deliveries:
            w = d.src
            # version_pulled = the version of the gradient the server had
            # been lazily reusing for w; this fresh upload retires it
            # after `staleness` rounds of service
            events.append(TraceEvent("update", w, r, last_sent[w], version,
                                     version - last_sent[w], d.t_end))
            last_sent[w] = version
        version += 1
        t = down.makespan
        events.append(TraceEvent("sync", PS, r, version - 1, version, 0, t))
    return _observe_trace(Trace(
        "laq", n, _sorted_events(events), tuple(comm), tuple(recs), t,
        (("rounds", rounds), ("skip", skip))))


# ---------------------------------------------------------------------------
# Fault-aware PS rounds (sync_ps / local_sgd / laq under a FaultPlan
# and/or quorum+timeout backup-worker aggregation)
# ---------------------------------------------------------------------------


def _simulate_injected(spec: ClusterSpec, msgs: list, plan, led, *,
                       reliable: bool, comm: list,
                       recs: list) -> tuple:
    """Inject the plan into a logical message batch, simulate the wire,
    append to the trace ledgers, and return ``(result, arrival)`` where
    ``arrival[(src, dst, base_tag)]`` is the t_end of the attempt the
    receiver uses (missing: lost on an unreliable channel)."""
    wire, statuses, delivered = F.inject(msgs, plan, led,
                                         reliable=reliable,
                                         est_cost=spec.msg_cost())
    res = eventsim.simulate(wire, t_lat=spec.t_lat, t_tr=spec.t_tr,
                            statuses=statuses)
    comm += list(res.deliveries)
    recs += list(res.messages)
    ends = {(d.src, d.dst, d.tag): d.t_end for d in res.deliveries}
    arrival = {key: ends[(key[0], key[1], tag)]
               for key, tag in delivered.items()}
    return res, arrival


def _schedule_ps_rounds(spec: ClusterSpec, *, rounds: int,
                        plan: Optional[F.FaultPlan],
                        timeout: Optional[float],
                        quorum: Optional[int], protocol: str,
                        period_h: int = 1,
                        laq_skip: Optional[int] = None,
                        aggregator: str = "mean") -> Trace:
    """PS-pattern rounds (sync_ps / local_sgd / laq) under fault
    injection and/or backup-worker aggregation.

    Per round: rejoiners pull the model through the checkpoint wire
    (reliable), live workers compute (``period_h`` steps; a crash window
    inside the compute span kills the round's work), uploads go over the
    UNRELIABLE uplink (drops are lost and corrupted frames are excluded
    — the quorum absorbs both), the PS closes the round per
    ``faults.collect_quorum`` (a round whose every uplink was excluded
    terminates as a ``QuorumShortfall``, never an empty aggregation),
    and the broadcast goes over the RELIABLE downlink (drops AND
    CRC-failed frames retry with backoff — every surviving member must
    hold the new model). Extras carry the per-round ``present`` /
    ``contributors`` / ``receivers`` / ``rejoiners`` lists the replay
    masks on, plus the ``aggregator`` rule and the plan's ``byzantine``
    roster so ``execute.replay`` trains under the same adversary.
    """
    from repro_torch.cluster import aggregators as _agg

    _agg.aggregator(aggregator)     # fail fast on unknown rules
    if spec.allreduce == "ring":
        raise ValueError(
            "fault injection / quorum rounds use PS costing; the bulk-"
            "synchronous ring AllReduce has no straggler-drop semantics "
            "(use allreduce='ps')")
    n, ps, s = spec.n_workers, spec.n_workers, spec.msg_mb()
    led = F._LedgerBuilder()
    t = 0.0
    version = 0
    last_sent = [0] * n                 # laq lazy-gradient bookkeeping
    events: list = []
    comm: list = []
    recs: list = []
    present_rounds: list = []
    contrib_rounds: list = []
    receiver_rounds: list = []
    rejoin_rounds: list = []
    # who holds the current model (receives broadcasts without a pull)
    has_state = (set(plan.alive_at(0.0)) if plan is not None
                 else set(range(n)))
    prev_up: Optional[set] = None
    for r in range(rounds):
        t_start = t
        up_now = ([w for w in range(n) if plan.is_up(w, t_start)]
                  if plan is not None else list(range(n)))
        for w in range(n):
            if w not in up_now:
                has_state.discard(w)    # a down worker's state is gone
        if plan is not None and (prev_up is None or set(up_now) != prev_up):
            led.epochs.append(F.EpochRecord(t_start, r, tuple(up_now)))
        prev_up = set(up_now)
        # -- rejoiners: checkpoint pull from the PS (reliable)
        rejoiners = sorted(w for w in up_now if w not in has_state)
        t_ready = {w: t_start for w in up_now}
        if rejoiners:
            ck = [eventsim.Msg(t_start, ps, w, s, f"ckpt{r}.{w}",
                               spec.n_messages) for w in rejoiners]
            _, arrival = _simulate_injected(spec, ck, plan, led,
                                            reliable=True, comm=comm,
                                            recs=recs)
            for w in rejoiners:
                t_ready[w] = arrival[(ps, w, f"ckpt{r}.{w}")]
                led.rejoins.append(F.RejoinRecord(t_ready[w], w, r, PS))
                events.append(TraceEvent("rejoin", w, r, version,
                                         version, 0, t_ready[w]))
                has_state.add(w)
        # -- compute phase (participation = up through the whole span)
        participants: list = []
        step_times: dict = {}
        for w in up_now:
            d = t_ready[w]
            times = []
            for h in range(period_h):
                d += spec.compute_time(w, r * period_h + h)
                times.append(d)
            if plan is not None and plan.down_in(w, t_ready[w], d):
                led.lost_compute.append((w, t_ready[w]))
                has_state.discard(w)    # crashed mid-compute
                continue
            if obs.enabled("trace"):
                t_h0 = t_ready[w]
                for h, t_h1 in enumerate(times):
                    _span_compute(w, r * period_h + h, t_h0, t_h1)
                    t_h0 = t_h1
            participants.append(w)
            step_times[w] = times
        if protocol == "local_sgd":
            for w in participants:
                for h, t_h in enumerate(step_times[w]):
                    events.append(TraceEvent("update", w,
                                             r * period_h + h, version,
                                             version, 0, t_h))
        # -- uplink (unreliable: the quorum absorbs losses)
        senders = (participants if laq_skip is None else
                   [w for w in participants if (r - w) % laq_skip == 0])
        up_msgs = [eventsim.Msg(step_times[w][-1], w, ps, s, f"agg{r}",
                                spec.n_messages) for w in senders]
        _, arrival = _simulate_injected(spec, up_msgs, plan, led,
                                        reliable=False, comm=comm,
                                        recs=recs)
        arrivals = [(arrival[(w, ps, f"agg{r}")], w) for w in senders
                    if (w, ps, f"agg{r}") in arrival]
        t_agg, contribs = F.collect_quorum(
            arrivals, t_start=t_start, timeout=timeout, quorum=quorum,
            ledger=led, round_idx=r, n_expected=len(senders))
        t_agg = max(t_agg, t_start)
        if obs.enabled("metrics") and arrivals:
            # how long the round would have waited past the quorum cut
            obs.histogram("cluster.straggler_lag_s",
                          protocol=protocol).observe(
                              max(t_end for t_end, _ in arrivals) - t_agg)
        by_worker = dict((w, t_end) for t_end, w in arrivals)
        for w in contribs:
            if protocol == "sync_ps":
                events.append(TraceEvent("update", w, r, version,
                                         version, 0, by_worker[w]))
            elif protocol == "laq":
                events.append(TraceEvent("update", w, r, last_sent[w],
                                         version, version - last_sent[w],
                                         by_worker[w]))
                last_sent[w] = version
        # -- broadcast (reliable: surviving members must converge on the
        #    new version; workers that crashed since round start miss it
        #    and will rejoin through the checkpoint wire)
        receivers = [w for w in up_now if w in has_state
                     and (plan is None or plan.is_up(w, t_agg))]
        for w in list(has_state):
            if w not in receivers:
                has_state.discard(w)
        bc = [eventsim.Msg(t_agg, ps, w, s, f"bc{r}", spec.n_messages)
              for w in receivers]
        down, _ = _simulate_injected(spec, bc, plan, led, reliable=True,
                                     comm=comm, recs=recs)
        t = max(t_agg, down.makespan if receivers else t_agg)
        version += 1
        events.append(TraceEvent("sync", PS, r, version - 1, version, 0,
                                 t))
        present_rounds.append(tuple(participants))
        contrib_rounds.append(tuple(contribs))
        receiver_rounds.append(tuple(receivers))
        rejoin_rounds.append(tuple((w, PS) for w in rejoiners))
    extras = [("rounds", rounds), ("allreduce", spec.allreduce),
              ("timeout", timeout), ("quorum", quorum),
              ("aggregator", aggregator),
              ("byzantine", plan.byzantine if plan is not None else ()),
              ("byzantine_scale",
               plan.byzantine_scale if plan is not None else 1.0),
              ("present", tuple(present_rounds)),
              ("contributors", tuple(contrib_rounds)),
              ("receivers", tuple(receiver_rounds)),
              ("rejoiners", tuple(rejoin_rounds))]
    if protocol == "local_sgd":
        extras.append(("period_h", period_h))
    if protocol == "laq":
        extras.append(("skip", laq_skip))
    return _observe_trace(Trace(protocol, n, _sorted_events(events),
                                tuple(comm), tuple(recs), t,
                                tuple(extras), led.freeze()))


# ---------------------------------------------------------------------------
# Asynchronous PS (the free-running §4.1 loop, generalized from
# eventsim.async_ps_timeline to heterogeneous per-step compute times)
# ---------------------------------------------------------------------------


@obs_flight.guarded("scheduler.async_ps")
def schedule_async_ps(spec: ClusterSpec, *, horizon: float,
                      plan: Optional[F.FaultPlan] = None) -> Trace:
    """§4.1 async PS: each worker loops pull -> compute -> push with no
    barrier; pulls serialize at the PS send port, pushes at its recv port.
    Staleness of an update = applied updates since its worker pulled.

    With homogeneous multipliers and zero jitter this reproduces
    ``eventsim.async_ps_timeline`` event for event (asserted in tests) —
    that closed-form walk-through is the special case this loop
    generalizes. Two differences: updates whose APPLY lands past
    `horizon` are dropped (the timeline helper cuts on request time
    only), and a pull whose DELIVERY would land past `horizon` is never
    put on the wire at all — so ``makespan <= horizon`` always holds,
    every recorded delivery completes inside the horizon, and the wire
    ledger counts exactly the messages the timeline kept (asserted at
    the end of this function).

    Faults (``plan``): both PS channels are reliable-with-retry — a
    dropped pull or push chains bounded retries with exponential
    backoff (``plan.max_retries`` / ``plan.backoff``; the final attempt
    always lands so the loop terminates). A worker that crashes
    mid-compute (or while holding an unacknowledged gradient) loses that
    work and, once back up, re-enters the loop with a fresh pull —
    recorded as a rejoin. Permanent departures simply stop looping."""
    n = spec.n_workers
    msg = spec.msg_cost()
    s = spec.msg_mb()
    ps = n
    ps_send_free = 0.0
    ps_recv_free = 0.0
    version = 0
    versions_at_pull = [0] * n
    steps = [0] * n
    events: list = []
    comm: list = []
    recs: list = []
    led = F._LedgerBuilder()

    def record(t0: float, src: int, dst: int, tag: str,
               status: str = "ok") -> None:
        comm.append(eventsim.Delivery(t0, t0 + msg, src, dst, s, tag,
                                      status))
        recs.extend(eventsim.split_msg_records(t0, src, dst, s, tag,
                                               spec.n_messages,
                                               t_lat=spec.t_lat,
                                               t_tr=spec.t_tr))

    # queue entries: (t, seq, kind, worker, t_begin, attempt) —
    # t_begin is the start of the phase that produced this event, so a
    # crash anywhere inside [t_begin, t] is detected at the pop
    q: list = []
    seq = 0
    for i in range(n):
        t0 = 0.0
        if plan is not None and not plan.is_up(i, 0.0):
            t_up = plan.restart_after(i, 0.0)
            if t_up is None or t_up > horizon:
                continue              # never participates
            t0 = t_up
            led.rejoins.append(F.RejoinRecord(t0, i, 0, ps))
            events.append(TraceEvent("rejoin", i, 0, 0, 0, 0, t0))
        q.append((t0, seq, "pull", i, t0, 0))
        seq += 1
    heapq.heapify(q)

    def reschedule_after_crash(w: int, t: float) -> None:
        """Worker w is down (or lost work) at t: re-enter with a fresh
        pull at its next up-time, if any inside the horizon."""
        nonlocal seq
        t_up = plan.restart_after(w, t)
        if t_up is None or t_up > horizon:
            return                    # permanent departure (or too late)
        led.rejoins.append(F.RejoinRecord(t_up, w, steps[w], ps))
        events.append(TraceEvent("rejoin", w, steps[w], version, version,
                                 0, t_up))
        heapq.heappush(q, (t_up, seq, "pull", w, t_up, 0))
        seq += 1

    while q:
        t, _, kind, w, t_begin, attempt = heapq.heappop(q)
        if t > horizon:
            continue
        if plan is not None:
            if kind == "pull" and not plan.is_up(w, t):
                reschedule_after_crash(w, t)
                seq += 1
                continue
            if kind == "push" and (not plan.is_up(w, t)
                                   or plan.down_in(w, t_begin, t)):
                # the gradient computed (or buffered for retry) since
                # t_begin died with the worker
                led.lost_compute.append((w, t_begin))
                reschedule_after_crash(w, t)
                seq += 1
                continue
        if kind == "pull":
            t0 = max(t, ps_send_free)
            if t0 + msg > horizon:    # would never be delivered: the
                continue              # timeline AND the ledger drop it
            base = f"pull{w}.{steps[w]}"
            tag = base if attempt == 0 else f"{base}~a{attempt}"
            ps_send_free = t0 + msg
            lost = (plan is not None and attempt < plan.max_retries
                    and plan.drops_msg(ps, w, base, attempt))
            bad = None
            if plan is not None and not lost and attempt < plan.max_retries:
                if plan.corrupts_msg(ps, w, base, attempt):
                    bad = "bitflip"
                elif plan.poisons_msg(ps, w, base, attempt):
                    bad = "nan"
            record(t0, ps, w, tag,
                   "lost" if lost else ("corrupted" if bad else "ok"))
            if lost:
                led.drops.append(F.DropRecord(t0, ps, w, s, base,
                                              attempt))
                led.retries.append(F.RetryRecord(t0, ps, w, base,
                                                 attempt + 1))
                t_retry = t0 + msg + plan.retry_wait(attempt + 1)
                heapq.heappush(q, (t_retry, seq, "pull", w, t,
                                   attempt + 1))
                seq += 1
                continue
            if bad is not None:
                # arrived in full, failed the worker's integrity check:
                # the reliable pull channel re-requests it
                led.corrupt.append(F.CorruptRecord(t0, ps, w, s, base,
                                                   attempt, bad))
                led.retries.append(F.RetryRecord(t0, ps, w, base,
                                                 attempt + 1))
                t_retry = t0 + msg + plan.retry_wait(attempt + 1)
                heapq.heappush(q, (t_retry, seq, "pull", w, t,
                                   attempt + 1))
                seq += 1
                continue
            if (plan is not None and plan.dups_msg(ps, w, base, attempt)
                    and t0 + 2 * msg <= horizon):
                record(t0 + msg, ps, w, tag + "~dup", "dup")
                ps_send_free = t0 + 2 * msg
                led.duplicates.append(F.DupRecord(t0 + msg, ps, w, base))
            versions_at_pull[w] = version
            t_next = t0 + msg + spec.compute_time(w, steps[w])
            if obs.enabled("trace"):
                _span_compute(w, steps[w], t0 + msg, t_next)
            heapq.heappush(q, (t_next, seq, "push", w, t0 + msg, 0))
        else:
            t0 = max(t, ps_recv_free)
            t_applied = t0 + msg
            if t_applied > horizon:   # would land after the cutoff
                continue
            base = f"push{w}.{steps[w]}"
            tag = base if attempt == 0 else f"{base}~a{attempt}"
            ps_recv_free = t_applied
            lost = (plan is not None and attempt < plan.max_retries
                    and plan.drops_msg(w, ps, base, attempt))
            bad = None
            if plan is not None and not lost and attempt < plan.max_retries:
                if plan.corrupts_msg(w, ps, base, attempt):
                    bad = "bitflip"
                elif plan.poisons_msg(w, ps, base, attempt):
                    bad = "nan"
            record(t0, w, ps, tag,
                   "lost" if lost else ("corrupted" if bad else "ok"))
            if lost:
                led.drops.append(F.DropRecord(t0, w, ps, s, base,
                                              attempt))
                led.retries.append(F.RetryRecord(t0, w, ps, base,
                                                 attempt + 1))
                t_retry = t_applied + plan.retry_wait(attempt + 1)
                # t_begin survives: a crash while the gradient waits to
                # be retransmitted still loses it
                heapq.heappush(q, (t_retry, seq, "push", w, t_begin,
                                   attempt + 1))
                seq += 1
                continue
            if bad is not None:
                # the PS read the bytes, failed the CRC/finite check,
                # and NACKed: the worker retransmits the same gradient
                led.corrupt.append(F.CorruptRecord(t0, w, ps, s, base,
                                                   attempt, bad))
                led.retries.append(F.RetryRecord(t0, w, ps, base,
                                                 attempt + 1))
                t_retry = t_applied + plan.retry_wait(attempt + 1)
                heapq.heappush(q, (t_retry, seq, "push", w, t_begin,
                                   attempt + 1))
                seq += 1
                continue
            if (plan is not None and plan.dups_msg(w, ps, base, attempt)
                    and t_applied + msg <= horizon):
                record(t_applied, w, ps, tag + "~dup", "dup")
                ps_recv_free = t_applied + msg
                led.duplicates.append(F.DupRecord(t_applied, w, ps,
                                                  base))
            events.append(TraceEvent(
                "update", w, steps[w], versions_at_pull[w], version,
                version - versions_at_pull[w], t_applied))
            version += 1
            steps[w] += 1
            heapq.heappush(q, (t_applied, seq, "pull", w, t_applied, 0))
        seq += 1
    # -- ledger/timeline reconciliation (the horizon-cut invariant):
    # every recorded wire message completes inside the horizon, applied
    # updates == delivered pushes, and the per-switch record count
    # matches the deliveries exactly
    assert all(d.t_end <= horizon + 1e-9 for d in comm)
    n_updates = sum(1 for e in events if e.kind == "update")
    n_ok_push = sum(1 for d in comm
                    if d.dst == ps and d.status == "ok")
    assert n_ok_push == n_updates, (n_ok_push, n_updates)
    assert len(recs) == len(comm) * spec.n_messages
    makespan = max((e.t_wall for e in events), default=0.0)
    return _observe_trace(Trace(
        "async_ps", n, _sorted_events(events), tuple(comm), tuple(recs),
        makespan, (("horizon", horizon),),
        led.freeze() if plan is not None else None))
