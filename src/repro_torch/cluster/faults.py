"""Seeded, deterministic fault injection for the virtual cluster.

The paper's systems claim is that first-order methods tolerate imperfect
communication — stale gradients (async PS), lossy payloads (quantization),
partial views (gossip). Until now the cluster only ever simulated
*healthy* workers: static membership, lossless wires. This module is the
failure substrate every scale-out claim runs under:

  * ``FaultPlan`` — a declarative, seeded description of what goes wrong:
    crash/restart windows per worker (``t_up = inf`` is a permanent
    departure), mid-run joins, per-message drop / duplicate / extra-
    delay distributions, and the CORRUPT class: wire bit-flips caught by
    the CRC32 frame, NaN/Inf-poisoned gradients caught by the post-
    decode finite guard, bit-rotted checkpoint pulls, and persistent
    Byzantine workers (sign-flip / scaled / random gradients). Every
    decision is a pure function of ``(seed, stream, src, dst, tag,
    attempt)`` — the same plan yields the same faults regardless of
    event-loop visit order, so traces stay bit-reproducible (asserted in
    tests/test_faults.py).
  * ``FaultLedger`` — the accounting the scheduler emits alongside the
    wire ledger: every dropped wire message, every retry, every
    duplicate, every straggler cut by a quorum/timeout, every membership
    epoch, every rejoin. The invariant (``validate``): the ledger and
    the ``Trace.comm`` delivery statuses agree exactly — a message is
    delivered, lost, or a duplicate, never unaccounted.
  * ``inject`` — the per-message transform round-based protocols apply
    before ``eventsim.simulate``: extra in-network delay shifts the
    request, duplicates add a ``~dup`` twin (delivered but ignored),
    drops either lose the message (unreliable channels: the sync uplink,
    DSGD gossip) or chain deterministic retries with exponential backoff
    (reliable channels: the PS broadcast, DCD/ECD deltas — replicas must
    stay consistent, so loss becomes latency instead of error).
  * ``live_mixing_matrix`` — elastic membership for gossip: the mass a
    live worker would have sent to an absent neighbor returns to its
    self-weight, absent workers become identity rows. The result stays
    symmetric and doubly stochastic over the live set (Assumption 7 on
    the survivors), and is re-derived — and re-validated through
    ``mixing.birkhoff_decomposition`` — at every membership epoch.

Scenario factories (``lossy_network`` / ``crash_restart`` / ``churn``)
name the standard failure benchmarks ``benchmarks/cluster_bench.py``
publishes into ``BENCH_cluster.json``.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.obs import flight as obs_flight
from repro_torch.core import eventsim

INF = float("inf")

# persistent-adversary gradient transforms execute.py applies at replay
BYZANTINE_MODES = frozenset({"sign_flip", "scale", "random"})


# ---------------------------------------------------------------------------
# The plan: what can go wrong, decided deterministically
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule for an ``n_workers`` cluster.

    crashes:  ``(worker, t_down, t_up)`` triples — the worker is absent
              during ``[t_down, t_up)``; ``t_up = inf`` is a permanent
              departure. Work in flight when the window opens is lost.
    joins:    ``(worker, t_join)`` — the worker does not exist before
              ``t_join`` (mid-run scale-up); on arrival it pulls the
              current model through the compressed-checkpoint wire.
    p_drop:   per-wire-message loss probability (the sender still pays
              the send: the bytes went on the wire and vanished).
    p_dup:    probability a delivered message is duplicated (the twin is
              delivered and ignored — at-least-once wires).
    p_corrupt: probability a delivered payload arrives with flipped bits
              — the CRC32 wire frame detects it on receive; reliable
              channels retransmit, the unreliable uplink excludes the
              contribution from the quorum.
    p_poison: probability a payload decodes to NaN/Inf (corruption the
              checksum happened to pass, or a worker emitting garbage) —
              the post-decode finite guard skips-and-ledgers it.
    p_ckpt_corrupt: probability a donor's stored checkpoint fails its
              per-array CRC on arrival — the rejoiner re-fetches from
              the next live donor.
    byzantine: ``(worker, mode)`` pairs of persistently adversarial
              workers, mode one of ``sign_flip`` (sends ``-g``),
              ``scale`` (sends ``byzantine_scale * g``), ``random``
              (sends ``byzantine_scale``-sized noise). Content faults,
              not wire faults: the payload frames verify clean, so only
              a robust aggregation rule defends.
    delay_scale / delay_sigma: extra in-network delay per message,
              ``delay_scale * lognormal(0, delay_sigma)`` seconds.
    max_retries / backoff: reliable-channel retransmit policy — retry
              ``k`` waits ``backoff * 2**(k-1)`` after the failed
              attempt; after ``max_retries`` the transport escalates and
              the final attempt is treated as delivered (the simulation
              must terminate under p_drop = 1).

    Every stochastic decision is drawn from
    ``default_rng((seed, stream, src, dst, crc32(tag), attempt))`` — a
    pure function of the message identity, independent of simulation
    order.
    """

    n_workers: int
    seed: int = 0
    p_drop: float = 0.0
    p_dup: float = 0.0
    delay_scale: float = 0.0
    delay_sigma: float = 0.6
    crashes: tuple = ()
    joins: tuple = ()
    max_retries: int = 3
    backoff: float = 0.05
    p_corrupt: float = 0.0
    p_poison: float = 0.0
    p_ckpt_corrupt: float = 0.0
    byzantine: tuple = ()
    byzantine_scale: float = 8.0

    def __post_init__(self):
        crashes = tuple((int(w), float(a), float(b)) for w, a, b in
                        self.crashes)
        joins = tuple((int(w), float(t)) for w, t in self.joins)
        byz = tuple((int(w), str(m)) for w, m in self.byzantine)
        object.__setattr__(self, "crashes", crashes)
        object.__setattr__(self, "joins", joins)
        object.__setattr__(self, "byzantine", byz)
        for w, a, b in crashes:
            if not 0 <= w < self.n_workers:
                raise ValueError(f"crash names worker {w} of "
                                 f"{self.n_workers}")
            if not b > a:
                raise ValueError(f"crash window [{a}, {b}) is empty")
        for w, t in joins:
            if not 0 <= w < self.n_workers:
                raise ValueError(f"join names worker {w} of "
                                 f"{self.n_workers}")
        for w, mode in byz:
            if not 0 <= w < self.n_workers:
                raise ValueError(f"byzantine names worker {w} of "
                                 f"{self.n_workers}")
            if mode not in BYZANTINE_MODES:
                raise ValueError(f"byzantine mode {mode!r} not in "
                                 f"{sorted(BYZANTINE_MODES)}")

    # -- membership -------------------------------------------------------

    def join_time(self, worker: int) -> float:
        return max((t for w, t in self.joins if w == worker), default=0.0)

    def is_up(self, worker: int, t: float) -> bool:
        if t < self.join_time(worker):
            return False
        return not any(w == worker and a <= t < b
                       for w, a, b in self.crashes)

    def down_in(self, worker: int, t0: float, t1: float) -> bool:
        """True if the worker is absent at any point of ``[t0, t1]`` —
        the participation test: work spanning a crash window is lost."""
        if t0 < self.join_time(worker):
            return True
        return any(w == worker and a <= t1 and t0 < b
                   for w, a, b in self.crashes)

    def restart_after(self, worker: int, t: float) -> Optional[float]:
        """Earliest ``t' >= t`` the worker is up again (None: never)."""
        if math.isinf(t):
            return None
        t_up = max(t, self.join_time(worker))
        for _ in range(len(self.crashes) + 1):
            hit = [b for w, a, b in self.crashes
                   if w == worker and a <= t_up < b]
            if not hit:
                return t_up
            t_up = max(hit)
            if math.isinf(t_up):
                return None
        return t_up

    def alive_at(self, t: float) -> tuple:
        return tuple(w for w in range(self.n_workers) if self.is_up(w, t))

    @property
    def has_message_faults(self) -> bool:
        return (self.p_drop > 0.0 or self.p_dup > 0.0
                or self.delay_scale > 0.0 or self.p_corrupt > 0.0
                or self.p_poison > 0.0)

    # -- per-message decisions -------------------------------------------

    def _rng(self, stream: int, src: int, dst: int, tag: str,
             attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, stream, src + 1, dst + 1,
             zlib.crc32(tag.encode()), attempt))

    def drops_msg(self, src: int, dst: int, tag: str,
                  attempt: int = 0) -> bool:
        if self.p_drop <= 0.0:
            return False
        return bool(self._rng(2, src, dst, tag, attempt).random()
                    < self.p_drop)

    def dups_msg(self, src: int, dst: int, tag: str,
                 attempt: int = 0) -> bool:
        if self.p_dup <= 0.0:
            return False
        return bool(self._rng(3, src, dst, tag, attempt).random()
                    < self.p_dup)

    def extra_delay(self, src: int, dst: int, tag: str) -> float:
        if self.delay_scale <= 0.0:
            return 0.0
        return float(self.delay_scale
                     * self._rng(4, src, dst, tag, 0).lognormal(
                         0.0, self.delay_sigma))

    def retry_wait(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return self.backoff * (2.0 ** (attempt - 1))

    # -- corruption class -------------------------------------------------

    def corrupts_msg(self, src: int, dst: int, tag: str,
                     attempt: int = 0) -> bool:
        """Bit-flip corruption the receiver's CRC32 check detects."""
        if self.p_corrupt <= 0.0:
            return False
        return bool(self._rng(5, src, dst, tag, attempt).random()
                    < self.p_corrupt)

    def poisons_msg(self, src: int, dst: int, tag: str,
                    attempt: int = 0) -> bool:
        """NaN/Inf poisoning the post-decode finite guard detects."""
        if self.p_poison <= 0.0:
            return False
        return bool(self._rng(6, src, dst, tag, attempt).random()
                    < self.p_poison)

    def corrupt_bit(self, src: int, dst: int, tag: str, attempt: int,
                    n_bits: int) -> int:
        """WHICH bit flips in an ``n_bits``-long frame — pure function
        of the message identity, so tests can materialize the exact
        corruption the plan modelled."""
        return int(self._rng(7, src, dst, tag, attempt).integers(
            0, max(n_bits, 1)))

    def bad_checkpoint(self, donor: int, worker: int,
                       round_idx: int) -> bool:
        """The donor's stored checkpoint fails its per-array CRC when it
        lands at the rejoiner (stream 8; ``attempt`` slots the round)."""
        if self.p_ckpt_corrupt <= 0.0:
            return False
        return bool(self._rng(8, donor, worker, "ckptsrc",
                              round_idx).random() < self.p_ckpt_corrupt)

    def byzantine_mode(self, worker: int) -> Optional[str]:
        for w, mode in self.byzantine:
            if w == worker:
                return mode
        return None

    def is_byzantine(self, worker: int) -> bool:
        return self.byzantine_mode(worker) is not None


# ---------------------------------------------------------------------------
# Scenario factories (the named failure benchmarks)
# ---------------------------------------------------------------------------


def lossy_network(n: int, *, p_drop: float = 0.1, p_dup: float = 0.0,
                  delay_scale: float = 0.0, seed: int = 0) -> FaultPlan:
    """Messages vanish (and optionally duplicate / stall) — membership
    is stable. The quantization story's evil twin: bits lost in flight
    instead of rounded away."""
    return FaultPlan(n, seed=seed, p_drop=p_drop, p_dup=p_dup,
                     delay_scale=delay_scale)


def crash_restart(n: int, *, worker: Optional[int] = None, t_down: float,
                  t_up: float, p_drop: float = 0.0,
                  seed: int = 0) -> FaultPlan:
    """One worker (default: worker 0) crashes during ``[t_down, t_up)``
    and rejoins by pulling the model through the compressed-checkpoint
    wire."""
    w = 0 if worker is None else worker
    return FaultPlan(n, seed=seed, p_drop=p_drop,
                     crashes=((w, t_down, t_up),))


def churn(n: int, *, departures: Sequence = (), joins: Sequence = (),
          p_drop: float = 0.0, seed: int = 0) -> FaultPlan:
    """Elastic membership: ``departures`` = (worker, t) permanent
    leaves, ``joins`` = (worker, t) mid-run arrivals."""
    return FaultPlan(n, seed=seed, p_drop=p_drop,
                     crashes=tuple((w, t, INF) for w, t in departures),
                     joins=tuple(joins))


def corrupt_wire(n: int, *, p_corrupt: float = 0.05,
                 p_poison: float = 0.0, p_drop: float = 0.0,
                 seed: int = 0) -> FaultPlan:
    """Bits rot in flight: payloads arrive with flipped bits (CRC-
    detected) and occasionally decode to NaN/Inf (guard-detected) —
    membership is stable."""
    return FaultPlan(n, seed=seed, p_drop=p_drop, p_corrupt=p_corrupt,
                     p_poison=p_poison)


def byzantine_workers(n: int, *, f: int = 2, mode: str = "sign_flip",
                      scale: float = 8.0, p_corrupt: float = 0.0,
                      seed: int = 0) -> FaultPlan:
    """``f`` persistently adversarial workers (the lowest ids — which
    ids is immaterial to the aggregators, and fixing them keeps every
    trace and its replay bit-reproducible). Their wire frames verify
    clean; only a robust aggregation rule defends."""
    if not 0 <= f <= n:
        raise ValueError(f"f={f} byzantine of n={n}")
    return FaultPlan(n, seed=seed, p_corrupt=p_corrupt,
                     byzantine=tuple((w, mode) for w in range(f)),
                     byzantine_scale=scale)


# ---------------------------------------------------------------------------
# The ledger: what actually went wrong
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DropRecord:
    """One wire message lost in flight (attempt 0 = the original)."""

    t: float
    src: int
    dst: int
    size: float
    tag: str
    attempt: int = 0


@dataclasses.dataclass(frozen=True)
class RetryRecord:
    """One retransmit of a reliable-channel message."""

    t: float
    src: int
    dst: int
    tag: str
    attempt: int


@dataclasses.dataclass(frozen=True)
class DupRecord:
    """One delivered-and-ignored duplicate."""

    t: float
    src: int
    dst: int
    tag: str


@dataclasses.dataclass(frozen=True)
class CorruptRecord:
    """One wire message that arrived bad and was detected on receive.

    ``kind``: ``bitflip`` (CRC32 frame mismatch), ``nan`` (frame passed
    but the decode produced non-finite values — the post-decode guard),
    ``checksum`` (a checkpoint pull whose per-array CRC failed). The
    bytes were paid for in full: detection happens after receipt."""

    t: float
    src: int
    dst: int
    size: float
    tag: str
    attempt: int = 0
    kind: str = "bitflip"


@dataclasses.dataclass(frozen=True)
class TimeoutRecord:
    """A contribution that arrived after the round's quorum/timeout cut
    — delivered, then discarded by the server (backup-worker style)."""

    round: int
    worker: int
    t_cut: float
    t_arrival: float


@dataclasses.dataclass(frozen=True)
class QuorumShortfall:
    """A round that closed with fewer contributions than its quorum."""

    round: int
    n_got: int
    n_wanted: int


@dataclasses.dataclass(frozen=True)
class EpochRecord:
    """A membership change: the live set at ``t`` and the size of the
    Birkhoff decomposition of the re-derived mixing matrix (0 for PS
    protocols, which have no W)."""

    t: float
    round: int
    alive: tuple
    n_birkhoff_terms: int = 0


@dataclasses.dataclass(frozen=True)
class RejoinRecord:
    """A worker coming back (restart or mid-run join) and pulling the
    current model through the compressed-checkpoint wire."""

    t: float
    worker: int
    round: int
    donor: int          # who served the checkpoint (PS = -1)


@dataclasses.dataclass(frozen=True)
class FaultLedger:
    """Everything that went wrong, exactly once each."""

    drops: tuple = ()
    retries: tuple = ()
    duplicates: tuple = ()
    timeouts: tuple = ()
    shortfalls: tuple = ()
    epochs: tuple = ()
    rejoins: tuple = ()
    lost_compute: tuple = ()    # (worker, t) — work killed by a crash
    corrupt: tuple = ()         # CorruptRecord — detected-bad payloads

    @property
    def n_dropped(self) -> int:
        return len(self.drops)

    @property
    def n_retried(self) -> int:
        return len(self.retries)

    @property
    def n_duplicated(self) -> int:
        return len(self.duplicates)

    @property
    def n_timed_out(self) -> int:
        return len(self.timeouts)

    @property
    def n_corrupted(self) -> int:
        return len(self.corrupt)

    def summary(self) -> dict:
        return {"dropped": self.n_dropped, "retried": self.n_retried,
                "duplicated": self.n_duplicated,
                "timed_out": self.n_timed_out,
                "shortfalls": len(self.shortfalls),
                "epochs": len(self.epochs),
                "rejoins": len(self.rejoins),
                "lost_compute": len(self.lost_compute),
                "corrupted": self.n_corrupted}


class _LedgerBuilder:
    """Mutable accumulator the scheduler fills, frozen at trace time."""

    def __init__(self):
        self.drops: list = []
        self.retries: list = []
        self.duplicates: list = []
        self.timeouts: list = []
        self.shortfalls: list = []
        self.epochs: list = []
        self.rejoins: list = []
        self.lost_compute: list = []
        self.corrupt: list = []

    def freeze(self) -> FaultLedger:
        return FaultLedger(tuple(self.drops), tuple(self.retries),
                           tuple(self.duplicates), tuple(self.timeouts),
                           tuple(self.shortfalls), tuple(self.epochs),
                           tuple(self.rejoins), tuple(self.lost_compute),
                           tuple(self.corrupt))


# ---------------------------------------------------------------------------
# Per-message injection for round-based protocols
# ---------------------------------------------------------------------------


def inject(msgs: Iterable[eventsim.Msg], plan: Optional[FaultPlan],
           ledger: _LedgerBuilder, *, reliable: bool,
           est_cost: float) -> tuple:
    """Apply the plan to a batch of logical messages.

    Input messages must have unique ``(src, dst, tag)``. Returns
    ``(wire_msgs, statuses, delivered)``:

      wire_msgs   every attempt that goes on the wire (originals, chained
                  retries tagged ``~a<k>``, duplicates tagged ``~dup``) —
                  all of them occupy ports in ``eventsim.simulate``;
      statuses    ``(src, dst, tag) -> 'lost' | 'dup' | 'corrupted'``
                  for simulate();
      delivered   ``(src, dst, base_tag) -> attempt_tag`` of the attempt
                  the receiver actually uses (absent: the message — and
                  on unreliable channels its payload — is gone).

    Reliable channels chain deterministic retries: retry ``k`` is
    requested one estimated transfer (``est_cost``) plus
    ``plan.retry_wait(k)`` after the failed attempt; attempt
    ``max_retries`` always succeeds so the round terminates. Corrupted
    arrivals (CRC mismatch, or NaN/Inf past the decode guard) ride the
    same retry chain — the receiver got the bytes, checked them, and
    asked again; on unreliable channels the contribution is simply
    excluded (the quorum absorbs it, like a drop that cost full
    transfer).
    """
    wire: list = []
    statuses: dict = {}
    delivered: dict = {}
    for m in msgs:
        if plan is None or not plan.has_message_faults:
            wire.append(m)
            delivered[(m.src, m.dst, m.tag)] = m.tag
            continue
        t_req = m.t_req + plan.extra_delay(m.src, m.dst, m.tag)
        attempt = 0
        while True:
            tag = m.tag if attempt == 0 else f"{m.tag}~a{attempt}"
            lost = plan.drops_msg(m.src, m.dst, m.tag, attempt)
            bad = None
            if not lost:
                if plan.corrupts_msg(m.src, m.dst, m.tag, attempt):
                    bad = "bitflip"
                elif plan.poisons_msg(m.src, m.dst, m.tag, attempt):
                    bad = "nan"
            if reliable and attempt >= plan.max_retries:
                lost = False        # transport escalation: must terminate
                bad = None
            wire.append(eventsim.Msg(t_req, m.src, m.dst, m.size, tag,
                                     m.n_messages))
            if lost:
                statuses[(m.src, m.dst, tag)] = "lost"
                ledger.drops.append(DropRecord(t_req, m.src, m.dst,
                                               m.size, m.tag, attempt))
                if obs.enabled("metrics"):
                    obs.counter("faults.dropped_msgs",
                                reliable=reliable).inc()
                    obs.counter("faults.dropped_mb").inc(m.size)
                obs_flight.record("faults.drop", t=t_req, src=m.src,
                                  dst=m.dst, tag=m.tag, attempt=attempt,
                                  reliable=reliable)
                if not reliable:
                    break
                attempt += 1
                ledger.retries.append(RetryRecord(t_req, m.src, m.dst,
                                                  m.tag, attempt))
                t_req = t_req + est_cost + plan.retry_wait(attempt)
                continue
            if bad is not None:
                # the bytes landed in full, then failed the receiver's
                # integrity check (CRC frame or finite guard)
                statuses[(m.src, m.dst, tag)] = "corrupted"
                ledger.corrupt.append(CorruptRecord(t_req, m.src, m.dst,
                                                    m.size, m.tag,
                                                    attempt, bad))
                if obs.enabled("metrics"):
                    obs.counter("faults.corrupted_msgs", kind=bad,
                                reliable=reliable).inc()
                obs_flight.record("faults.corrupt", t=t_req, src=m.src,
                                  dst=m.dst, tag=m.tag, attempt=attempt,
                                  corruption=bad, reliable=reliable)
                if not reliable:
                    break
                attempt += 1
                ledger.retries.append(RetryRecord(t_req, m.src, m.dst,
                                                  m.tag, attempt))
                t_req = t_req + est_cost + plan.retry_wait(attempt)
                continue
            if attempt > 0 and obs.enabled("metrics"):
                obs.counter("faults.retried_msgs").inc(attempt)
            delivered[(m.src, m.dst, m.tag)] = tag
            if plan.dups_msg(m.src, m.dst, m.tag, attempt):
                dtag = tag + "~dup"
                wire.append(eventsim.Msg(t_req, m.src, m.dst, m.size,
                                         dtag, m.n_messages))
                statuses[(m.src, m.dst, dtag)] = "dup"
                ledger.duplicates.append(DupRecord(t_req, m.src, m.dst,
                                                   m.tag))
            break
    return wire, statuses, delivered


def collect_quorum(arrivals: Sequence, *, t_start: float,
                   timeout: Optional[float], quorum: Optional[int],
                   ledger: _LedgerBuilder, round_idx: int,
                   n_expected: int = 0) -> tuple:
    """Backup-worker aggregation: when does the server stop collecting?

    ``arrivals`` is ``[(t_end, worker), ...]`` of DELIVERED uplinks. The
    server closes the round at the earlier of the ``quorum``-th arrival
    and ``t_start + timeout`` (whichever limits are set); with neither
    set — or when fewer than ``quorum`` messages ever arrive — it takes
    everything that does arrive (it cannot wait for bytes that were
    dropped). Returns ``(t_agg, contributors)``; arrivals after the cut
    are recorded as ``TimeoutRecord``s, shortfalls as
    ``QuorumShortfall``.

    ``n_expected`` is how many uplinks were sent this round: when EVERY
    one was lost/corrupted/excluded the round must still close as a
    recorded ``QuorumShortfall`` (the replay carries the previous
    params), never as an aggregation over an empty contributor set —
    even on a full-barrier schedule with no explicit quorum.
    """
    arr = sorted(arrivals)
    deadline = t_start + timeout if timeout is not None else INF
    t_q = arr[quorum - 1][0] if (quorum is not None
                                 and len(arr) >= quorum) else INF
    t_agg = min(t_q, deadline)
    if math.isinf(t_agg):
        t_agg = arr[-1][0] if arr else t_start
    contributors = [w for t_end, w in arr if t_end <= t_agg]
    for t_end, w in arr:
        if t_end > t_agg:
            ledger.timeouts.append(TimeoutRecord(round_idx, w, t_agg,
                                                 t_end))
            if obs.enabled("metrics"):
                obs.counter("faults.quorum_cuts").inc()
                obs.histogram("faults.quorum_wait_s").observe(
                    t_end - t_agg)
            obs_flight.record("faults.quorum_cut", round=round_idx,
                              worker=w, t_cut=t_agg, t_arrival=t_end)
    # an implicit quorum of 1 covers the all-excluded full-barrier edge
    want = quorum if quorum is not None else (1 if n_expected > 0 else 0)
    if len(contributors) < want:
        ledger.shortfalls.append(QuorumShortfall(round_idx,
                                                 len(contributors),
                                                 want))
        if obs.enabled("metrics"):
            obs.counter("faults.quorum_shortfalls").inc()
        obs_flight.record("faults.quorum_shortfall", round=round_idx,
                          got=len(contributors), wanted=want)
    return t_agg, contributors


# ---------------------------------------------------------------------------
# Elastic gossip: W over the live set
# ---------------------------------------------------------------------------


def live_mixing_matrix(w: np.ndarray, alive: Sequence[int]) -> np.ndarray:
    """Restrict a symmetric doubly stochastic W to the live workers.

    The mass a live worker would have exchanged with an absent neighbor
    returns to its self-weight; absent workers become identity rows (a
    frozen replica neither sends nor receives). The result is symmetric
    and doubly stochastic on the FULL index set — Assumption 7 holds on
    the live block, identity on the rest — so the same stacked-worker
    replay shape works across membership epochs.
    """
    w = np.array(w, dtype=float)
    n = w.shape[0]
    mask = np.zeros(n, dtype=bool)
    mask[list(alive)] = True
    live = np.where(np.outer(mask, mask), w, 0.0)
    np.fill_diagonal(live, 0.0)
    live[np.arange(n), np.arange(n)] = 1.0 - live.sum(axis=1)
    return live


def epoch_matrix(w: np.ndarray, alive: Sequence[int]) -> tuple:
    """Re-derive the gossip matrix for a membership epoch and validate
    it through ``mixing.birkhoff_decomposition`` (the exact lowering
    ``GossipMix`` would consume: one ppermute per non-identity term).
    Returns ``(w_live, n_terms)``; raises if the restriction ever left
    the Birkhoff polytope — i.e. the degradation semantics are checked,
    not assumed, at every epoch."""
    from repro_torch.core import mixing

    w_live = live_mixing_matrix(w, alive)
    terms = mixing.birkhoff_decomposition(w_live)
    return w_live, len(terms)


# ---------------------------------------------------------------------------
# Trace <-> ledger cross-validation
# ---------------------------------------------------------------------------


def validate(trace) -> dict:
    """Assert the fault ledger and the wire ledger tell the same story.

    Checks, for any Trace (healthy traces carry an empty ledger story):
      * every ``lost`` delivery in ``trace.comm`` has exactly one
        ``DropRecord`` (same src/dst/base tag), and vice versa;
      * every ``dup`` delivery has exactly one ``DupRecord``;
      * every ``corrupted`` delivery has exactly one ``CorruptRecord``;
      * every ``~a<k>`` retry attempt on the wire has a ``RetryRecord``;
      * ok + lost + dup + corrupted == attempted (nothing unaccounted);
      * every update event lands at or before the makespan.

    Returns the tally so tests/benchmarks can publish it. When the
    flight recorder is enabled, a failed assertion dumps the ring buffer
    (``flight_faults_validate.json``) before re-raising — the forged-
    ledger class of bug leaves its recent history on disk.
    """
    try:
        return _validate(trace)
    except AssertionError as e:
        obs_flight.record("faults.validate_failed", error=str(e),
                          protocol=trace.protocol)
        obs_flight.dump_on_failure("faults.validate",
                                   f"AssertionError: {e}")
        raise


def _validate(trace) -> dict:
    led = trace.faults if trace.faults is not None else FaultLedger()

    def base(tag: str) -> str:
        return tag.split("~", 1)[0]

    lost = [d for d in trace.comm if getattr(d, "status", "ok") == "lost"]
    dups = [d for d in trace.comm if getattr(d, "status", "ok") == "dup"]
    ok = [d for d in trace.comm if getattr(d, "status", "ok") == "ok"]
    corr = [d for d in trace.comm
            if getattr(d, "status", "ok") == "corrupted"]
    retry_wires = [d for d in trace.comm
                   if "~a" in d.tag and getattr(d, "status", "ok") != "dup"]

    lost_keys = sorted((d.src, d.dst, base(d.tag)) for d in lost)
    drop_keys = sorted((r.src, r.dst, r.tag) for r in led.drops)
    assert lost_keys == drop_keys, (
        f"{len(lost_keys)} lost deliveries vs {len(drop_keys)} ledger "
        "drops")

    dup_keys = sorted((d.src, d.dst, base(d.tag)) for d in dups)
    dup_led = sorted((r.src, r.dst, r.tag) for r in led.duplicates)
    assert dup_keys == dup_led, (
        f"{len(dup_keys)} dup deliveries vs {len(dup_led)} ledger dups")

    corr_keys = sorted((d.src, d.dst, base(d.tag)) for d in corr)
    corr_led = sorted((r.src, r.dst, r.tag) for r in led.corrupt)
    assert corr_keys == corr_led, (
        f"{len(corr_keys)} corrupted deliveries vs {len(corr_led)} "
        "ledger corruptions")

    retry_keys = sorted((d.src, d.dst, base(d.tag)) for d in retry_wires)
    retry_led = sorted((r.src, r.dst, r.tag) for r in led.retries)
    assert retry_keys == retry_led, (
        f"{len(retry_keys)} retry wires vs {len(retry_led)} ledger "
        "retries")

    assert (len(ok) + len(lost) + len(dups) + len(corr)
            == len(trace.comm))
    for e in trace.events:
        assert e.t_wall <= trace.makespan + 1e-12

    return {"attempted": len(trace.comm), "delivered": len(ok),
            **led.summary()}
