"""Discrete-event simulator for the paper's simplified communication model (§1.3).

Model (Figure 1.2):
  * all workers hang off one "logical switch" of infinite bandwidth;
  * every message pays a constant switch latency t_lat;
  * a worker sends at most one message at a time, receives at most one at a
    time, and may do one send and one receive concurrently;
  * moving one unit (MB) takes t_tr seconds at the worker NIC.

Semantics used here (documented in README.md — the paper's Figure 1.3 is not
fully specified by its text): a message holds its sender's send-port AND its
receiver's recv-port for the full (t_lat + size * t_tr) duration, and a message
begins only when both ports are free. This reproduces every closed form the
paper states:

  single PS, N workers:            2 N (t_lat + t_tr)          (§1.3.2)
  ring AllReduce, partitioned:     ~2 N t_lat + 2 t_tr         (§1.3.3)
  ring AllReduce, unpartitioned:   2 N (t_lat + t_tr)          (§1.3.3 caveat)
  multi-server PS:                 ~2 N t_lat + 2 t_tr         (§1.3.4)
  decentralized (ring gossip):     2 t_lat + 2 t_tr            (§5.1)
  K-times compression: divides every t_tr term by K, latency unchanged
                                                       (Figures 3.4/3.5)

Compressed-delta gossip (the DCD/ECD tier): pass ``codec=`` to
``decentralized_makespan`` / ``gossip_wire_mb_per_worker`` and each of
the deg(W) per-mix messages is sized at the codec's measured wire bytes
— message COUNT (and hence the t_lat term) is unchanged, exactly the
Figure 3.4/3.5 story carried over to Section 5's pattern.

Message sizes can be taken from the *measured* wire format instead of an
abstract ratio: every pattern builder accepts ``codec='rq4'`` (a name from
repro_torch.core.compression's Codec registry) and then replaces `size` — read
as the uncompressed fp32 message MB — with ``Codec.wire_bytes`` of the
actual packed payload for that element count (including the params header
and the pad-to-lane-granule overhead). The scalar ``compression=K`` knob
remains for the paper's closed-form sweeps.

Per-message accounting: every builder also accepts ``n_messages`` — how
many wire messages one logical exchange step is split into. Each message
pays the fixed t_lat, so a logical transfer costs
``n_messages * t_lat + size * t_tr`` (the bytes are unchanged). This is
exactly the fused-vs-per-leaf codec gap: a gradient pytree shipped leaf
by leaf sets n_messages = L (ring exchange latency ~ 2 N L t_lat), the
fused flat-buffer tier sets n_messages = 1 (~ 2 N t_lat) — the paper's
own argument for why latency, not bandwidth, dominates small messages.

``csgd_ring_makespan`` / ``ring_wire_mb_per_worker`` cost the REAL
CSGDRingExchange: partitioned (default) is the reduce-scatter +
all-gather decomposition — 2(N-1) partition messages per worker, size/N
each, total 2M(N-1)/N wire bytes — vs the monolithic chain's N-1 full-M
hops; both match the exchange's ``message_bytes``/``n_wire_messages``.

Example 1.3.2's "14 vs 9 units" figure reads one unit differently than these
semantics (we get 13 vs 8) but the *saving* — exactly the halved transfer
time, latency untouched — matches; asserted in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Msg:
    """A point-to-point message request.

    n_messages: wire messages this logical transfer is split into
    (back-to-back on the same port pair). Each pays t_lat; the size is
    the TOTAL across them, so duration = n_messages*t_lat + size*t_tr.
    """

    t_req: float          # earliest time the sender wants to start
    src: int
    dst: int
    size: float           # in MB (or any unit consistent with t_tr)
    tag: str = ""
    n_messages: int = 1


@dataclasses.dataclass(frozen=True)
class Delivery:
    """One completed transfer.

    ``status`` makes the ledger self-describing under fault injection
    (``repro_torch.cluster.faults``): 'ok' reached its receiver, 'lost' went
    on the wire and vanished (the ports were still occupied — the
    sender paid), 'dup' is a delivered-and-ignored duplicate. Healthy
    simulations only ever emit 'ok'.
    """

    t_start: float
    t_end: float
    src: int
    dst: int
    size: float
    tag: str = ""
    status: str = "ok"


@dataclasses.dataclass(frozen=True)
class MsgRecord:
    """ONE wire message (a Delivery is n_messages of these, back to back).

    Message ``index`` of a split transfer occupies
    ``[t_start, t_start + t_lat + (size_total/n_messages) * t_tr]`` on the
    port pair — the per-message ledger that external schedulers (the
    ``repro_torch.cluster`` event loop) cross-check their timings against.
    """

    t_start: float
    t_end: float
    src: int
    dst: int
    size: float           # this message's share of the transfer
    tag: str = ""
    index: int = 0        # position within the split transfer
    n_messages: int = 1


@dataclasses.dataclass(frozen=True)
class SimResult:
    deliveries: tuple
    makespan: float           # last completion - 0
    span: float               # last completion - first request
    messages: tuple = ()      # MsgRecord per wire message (per-message view
                              # of `deliveries`; same total occupancy)

    def end_of(self, tag: str) -> float:
        return max(d.t_end for d in self.deliveries if d.tag == tag)

    @property
    def n_wire_messages(self) -> int:
        return len(self.messages)


def split_msg_records(t0: float, src: int, dst: int, size: float, tag: str,
                      n_messages: int, *, t_lat: float,
                      t_tr: float) -> list[MsgRecord]:
    """The per-wire view of one transfer occupying [t0, ...]: k messages
    back to back, each paying t_lat + its share of the transfer time.
    Single source of the MsgRecord contract — used by simulate() and by
    external schedulers (repro_torch.cluster) so the ledgers stay comparable."""
    k = max(n_messages, 1)
    per = t_lat + (size / k) * t_tr
    return [MsgRecord(t0 + i * per, t0 + (i + 1) * per, src, dst, size / k,
                      tag, i, k) for i in range(k)]


def simulate(msgs: Iterable[Msg], *, t_lat: float, t_tr: float,
             statuses: Optional[dict] = None) -> SimResult:
    """Run the switch model over a set of message requests.

    Messages become eligible at t_req (or when their FIFO predecessor on the
    same (src,dst,tag-order) finished, whichever is later — we model simple
    per-request eligibility). Eligible messages start as soon as both the
    sender send-port and receiver recv-port are free; ties break by request
    time then insertion order, which matches the paper's walk-throughs.

    ``statuses`` (fault injection) maps ``(src, dst, tag)`` to a
    ``Delivery.status`` — 'lost' and 'dup' messages still occupy ports
    and appear in the ledgers (the wire carried them), they just never
    reach the protocol.
    """
    msgs = list(msgs)
    n = 0
    for m in msgs:
        n = max(n, m.src + 1, m.dst + 1)
    send_free = [0.0] * n
    recv_free = [0.0] * n
    deliveries: list[Delivery] = []
    records: list[MsgRecord] = []
    # Greedy event loop: repeatedly pick the eligible message that can start
    # earliest (then FIFO). O(k^2) is fine for the sizes we simulate.
    remaining = sorted((m.t_req, i, m) for i, m in enumerate(msgs))
    done: list[bool] = [False] * len(remaining)
    for _ in range(len(remaining)):
        best = None
        best_key = None
        for idx, (t_req, seq, m) in enumerate(remaining):
            if done[idx]:
                continue
            t0 = max(t_req, send_free[m.src], recv_free[m.dst])
            key = (t0, t_req, seq)
            if best_key is None or key < best_key:
                best_key = key
                best = idx
        t_req, seq, m = remaining[best]
        done[best] = True
        t0 = max(t_req, send_free[m.src], recv_free[m.dst])
        dur = m.n_messages * t_lat + m.size * t_tr
        t_end = t0 + dur
        send_free[m.src] = t_end
        recv_free[m.dst] = t_end
        status = (statuses or {}).get((m.src, m.dst, m.tag), "ok")
        deliveries.append(Delivery(t0, t_end, m.src, m.dst, m.size, m.tag,
                                   status))
        records += split_msg_records(t0, m.src, m.dst, m.size, m.tag,
                                     m.n_messages, t_lat=t_lat, t_tr=t_tr)
    makespan = max(d.t_end for d in deliveries) if deliveries else 0.0
    t_first = min(m.t_req for m in msgs) if msgs else 0.0
    return SimResult(tuple(deliveries), makespan, makespan - t_first,
                     tuple(records))


# ---------------------------------------------------------------------------
# Communication-pattern builders (the paper's §1.3 walk-throughs). All return
# the message list for computing/broadcasting S = sum_i w_i of a `size`-MB
# parameter vector across `n` workers.
# ---------------------------------------------------------------------------


def wire_size_mb(codec: str, n_elements: int) -> float:
    """MEASURED wire MB of one message of n_elements fp32 values under
    `codec` (payload + params header of the actual packed arrays)."""
    from repro_torch.core import compression   # lazy: keep eventsim torch-free

    return compression.codec(codec).wire_bytes_for(n_elements) / 1e6


def _msg_mb(size: float, compression: float, codec: Optional[str],
            n_chunks: int = 1) -> float:
    """One chunk's wire MB: `size` MB of fp32 split into n_chunks, shipped
    under `codec` (measured) or divided by the scalar `compression`."""
    if codec is not None:
        n_el = size * 1e6 / 4.0 / n_chunks
        return wire_size_mb(codec, max(1, int(n_el)))
    return size / n_chunks / compression


def single_ps_makespan(n: int, size: float, *, t_lat: float, t_tr: float,
                       compression: float = 1.0,
                       codec: Optional[str] = None,
                       n_messages: int = 1) -> float:
    """Simulated PS makespan with the broadcast gated on aggregation."""
    ps = n
    s = _msg_mb(size, compression, codec)
    up = simulate([Msg(0.0, w, ps, s, "agg", n_messages) for w in range(n)],
                  t_lat=t_lat, t_tr=t_tr)
    t_sum = up.makespan
    down = simulate([Msg(t_sum, ps, w, s, "bc", n_messages)
                     for w in range(n)], t_lat=t_lat, t_tr=t_tr)
    return down.makespan


def ring_allreduce_msgs(n: int, size: float, *, partitioned: bool = True,
                        compression: float = 1.0,
                        codec: Optional[str] = None,
                        n_messages: int = 1) -> list[Msg]:
    """§1.3.3: reduce-scatter + all-gather on a logical ring.

    partitioned=True: model split into n chunks (the paper's key design
    choice); False reproduces the "why do we partition" strawman.
    """
    msgs: list[Msg] = []
    if partitioned:
        chunk = _msg_mb(size, compression, codec, n_chunks=n)
        rounds = 2 * (n - 1)
        for r in range(rounds):
            phase = "reduce" if r < n - 1 else "gather"
            for w in range(n):
                msgs.append(Msg(0.0, w, (w + 1) % n, chunk, f"{phase}{r}",
                                n_messages))
    else:
        chunk = _msg_mb(size, compression, codec)
        # one token circles the ring twice (2(n-1) sequential hops); model as
        # chained requests via tags — simulate() serializes on ports anyway
        for r in range(2 * (n - 1)):
            w = r % n
            msgs.append(Msg(0.0, w, (w + 1) % n, chunk, f"hop{r}",
                            n_messages))
    return msgs


def ring_allreduce_makespan(n: int, size: float, *, t_lat: float, t_tr: float,
                            partitioned: bool = True,
                            compression: float = 1.0,
                            codec: Optional[str] = None,
                            n_messages: int = 1) -> float:
    """Round-synchronous ring AllReduce makespan.

    Each of the 2(n-1) rounds moves one chunk per worker concurrently
    (every worker sends one + receives one, allowed by the model), so a
    round costs n_messages * t_lat + chunk * t_tr — per-leaf codec paths
    set n_messages = leaf count L (latency ~ 2 N L t_lat), the fused
    flat-buffer tier sets 1 (~ 2 N t_lat).
    """
    chunk = _msg_mb(size, compression, codec, n_chunks=n if partitioned else 1)
    return 2 * (n - 1) * (n_messages * t_lat + chunk * t_tr)


def csgd_ring_makespan(n: int, size: float, *, t_lat: float, t_tr: float,
                       partitioned: bool = True, compression: float = 1.0,
                       codec: Optional[str] = None,
                       n_messages: int = 1) -> float:
    """Cost of ONE CSGDRingExchange iteration under the switch model.

    partitioned=True (the exchange's default): reduce-scatter +
    all-gather — 2(n-1) rounds, each moving ONE partition (size/n) per
    worker, so per-worker wire bytes are 2*M*(n-1)/n and the makespan is
    2(n-1)(n_messages*t_lat + (size/n)*t_tr). partitioned=False is the
    monolithic chain: n-1 hops each shipping the FULL buffer (every
    worker builds its own complete nesting, no gather phase) —
    (n-1)(n_messages*t_lat + size*t_tr) with per-worker wire bytes
    (n-1)*M. Codec sizing is measured per message (`wire_size_mb` of a
    partition's / the buffer's element count), matching the exchange's
    `message_bytes` to within one pad granule per partition.
    """
    if partitioned:
        chunk = _msg_mb(size, compression, codec, n_chunks=n)
        return 2 * (n - 1) * (n_messages * t_lat + chunk * t_tr)
    full = _msg_mb(size, compression, codec)
    return (n - 1) * (n_messages * t_lat + full * t_tr)


def ring_wire_mb_per_worker(n: int, size: float, *,
                            partitioned: bool = True,
                            compression: float = 1.0,
                            codec: Optional[str] = None) -> float:
    """Wire MB ONE worker sends per ring AllReduce iteration:
    2(n-1) * size/n partitioned (the bandwidth-optimal 2M(N-1)/N), vs
    (n-1) * size monolithic."""
    if partitioned:
        return 2 * (n - 1) * _msg_mb(size, compression, codec, n_chunks=n)
    return (n - 1) * _msg_mb(size, compression, codec)


def multi_ps_makespan(n: int, size: float, *, t_lat: float, t_tr: float,
                      compression: float = 1.0,
                      codec: Optional[str] = None,
                      n_messages: int = 1) -> float:
    """§1.3.4: every worker hosts 1/n of the model; same cost as ring AR.

    Phase 1: n-1 incoming shards per server, perfectly staggered (Example
    1.3.4) -> (n-1)(n_messages t_lat + chunk t_tr); phase 2 symmetric.
    """
    chunk = _msg_mb(size, compression, codec, n_chunks=n)
    return 2 * (n - 1) * (n_messages * t_lat + chunk * t_tr)


def decentralized_makespan(n: int, size: float, *, t_lat: float, t_tr: float,
                           degree: int = 2, w=None,
                           compression: float = 1.0,
                           codec: Optional[str] = None,
                           n_messages: int = 1) -> float:
    """§5.1: each worker exchanges its FULL model with `degree` neighbors.

    Sends serialize at each worker's send port ->
    degree * (n_messages t_lat + size t_tr), = 2 t_lat + 2 t_tr for the
    ring with one fused message (paper's closed form). Pass a gossip
    matrix ``w`` (any ``mixing.py`` matrix, e.g. ``torus_2d``) to charge
    its actual ``mixing.degree(W)`` instead of the ring's 2 — the torus
    pays 4 sends, W1 pays n-1.
    """
    del n
    if w is not None:
        from repro_torch.core import mixing   # lazy: keep eventsim numpy-free
        degree = mixing.degree(w)
    return degree * (n_messages * t_lat
                     + _msg_mb(size, compression, codec) * t_tr)


def gossip_wire_mb_per_worker(size: float, *, degree: int = 2, w=None,
                              compression: float = 1.0,
                              codec: Optional[str] = None) -> float:
    """Wire MB ONE worker sends per gossip mix: deg(W) full-model
    messages, each at the codec's MEASURED wire size when ``codec`` is
    set — the DCD/ECD compressed-delta tier ships deg(W) quantized
    deltas instead of deg(W) fp32 models (same message count, ~K-fold
    fewer bytes; the decentralized analogue of ``ring_wire_mb_per_worker``)."""
    if w is not None:
        from repro_torch.core import mixing   # lazy: keep eventsim numpy-free
        degree = mixing.degree(w)
    return degree * _msg_mb(size, compression, codec)


def async_ps_timeline(n: int, *, t_compute: Sequence[float], t_lat: float,
                      t_tr: float, size: float, horizon: float) -> list[tuple]:
    """§4.1 single-server async PS timeline.

    Each worker loops: pull model (t_lat + size*t_tr, serialized at PS send
    port), compute (t_compute[w]), push gradient (serialized at PS recv port).
    Returns a list of (worker, t_update_applied, staleness_in_updates) and
    demonstrates Figure 4.2's behavior: no global barrier, staleness grows
    with worker-speed spread.
    """
    import heapq

    msg_cost = t_lat + size * t_tr
    ps_send_free = 0.0
    ps_recv_free = 0.0
    version = 0
    versions_at_pull = [0] * n
    updates: list[tuple] = []   # (worker, t_applied, staleness)
    # event queue: (time, seq, kind, worker); processed in global time order
    # so PS port reservations are FIFO-by-request-time (no future booking).
    q: list[tuple] = [(0.0, i, "pull", i) for i in range(n)]
    heapq.heapify(q)
    seq = n
    while q:
        t, _, kind, w = heapq.heappop(q)
        if t > horizon:
            continue
        if kind == "pull":
            t0 = max(t, ps_send_free)
            ps_send_free = t0 + msg_cost
            versions_at_pull[w] = version
            heapq.heappush(q, (t0 + msg_cost + t_compute[w], seq, "push", w))
        else:  # push
            t0 = max(t, ps_recv_free)
            ps_recv_free = t0 + msg_cost
            t_applied = t0 + msg_cost
            staleness = version - versions_at_pull[w]
            version += 1
            updates.append((w, t_applied, staleness))
            heapq.heappush(q, (t_applied, seq, "pull", w))
        seq += 1
    return sorted(updates, key=lambda u: u[1])


def sync_ps_throughput(n: int, *, t_compute_max: float, t_lat: float,
                       t_tr: float, size: float) -> float:
    """Updates/sec for the synchronous baseline (Figure 4.1): every round =
    max compute + full PS exchange; n gradient updates land per round."""
    round_time = t_compute_max + 2 * n * (t_lat + size * t_tr)
    return n / round_time
