"""Span/event tracer emitting Chrome-trace / Perfetto JSON timelines.

A stdlib copy of ``repro.obs.trace``.

Two clocks, one event stream:

  * **wall spans** (``Tracer.span`` context manager) — host-side phases
    (a replay, a benchmark row, an export) timed on the monotonic clock;
  * **sim spans / instants** (``Tracer.sim_span`` / ``Tracer.instant``)
    — events at explicit *simulated* times, the currency of the cluster
    scheduler: every span carries the worker (``PS = -1`` is the
    server) and a ``lane`` string, and the tracer assigns one Perfetto
    process per worker with one thread per lane, so the exported JSON
    opens as per-worker tracks in https://ui.perfetto.dev.

``timeline_from_trace`` renders a scheduler ``Trace`` post-hoc from its
ledgers alone — deterministically, with an exact accounting contract:

  * ONE complete ('X') span per ``Delivery`` in ``trace.comm``, on the
    worker-side endpoint's track (uplink: sender; downlink: receiver;
    gossip: sender), ``cat = "wire,<direction>,<status>"`` — so
    ok+lost+dup+corrupted wire spans == the wire ledger, mirroring
    ``faults.validate``;
  * ONE instant per ``TraceEvent`` (updates/barriers/rejoins) and per
    fault-ledger record (drops, retries, dups, corruptions, shortfalls,
    epochs, lost compute), plus one 'X' quorum-wait span per ``TimeoutRecord``
    (the late arrival's [cut, arrival] window).

Those counts are asserted by ``repro_torch.obs.export`` at export time
and by tests/test_torch_cluster.py, so a timeline can never silently
disagree with the ledgers it renders. Live scheduler instrumentation
(compute spans) adds rows to the same tracks when tracing is enabled
during scheduling.

Sim seconds are exported as microseconds (ts = t * 1e6); wall spans use
microseconds since the tracer's first event. Zero dependencies beyond
the stdlib.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Optional

from repro_torch.obs import state

PS = -1              # symbolic server id, the cluster scheduler's server
HOST = -2            # the host process (wall-clock spans)

# stable pids: host = 1, server = 10, worker w = 100 + w
_HOST_PID = 1
_PS_PID = 10
_WORKER_PID0 = 100

# lane -> tid, one per track kind; unknown lanes get allocated past these
_LANES = ("compute", "uplink", "downlink", "gossip", "faults", "host")


def _pid(worker: int) -> int:
    if worker == HOST:
        return _HOST_PID
    if worker == PS:
        return _PS_PID
    return _WORKER_PID0 + worker


def _process_name(worker: int) -> str:
    if worker == HOST:
        return "host"
    if worker == PS:
        return "server (PS)"
    return f"worker {worker}"


class Tracer:
    """An append-only event buffer with Chrome-trace export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tracks: dict = {}      # (worker, lane) -> tid
        self._t0_ns: Optional[int] = None

    # -- recording --------------------------------------------------------

    def _tid(self, worker: int, lane: str) -> int:
        key = (worker, lane)
        tid = self._tracks.get(key)
        if tid is None:
            tid = (_LANES.index(lane) if lane in _LANES
                   else len(_LANES) + sum(1 for (_, ln) in self._tracks
                                          if ln not in _LANES))
            self._tracks[key] = tid
        return tid

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def sim_span(self, name: str, *, worker: int, lane: str, t0: float,
                 t1: float, cat: str = "", args: Optional[dict] = None
                 ) -> None:
        """A complete span at explicit simulated times (seconds)."""
        self._append({"name": name, "cat": cat or lane, "ph": "X",
                      "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
                      "pid": _pid(worker), "tid": self._tid(worker, lane),
                      "args": args or {}})

    def instant(self, name: str, *, worker: int, lane: str, t: float,
                cat: str = "", args: Optional[dict] = None) -> None:
        """A zero-duration marker at an explicit simulated time."""
        self._append({"name": name, "cat": cat or lane, "ph": "i",
                      "ts": t * 1e6, "s": "t", "pid": _pid(worker),
                      "tid": self._tid(worker, lane),
                      "args": args or {}})

    def sim_counter(self, name: str, *, worker: int, t: float,
                    values: dict) -> None:
        """A Perfetto counter track sample at a simulated time."""
        self._append({"name": name, "ph": "C", "ts": t * 1e6,
                      "pid": _pid(worker), "args": dict(values)})

    @contextmanager
    def span(self, name: str, *, cat: str = "host",
             args: Optional[dict] = None):
        """Wall-clock span on the host track (monotonic clock); records
        only if tracing is enabled at entry."""
        if not state.enabled("trace"):
            yield
            return
        if self._t0_ns is None:
            self._t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self._append({"name": name, "cat": cat, "ph": "X",
                          "ts": (t0 - self._t0_ns) / 1e3,
                          "dur": (t1 - t0) / 1e3, "pid": _pid(HOST),
                          "tid": self._tid(HOST, "host"),
                          "args": args or {}})

    # -- export -----------------------------------------------------------

    def _metadata(self) -> list[dict]:
        meta = []
        for worker in sorted({w for (w, _) in self._tracks}):
            meta.append({"name": "process_name", "ph": "M",
                         "pid": _pid(worker),
                         "args": {"name": _process_name(worker)}})
        for (worker, lane), tid in sorted(self._tracks.items()):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": _pid(worker), "tid": tid,
                         "args": {"name": lane}})
        return meta

    def to_chrome_trace(self) -> dict:
        """The Perfetto-loadable JSON object (metadata + events)."""
        with self._lock:
            events = list(self._events)
        return {"traceEvents": self._metadata() + events,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
            f.write("\n")
        return path

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._tracks.clear()
            self._t0_ns = None

    @property
    def n_events(self) -> int:
        return len(self._events)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer the instrumentation points write to."""
    return _TRACER


def reset() -> None:
    _TRACER.reset()


@contextmanager
def span(name: str, *, cat: str = "host", args: Optional[dict] = None):
    """Module-level wall-span shorthand: ``with obs.span("replay"):``."""
    with _TRACER.span(name, cat=cat, args=args):
        yield


# ---------------------------------------------------------------------------
# Scheduler Trace -> per-worker timeline
# ---------------------------------------------------------------------------


def _wire_lane_owner(d, ps: int) -> tuple:
    """(lane, owning worker) of one Delivery under the track contract."""
    if d.dst == ps:
        return "uplink", d.src
    if d.src == ps:
        return "downlink", d.dst
    return "gossip", d.src


def timeline_from_trace(cluster_trace, *, into: Optional[Tracer] = None
                        ) -> Tracer:
    """Render a scheduler ``Trace``'s ledgers as per-worker tracks.

    Accounting contract (asserted by ``export.verify_timeline``): one
    'X' wire span per ``trace.comm`` Delivery, one quorum-wait span per
    ``TimeoutRecord``, one instant per ``TraceEvent`` and per remaining
    fault-ledger record. ``into`` appends to an existing tracer (e.g.
    one that captured live compute spans during scheduling).
    """
    tr = into if into is not None else Tracer()
    ps = cluster_trace.n_workers

    for d in cluster_trace.comm:
        lane, owner = _wire_lane_owner(d, ps)
        status = getattr(d, "status", "ok")
        tr.sim_span(d.tag, worker=owner, lane=lane, t0=d.t_start,
                    t1=d.t_end, cat=f"wire,{lane},{status}",
                    args={"src": d.src, "dst": d.dst, "mb": d.size,
                          "status": status})

    for e in cluster_trace.events:
        if e.kind == "update":
            tr.instant("update", worker=e.worker, lane="compute",
                       t=e.t_wall, cat="event,update",
                       args={"step": e.step,
                             "version_pulled": e.version_pulled,
                             "version_applied": e.version_applied,
                             "staleness": e.staleness})
        elif e.kind == "rejoin":
            tr.instant("rejoin", worker=e.worker, lane="faults",
                       t=e.t_wall, cat="event,rejoin",
                       args={"step": e.step})
        else:   # sync / gossip barrier markers live on the server track
            tr.instant(e.kind, worker=PS, lane="compute", t=e.t_wall,
                       cat=f"event,{e.kind}",
                       args={"round": e.step,
                             "version": e.version_applied})

    led = cluster_trace.faults
    if led is not None:
        def wtrack(idx: int) -> int:
            return PS if idx >= ps else idx

        for r in led.drops:
            tr.instant("drop", worker=wtrack(r.src), lane="faults",
                       t=r.t, cat="fault,drop",
                       args={"dst": r.dst, "tag": r.tag,
                             "attempt": r.attempt})
        for r in led.retries:
            tr.instant("retry", worker=wtrack(r.src), lane="faults",
                       t=r.t, cat="fault,retry",
                       args={"dst": r.dst, "tag": r.tag,
                             "attempt": r.attempt})
        for r in led.duplicates:
            tr.instant("dup", worker=wtrack(r.src), lane="faults",
                       t=r.t, cat="fault,dup",
                       args={"dst": r.dst, "tag": r.tag})
        for r in led.corrupt:
            tr.instant("corrupt", worker=wtrack(r.src), lane="faults",
                       t=r.t, cat="fault,corrupt",
                       args={"dst": r.dst, "tag": r.tag,
                             "attempt": r.attempt, "kind": r.kind})
        for r in led.timeouts:
            # the quorum wait the straggler lost: [cut, late arrival]
            tr.sim_span("quorum-late", worker=r.worker, lane="faults",
                        t0=r.t_cut, t1=r.t_arrival, cat="fault,quorum",
                        args={"round": r.round})
        for r in led.shortfalls:
            tr.instant("quorum-shortfall", worker=PS, lane="faults",
                       t=0.0, cat="fault,shortfall",
                       args={"round": r.round, "got": r.n_got,
                             "wanted": r.n_wanted})
        for r in led.epochs:
            tr.instant("membership-epoch", worker=PS, lane="faults",
                       t=r.t, cat="fault,epoch",
                       args={"round": r.round,
                             "alive": list(r.alive),
                             "birkhoff_terms": r.n_birkhoff_terms})
        for r in led.rejoins:
            tr.instant("rejoin-pull", worker=r.worker, lane="faults",
                       t=r.t, cat="fault,rejoin",
                       args={"round": r.round, "donor": r.donor})
        for (w, t) in led.lost_compute:
            tr.instant("lost-compute", worker=w, lane="faults", t=t,
                       cat="fault,lost_compute", args={})
    return tr
