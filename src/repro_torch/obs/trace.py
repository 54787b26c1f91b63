"""Span/event tracer emitting Chrome-trace / Perfetto JSON timelines.

A stdlib copy of ``repro.obs.trace``.

Two clocks, one event stream:

  * **spans** (``obs.span`` / ``Tracer.span``) — phases of the program
    (a train step and its phases, a prefill and its blocks, a ring
    exchange and its hops, a kernel call, a replay) on the host's
    Unix-epoch clock (``time.time_ns``), the clock ``torch.profiler``
    stamps its events with;
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

A span records while tracing is on (``REPRO_OBS=trace``,
``obs.enable()``) or while a ``torch.profiler`` runs; otherwise
``span`` returns one shared ``nullcontext`` after one switch lookup and
one call. A recording span opens a ``torch.profiler.record_function``
range of its name (so it is a host range of the profiler's own trace,
around the device work it launches) and keeps a record: name, id, the
enclosing span's id (``parent``, from a per-thread stack: a thread with
no span of its own open, such as autograd's backward thread, nests under
the newest span open on another), the root span's id, host start and end
(``t0_ns``, ``t1_ns``), args and ``stream_ms``: on a card the
``elapsed_time`` of two CUDA events recorded on the current stream at
its start and end (from the stream reaching the span to the stream
finishing its work), on the CPU the host duration. Pending event pairs
are read, and their events reused, when the record is read
(``spans``, ``span_stats``, the export) or once ``MAX_PENDING`` wait.

Sim seconds are exported as microseconds (ts = t * 1e6); spans use
microseconds since the tracer's first span. torch is looked up only
once it is loaded: the module needs nothing beyond the stdlib.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import sys
import threading
import time
from collections import namedtuple
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

MAX_PENDING = 16384  # CUDA event pairs held before the finished are read
_NULL = contextlib.nullcontext()
_profiler_enabled = None   # torch.autograd._profiler_enabled, once loaded

SpanStats = namedtuple("SpanStats", "count host_s stream_s")


def _profiling() -> bool:
    """Is a ``torch.profiler`` running (False while torch is not loaded)?"""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None or not hasattr(torch, "autograd"):
            return False
        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


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
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._stacks: list = []      # every thread's stack of open spans
        self._pending: list = []     # (record, start, end, device)
        self._free: dict = {}        # device -> reusable CUDA events

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

    def recording(self) -> bool:
        """Whether spans record: tracing on or a profiler running."""
        return state.enabled("trace") or _profiling()

    def span(self, name: str, *, cat: str = "host",
             args: Optional[dict] = None):
        """A span of the program (see the module's docstring): records
        while tracing is on or a profiler runs, else a shared
        ``nullcontext``."""
        if not self.recording():
            return _NULL
        return _Span(self, name, cat, args)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            with self._lock:
                self._stacks.append(st)
        return st

    def _newest_open(self) -> Optional[dict]:
        """The newest span open on any thread."""
        best = None
        for st in list(self._stacks):
            try:
                top = st[-1]
            except IndexError:
                continue
            if best is None or top["id"] > best["id"]:
                best = top
        return best

    def _event(self, torch, dev: int):
        free = self._free.get(dev)
        if free:
            return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def _resolve(self, wait: bool) -> None:
        """Read the stream times of the pending event pairs, in order,
        and keep their events for reuse; without ``wait`` stop at the
        first pair the device has not finished."""
        with self._lock:
            pending, self._pending = self._pending, []
        for k, (rec, start, end, dev) in enumerate(pending):
            if wait:
                end.synchronize()
            elif not end.query():
                with self._lock:
                    self._pending[:0] = pending[k:]
                return
            rec["stream_ms"] = start.elapsed_time(end)
            self._free.setdefault(dev, []).extend((start, end))

    def spans(self) -> list[dict]:
        """The spans recorded, each with its stream time (pending device
        times are waited for)."""
        self._resolve(wait=True)
        with self._lock:
            return [e for e in self._events if "t0_ns" in e]

    def span_stats(self, name: str, under: Optional[str] = None
                   ) -> SpanStats:
        """(count, host seconds, stream seconds) summed over the spans
        named ``name``; with ``under``, only those inside a span of that
        name (at any depth)."""
        spans = self.spans()
        by_id = {e["id"]: e for e in spans}

        def inside(e):
            p = by_id.get(e["parent"])
            while p is not None:
                if p["name"] == under:
                    return True
                p = by_id.get(p["parent"])
            return False

        mine = [e for e in spans if e["name"] == name
                and (under is None or inside(e))]
        return SpanStats(len(mine),
                         sum(e["t1_ns"] - e["t0_ns"] for e in mine) * 1e-9,
                         sum(e["stream_ms"] for e in mine) * 1e-3)

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
        self._resolve(wait=True)
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
        self._resolve(wait=True)
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


class _Span:
    """A recording span: a profiler range of its name, its record, and on
    a card a pair of timing events on the current stream."""

    __slots__ = ("_tr", "_rec", "_range", "_start", "_dev", "_torch")

    def __init__(self, tr: Tracer, name: str, cat: str,
                 args: Optional[dict]):
        self._tr = tr
        self._rec = {"name": name, "cat": cat, "ph": "X",
                     "args": args or {}}

    def __enter__(self):
        tr, rec = self._tr, self._rec
        stack = tr._stack()
        parent = stack[-1] if stack else tr._newest_open()
        rec["id"] = next(tr._ids)
        rec["parent"] = parent["id"] if parent else None
        rec["root"] = parent["root"] if parent else rec["id"]
        rec["t0_ns"] = time.time_ns()
        stack.append(rec)
        self._torch = torch = sys.modules.get("torch")
        self._range = self._start = None
        if torch is not None:
            self._range = torch.profiler.record_function(rec["name"])
            self._range.__enter__()
            if torch.cuda.is_initialized():
                self._dev = torch.cuda.current_device()
                self._start = tr._event(torch, self._dev)
                self._start.record()
        return self

    def __exit__(self, *exc):
        tr, rec = self._tr, self._rec
        end = None
        if self._start is not None:
            end = tr._event(self._torch, self._dev)
            end.record()
        if self._range is not None:
            self._range.__exit__(*exc)
        rec["t1_ns"] = t1 = time.time_ns()
        tr._stack().pop()
        t0 = rec["t0_ns"]
        rec["stream_ms"] = None if end is not None else (t1 - t0) * 1e-6
        with tr._lock:
            if tr._t0_ns is None:
                tr._t0_ns = t0
            rec.update(ts=(t0 - tr._t0_ns) / 1e3, dur=(t1 - t0) / 1e3,
                       pid=_pid(HOST), tid=tr._tid(HOST, "host"))
            tr._events.append(rec)
            if end is not None:
                tr._pending.append((rec, self._start, end, self._dev))
            full = len(tr._pending) >= MAX_PENDING
        if full:
            tr._resolve(wait=False)
        return False


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer the instrumentation points write to."""
    return _TRACER


def reset() -> None:
    _TRACER.reset()


def span(name: str, *, cat: str = "host", args: Optional[dict] = None):
    """A span on the process-global tracer: ``with obs.span("replay"):``;
    a shared ``nullcontext`` unless tracing is on or a profiler runs."""
    return _TRACER.span(name, cat=cat, args=args)


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
