"""Flight recorder: a bounded ring buffer of recent telemetry events,
dumped to disk when something goes wrong.

While the flight switch is on, instrumentation points push small dict
events (``flight.record("scheduler.round", protocol=..., r=...)``) into
a ``deque(maxlen=capacity)``; nothing is written anywhere in the happy
path. Two failure hooks dump the buffer as JSON:

  * ``faults.validate`` dumps on a fault-ledger/wire-ledger mismatch
    (the forged-ledger class of bug) before re-raising;
  * ``@flight.guarded("scheduler.<proto>")`` wraps every scheduler
    entry point and dumps on any uncaught exception.

Dumps land in ``REPRO_OBS_DIR`` (default: the current directory) as
``flight_<scope>.json`` with the failure reason, the run identity
(``repro_torch.obs.runinfo.run_id``), and the buffered events in order —
cross-referenceable with BENCH rows and exported timelines through the
shared ``run_id``.

``kernel_scope(name)`` is the span of a kernel call: ``obs.span``
under the kernel's name (a ``torch.profiler`` range and a record of the
tracer while tracing is on or a profiler runs), a free nullcontext
otherwise.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import threading
from collections import deque
from typing import Optional

from repro_torch.obs import state
from repro_torch.obs import trace as _trace

DEFAULT_CAPACITY = 4096


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._seq = itertools.count()

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._buf = deque(self._buf, maxlen=capacity)

    def record(self, kind: str, **fields) -> None:
        """Push one event (no-op unless the flight switch is on)."""
        if not state.enabled("flight"):
            return
        with self._lock:
            self._buf.append({"seq": next(self._seq), "kind": kind,
                              **fields})

    def snapshot(self) -> list:
        with self._lock:
            return list(self._buf)

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seq = itertools.count()

    def dump(self, *, reason: str, scope: str = "obs",
             path: Optional[str] = None) -> str:
        """Write the buffer (+ run identity) as JSON; returns the path."""
        from repro_torch.obs import runinfo

        if path is None:
            out_dir = os.environ.get("REPRO_OBS_DIR", ".")
            os.makedirs(out_dir, exist_ok=True)
            safe = scope.replace("/", "_").replace(".", "_")
            path = os.path.join(out_dir, f"flight_{safe}.json")
        payload = {"reason": reason, "scope": scope,
                   "run_id": runinfo.run_id(),
                   "schema_version": runinfo.SCHEMA_VERSION,
                   "n_events": len(self._buf),
                   "capacity": self.capacity,
                   "events": self.snapshot()}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
            f.write("\n")
        return path


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, **fields) -> None:
    _RECORDER.record(kind, **fields)


def reset() -> None:
    _RECORDER.reset()


def dump_on_failure(scope: str, reason: str) -> Optional[str]:
    """Failure hook: dump the ring buffer if flight recording is on
    (nothing was buffered otherwise). Never raises — this runs on the
    way OUT of a failing assert, and must not mask it."""
    if not state.enabled("flight"):
        return None
    try:
        path = _RECORDER.dump(reason=reason, scope=scope)
    except OSError:
        return None
    return path


def guarded(scope: str):
    """Decorator: dump the flight buffer on any uncaught exception from
    the wrapped function (the scheduler entry points use this), then
    re-raise unchanged."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as e:                 # noqa: BLE001
                dump_on_failure(scope, f"{type(e).__name__}: {e}")
                raise
        return wrapper
    return deco


def kernel_scope(name: str):
    """``obs.span(name)`` around a kernel call: nested in the phase's
    span, a range of torch.profiler timelines; else a free
    nullcontext."""
    return _trace.span(name)


def kernel_annotation(name: str):
    """Decorator form of ``kernel_scope`` for kernel entry points: the
    scope opens on every call, one switch check when nothing records."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with kernel_scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco
