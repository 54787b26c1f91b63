"""Master switches for the telemetry tier.

A stdlib copy of ``repro.obs.state``. Everything in ``repro_torch.obs``
is OFF by default: every instrumentation
point in the stack guards itself with ``state.enabled(kind)``, which is
one dict lookup on a module-level dict — the measured overhead budget
(<2% on ``cluster_bench --smoke``, gated in CI) is spent here, so this
module must stay dependency-free and branch-cheap.

Kinds:
  trace    span/event tracer (repro_torch.obs.trace)
  metrics  counters/gauges/histograms (repro_torch.obs.metrics)
  flight   bounded ring buffer of recent events (repro_torch.obs.flight)

``REPRO_OBS=1`` in the environment enables all three at import time
(the CI tracing job uses exactly this). ``REPRO_OBS=trace,metrics``
enables a subset.
"""
from __future__ import annotations

import os

_KINDS = ("trace", "metrics", "flight")
_ON = {k: False for k in _KINDS}


def enable(*, trace: bool = True, metrics: bool = True,
           flight: bool = True) -> None:
    """Turn telemetry kinds on (all three by default)."""
    if trace:
        _ON["trace"] = True
    if metrics:
        _ON["metrics"] = True
    if flight:
        _ON["flight"] = True


def disable() -> None:
    """Turn every telemetry kind off (the default state)."""
    for k in _KINDS:
        _ON[k] = False


def enabled(kind: str = "trace") -> bool:
    """Is this telemetry kind on? The single hot-path check every
    instrumentation point performs."""
    return _ON[kind]


def any_enabled() -> bool:
    return any(_ON.values())


def _from_env() -> None:
    val = os.environ.get("REPRO_OBS", "").strip()
    if not val or val == "0":
        return
    if val == "1" or val.lower() in ("all", "true", "on"):
        enable()
        return
    kinds = {k.strip() for k in val.split(",")}
    enable(trace="trace" in kinds, metrics="metrics" in kinds,
           flight="flight" in kinds)


_from_env()
