"""Telemetry tier of the port: stdlib copies of ``repro.obs`` —
switches, metrics, the span/sim-span tracer and its scheduler-trace
renderer, the flight recorder and run identity. Off by default
(``REPRO_OBS=1`` or ``obs.enable()`` turns it on). ``span`` is the one
span of the program: it records while tracing is on or a
``torch.profiler`` runs (a profiler range and a record on the
profiler's clock, with the span's CUDA stream time; ``kernel_scope`` is
a span under a kernel's name), and is a shared nullcontext otherwise.
``tracer().spans()`` / ``span_stats`` read the record;
``python -m repro_torch.obs.export trace`` writes a timeline.
"""
from repro_torch.obs.flight import (kernel_scope, record as flight_record,
                                    recorder as flight_recorder)
from repro_torch.obs.metrics import (counter, gauge, histogram,
                                     observe_array,
                                     registry as metrics_registry)
from repro_torch.obs.runinfo import SCHEMA_VERSION, run_id, stamp_rows
from repro_torch.obs.state import disable, enable, enabled
from repro_torch.obs.trace import span, timeline_from_trace, tracer

__all__ = [
    "SCHEMA_VERSION", "counter", "disable", "enable", "enabled",
    "flight_record", "flight_recorder", "gauge", "histogram",
    "kernel_scope", "metrics_registry", "observe_array", "run_id",
    "span", "stamp_rows", "timeline_from_trace", "tracer",
]
