"""Telemetry tier of the port: stdlib copies of ``repro.obs``'s switches,
metrics and wall/sim-span tracer — what the serving path calls. Off by
default (``REPRO_OBS=1`` or ``obs.enable()`` turns it on). The flight
recorder, Perfetto export, run ids and the scheduler-trace renderer
wait for the obs slice.
"""
from repro_torch.obs.metrics import (counter, gauge, histogram,
                                     observe_array,
                                     registry as metrics_registry)
from repro_torch.obs.state import disable, enable, enabled
from repro_torch.obs.trace import span, tracer

__all__ = [
    "counter", "disable", "enable", "enabled", "gauge", "histogram",
    "metrics_registry", "observe_array", "span", "tracer",
]
