"""Readers of the program's own spans: what the traced window recorded in
the process's tracer (``repro_torch.obs``), by span name, in stream time
(the device's time between a span's start and end on its CUDA stream).
A program that keeps no such record (no ``Tracer.span_stats``) reads
nothing: every reader returns None."""
from __future__ import annotations


def stats(name: str, under: str = None):
    """(count, host s, stream s) of the spans ``name`` (inside a span
    ``under``), or None when none was recorded."""
    from repro_torch.obs import trace
    read = getattr(trace.tracer(), "span_stats", None)
    if read is None:
        return None
    s = read(name, under=under)
    return s if s.count else None


def mean_ms(name: str):
    """Mean stream ms of a span ``name``."""
    s = stats(name)
    return 1e3 * s.stream_s / s.count if s else None


def worst(run, value):
    """The largest of the ranks' values, None left out (every rank
    calls this: it gathers)."""
    got = [v for v in run.gather(value) if v is not None]
    return max(got) if got else None
