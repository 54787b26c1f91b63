"""Metrics registry: counters, gauges, histograms with named scopes.

A stdlib copy of ``repro.obs.metrics``. Instrumentation points (the
serve engine, the checkpoint channel, ``core.compression``) call

    metrics.counter("serve.ckpt.published", codec="rq8").inc()

When the metrics switch is off (the default) ``counter``/``gauge``/
``histogram`` return a shared no-op instrument — the whole call is one
dict lookup and one branch, which is how instrumentation stays under
the <2% overhead gate. Names are dotted scopes; keyword labels render
into the name as ``scope[k=v,...]`` so one instrument exists per label
set (wire bytes by codec tier, staleness per protocol, ...).

Instruments accept plain Python numbers; ``observe_array`` takes any
array-like with ``ravel().tolist()`` (a tensor is copied to the host).

``Histogram`` keeps count/sum/min/max plus power-of-two magnitude
buckets — enough for staleness distributions, straggler lag, and
compression ratios without reservoir bookkeeping.
"""
from __future__ import annotations

import json
import math
import threading

from repro_torch.obs import state


def scoped_name(name: str, **labels) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}[{inner}]"


class Counter:
    """Monotonic count (messages, bytes, retries, kernel launches)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (current compression ratio, live-set size)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """count/sum/min/max + power-of-two magnitude buckets.

    Bucket i counts values in (2**(i-1), 2**i] (bucket 0: (0, 1];
    ``neg``/``zero`` catch the rest) — coarse, allocation-free, and
    enough to see a staleness or straggler-lag distribution move.
    """

    __slots__ = ("name", "count", "total", "vmin", "vmax", "buckets",
                 "neg", "zero")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: dict[int, int] = {}
        self.neg = 0
        self.zero = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v < 0:
            self.neg += 1
        elif v == 0:
            self.zero += 1
        else:
            b = max(0, math.ceil(math.log2(v)))
            self.buckets[b] = self.buckets.get(b, 0) + 1

    def observe_many(self, vals) -> None:
        for v in vals:
            self.observe(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"type": "histogram", "count": self.count,
                "sum": self.total,
                "min": self.vmin if self.count else None,
                "max": self.vmax if self.count else None,
                "mean": self.mean if self.count else None,
                "neg": self.neg, "zero": self.zero,
                "pow2_buckets": {str(k): v for k, v in
                                 sorted(self.buckets.items())}}


class _Null:
    """Shared no-op instrument returned while metrics are disabled."""

    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, vals) -> None:
        pass


_NULL = _Null()


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, cls, name: str, labels: dict):
        key = scoped_name(name, **labels)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(key, cls(key))
        if not isinstance(inst, cls):
            raise TypeError(f"metric '{key}' already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """{name: {type, ...}} for every instrument, sorted by name."""
        with self._lock:
            return {k: self._instruments[k].snapshot()
                    for k in sorted(self._instruments)}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
            f.write("\n")
        return path

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def reset() -> None:
    _REGISTRY.reset()


def counter(name: str, **labels):
    """Counter by scoped name — the no-op instrument when disabled."""
    if not state.enabled("metrics"):
        return _NULL
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels):
    if not state.enabled("metrics"):
        return _NULL
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels):
    if not state.enabled("metrics"):
        return _NULL
    return _REGISTRY.histogram(name, **labels)


def observe_array(name: str, arr, **labels) -> None:
    """Histogram-observe every element of an array-like."""
    if not state.enabled("metrics") or arr is None:
        return
    hist = _REGISTRY.histogram(name, **labels)
    try:
        flat = arr.ravel().tolist() if hasattr(arr, "ravel") else list(arr)
    except TypeError:
        flat = [arr]
    hist.observe_many(float(v) for v in flat)
