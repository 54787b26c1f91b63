"""THE registry idiom: one name -> entry table for every pluggable tier.

A stdlib copy of ``repro.core.registry``; in the port it holds the codec
table of ``core.compression`` and the exchanges of
``core.communicators``.

Four registries grew up independently — ``EXCHANGES``/``make_exchange``
(core.communicators), ``PROTOCOLS``/``make_protocol``
(cluster.protocols), the codec table (core.compression) and the
Byzantine aggregator table (cluster.aggregators) — each hand-rolling
the same dict lookup and its own flavor of "unknown X" error text. This
module is the single implementation they all share:

    CODECS = Registry("compression", {...})
    CODECS.get("rq8")            # stored entry, as-is (instances, fns)
    EXCHANGES.make("csgd_ring", compressor="rq4")   # factory call
    @PROTOCOLS.register("laq")   # decorator registration
    class LAQ: ...

``Registry`` is a ``Mapping``, so every existing call-site idiom keeps
working unchanged: ``sorted(EXCHANGES)``, ``"gossip" in EXCHANGES``,
``PROTOCOLS.items()``, ``AGGREGATORS[name]``. Lookup failures raise a
uniform ``KeyError`` naming the registry kind and listing the valid
choices — the error contract the four hand-rolled versions each
re-implemented (and tests match on).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Iterator, Optional


class Registry(Mapping):
    """An ordered name -> entry table with uniform error reporting.

    kind:    the human name used in error text ("exchange", "protocol",
             "compression", "aggregator").
    entries: optional initial {name: entry} dict. Entries may be
             factories (classes/callables ``make`` instantiates) or
             ready objects (codec instances, plain functions) returned
             verbatim by ``get``.
    """

    def __init__(self, kind: str,
                 entries: Optional[dict[str, Any]] = None):
        self.kind = kind
        self._entries: dict[str, Any] = dict(entries or {})

    # -- Mapping protocol (keeps dict-shaped call sites working) ---------

    def __getitem__(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            raise self._unknown(name) from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {self.names()})"

    # -- the shared idiom -------------------------------------------------

    def _unknown(self, name: str) -> KeyError:
        return KeyError(f"unknown {self.kind} '{name}'; "
                        f"have {self.names()}")

    def names(self) -> list[str]:
        """Sorted valid choices (what the KeyError lists)."""
        return sorted(self._entries)

    def register(self, name: str, entry: Any = None):
        """Register an entry, or use as a decorator when entry is None.

        Duplicate names raise — two tiers silently fighting over a
        registry slot is exactly the bug a shared registry exists to
        prevent; re-registration must be an explicit ``replace``.
        """
        if entry is None:
            return lambda e: self.register(name, e) or e
        if name in self._entries:
            raise ValueError(
                f"{self.kind} '{name}' already registered")
        self._entries[name] = entry

    def replace(self, name: str, entry: Any) -> None:
        """Overwrite an existing entry (tests swapping in doubles)."""
        if name not in self._entries:
            raise self._unknown(name)
        self._entries[name] = entry

    def get(self, name: str) -> Any:  # type: ignore[override]
        """The stored entry, verbatim — for registries of ready objects
        (codec instances, aggregator functions)."""
        return self[name]

    def make(self, name: str, **kw) -> Any:
        """Instantiate a factory entry: ``registry[name](**kw)`` — for
        registries of classes (exchanges, protocols)."""
        return self[name](**kw)


def make_factory(registry: Registry) -> Callable[..., Any]:
    """A module-level ``make_<kind>(name, **kw)`` bound to a registry
    (the public spelling the exchange/protocol tiers already export)."""

    def make(name: str, **kw) -> Any:
        return registry.make(name, **kw)

    make.__name__ = f"make_{registry.kind}"
    make.__doc__ = (f"Instantiate a registered {registry.kind}: "
                    f"``{registry.kind.upper()}S[name](**kw)``.")
    return make
