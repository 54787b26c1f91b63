"""Publish/subscribe checkpoint channel: the train -> serve wire.

The port of ``repro.serve.channel``. A trainer publishes its params as
ONE codec-compressed ``FlatPacked`` message (``tree_encode_flat``:
K1 ranges, K2 quantize + pack on the card), framed with a CRC32 over the
payload bytes then the params bytes. A live ``Engine`` polls the channel
once per tick and swaps params between decode steps with zero dropped
requests; the swap decodes (K3) the SAME bits a cold start from the
published checkpoint would, so a hot swap is bit-equivalent to a
restart minus the downtime.

Integrity contract on receive (``decode``): the CRC32 frame is verified
(a bit-flipped checkpoint raises ``WireCorruptionError``) and the
decoded tree passes the post-decode finite guard (a framed NaN publish
is refused the same way); the subscriber's params are untouched either
way. Bytes and CRC equal the JAX package's for the same params and key,
so either package decodes the other's checkpoints.

In-process and thread-safe (one lock, last-value semantics: a slow
subscriber sees the newest checkpoint, not a backlog).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

from repro_torch import obs
from repro_torch.core import compression, prng

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PublishedCheckpoint:
    """One framed checkpoint message as it sits on the channel.

    seq:    channel-assigned monotone sequence number.
    step:   the trainer's step counter (provenance, not ordering).
    codec:  registry name that encoded ``packed`` (decodes it too).
    packed: the ONE FlatPacked wire message for the whole param tree.
    crc:    CRC32 frame over payload bytes then params bytes.
    """

    seq: int
    step: int
    codec: str
    packed: compression.FlatPacked
    crc: int
    published_at: float = 0.0

    @property
    def wire_bytes(self) -> int:
        return self.packed.wire_bytes


class CheckpointChannel:
    """Last-value publish/subscribe channel for compressed checkpoints."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0
        self._latest: Optional[PublishedCheckpoint] = None

    def publish(self, params: PyTree, *, step: int = 0, codec: str = "rq8",
                key=None) -> PublishedCheckpoint:
        """Encode ``params`` (on their device) into one framed
        FlatPacked and make it the channel's latest. ``key`` defaults to
        ``PRNGKey(step)``, as in the JAX package."""
        cdc = compression.codec(codec)
        if key is None:
            key = prng.PRNGKey(step)
        packed, crc = compression.frame(cdc.tree_encode_flat(params, key))
        return self.publish_packed(packed, crc, step=step, codec=codec)

    def publish_packed(self, packed: compression.FlatPacked, crc: int, *,
                       step: int = 0,
                       codec: str = "rq8") -> PublishedCheckpoint:
        """Publish an already-framed wire message verbatim (a relay, a
        checkpoint from the JAX package, or a corruption test)."""
        with self._lock:
            self._seq += 1
            pub = PublishedCheckpoint(self._seq, step, codec, packed,
                                      int(crc) & 0xFFFFFFFF, time.time())
            self._latest = pub
        if obs.enabled("metrics"):
            obs.counter("serve.ckpt.published", codec=codec).inc()
            obs.counter("serve.ckpt.published_bytes",
                        codec=codec).inc(pub.wire_bytes)
        return pub

    @property
    def latest(self) -> Optional[PublishedCheckpoint]:
        with self._lock:
            return self._latest

    def poll(self, since_seq: int = 0) -> Optional[PublishedCheckpoint]:
        """The newest checkpoint with seq > since_seq, else None."""
        with self._lock:
            pub = self._latest
        return pub if pub is not None and pub.seq > since_seq else None

    @staticmethod
    def decode(pub: PublishedCheckpoint) -> PyTree:
        """Frame-verified decode back to the param tree, on the device
        the message lies on. Raises ``compression.WireCorruptionError``
        on a CRC mismatch or a non-finite decode."""
        where = f"checkpoint seq={pub.seq} step={pub.step}"
        compression.verify_wire(pub.packed, pub.crc, where=where)
        params = compression.codec(pub.codec).tree_decode_flat(pub.packed)
        compression.guard_finite(params, where=where)
        return params


def publish_train_state(channel: CheckpointChannel, state: dict, *,
                        codec: str = "rq8") -> PublishedCheckpoint:
    """Publish a train state's params (step and tree read off the state
    dict)."""
    return channel.publish(state["params"], step=int(state["step"]),
                           codec=codec)
