"""Request-level serving engine: continuous batching + live hot-swap.

The port of ``repro.serve.engine``: the same API, counters and tick, on
an explicit ``device`` (``cuda`` unless the caller passes ``"cpu"``).

``Engine`` owns ``slots`` decode lanes over ONE decode step. The JAX
engine stacks batch=1 states on a slot axis and ``vmap``s the step; here
the slot axis IS the batch dimension of one decode state, whose
per-row cursors let every slot sit at its own position. The tick:

  1. **swap** — poll the subscribed ``CheckpointChannel``; a fresh framed
     checkpoint is CRC-verified, decoded (K3 on the card) and becomes
     the params of the NEXT decode step. In-flight requests keep their
     caches and keep decoding (zero drops); a corrupt publish is
     rejected and the serving params stay untouched.
  2. **admit** — pop queued requests into free slots: a bulk prefill
     (a loop of the decode step, bit-identical to token-by-token) fills a
     fresh batch=1 state, samples the first token, and the state is
     copied into the slot's row of the plane.
  3. **decode** — one decode step over all slots; finished sequences
     free their slots mid-batch and step 2 splices queued requests in
     (continuous batching).

``mode="static"`` is the gang-scheduled baseline: a finished sequence's
slot stays dead until the whole batch drains.

Sampling keys are the JAX engine's (``fold_in(PRNGKey(seed), step)``
per decode step, ``fold_in(key, 0x7FFFFFFF - rid)`` per prefill) drawn
with the port's threefry, and greedy decoding is an argmax, so the same
params give the JAX engine's token streams.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.core import compression, prng, pytree
from repro_torch.device import resolve_device
from repro_torch.models import transformer_scan
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.channel import CheckpointChannel
from repro_torch.train import steps

PyTree = Any


class AdmissionError(RuntimeError):
    """A request was refused at the door: queue full, or the prompt +
    generation budget cannot fit the slot cache."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Typed engine configuration (``launch/serve.py`` is a thin
    argv -> ServeConfig shim).

    max_len bounds each slot's cache: a request needs
    prompt_len + max_new_tokens - 1 <= max_len slots.
    mixed_gen, when non-empty, cycles per-request generation lengths for
    the synthetic workload of ``serve.run``; gen_tokens is the uniform
    fallback.
    """

    arch: str = "qwen1.5-0.5b"
    reduced: bool = True
    slots: int = 4
    max_queue: int = 64
    max_len: int = 96
    window: int = 0               # sliding-window KV slots (0 = full)
    mode: str = "continuous"      # continuous | static
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0
    # synthetic-workload knobs (serve.run)
    n_requests: int = 8
    prompt_len: int = 12
    gen_tokens: int = 16
    mixed_gen: tuple = ()

    def __post_init__(self):
        if self.mode not in ("continuous", "static"):
            raise ValueError(f"mode must be continuous|static, "
                             f"got '{self.mode}'")
        if self.slots < 1:
            raise ValueError("need at least one slot")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    submitted_at: float = 0.0


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: list                  # generated token ids
    latency_s: float              # submit -> last token
    finished_at: float = 0.0

    @property
    def n_generated(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class _Active:
    """A slot's in-flight bookkeeping (host side)."""

    request: Request
    generated: list
    remaining: int                # decode steps left after prefill
    done: bool = False            # static mode: finished but slot held


def _to_device(tree: PyTree, device: torch.device) -> PyTree:
    return pytree.tree_map(lambda a: a.to(device), tree)


def _clone(tree: PyTree) -> PyTree:
    return pytree.tree_map(
        lambda a: a.clone() if isinstance(a, torch.Tensor) else a, tree)


class Engine:
    """The serving facade: submit -> step/run -> results."""

    def __init__(self, cfg: ServeConfig, *, params: Optional[PyTree] = None,
                 model_cfg=None, key=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        mc = model_cfg if model_cfg is not None \
            else configs.get_config(cfg.arch)
        if model_cfg is None and cfg.reduced:
            mc = mc.reduced()
        if mc.frontend != "token":
            raise ValueError(
                f"the serve engine speaks token frontends only; "
                f"'{mc.arch_id}' has frontend '{mc.frontend}'")
        self.model_cfg = mc
        self._key = prng.PRNGKey(cfg.seed) if key is None else key
        self.params = (_to_device(params, self.device) if params is not None
                       else transformer_scan.init(
                           mc, transformer_scan.generator(cfg.seed,
                                                          self.device)))
        # each slot its own MoE group, as the JAX engine's vmapped
        # batch-1 step groups it
        self._serve_step = steps.make_serve_step(mc, scan_layers=True,
                                                 moe_rows=True)
        self._bulk_prefill = steps.make_bulk_prefill(mc, scan_layers=True)

        # slot plane: one decode state whose batch rows are the slots;
        # _fresh is the batch=1 template a prefill starts from
        S = cfg.slots
        mk = lambda b: transformer_scan.init_decode_state(  # noqa: E731
            self.params, mc, b, cfg.max_len, window=cfg.window,
            dtype=torch.float32, device=self.device)
        self._fresh = mk(1)
        self._state = mk(S)
        self._tokens = torch.zeros((S, 1), dtype=torch.long,
                                   device=self.device)

        self._slots: list[Optional[_Active]] = [None] * S
        self._queue: deque[Request] = deque()
        self._results: dict[int, Completion] = {}
        self._next_rid = 0
        self._step_idx = 0
        self._t0 = time.monotonic()
        self.counters = {"admitted": 0, "completed": 0, "rejected": 0,
                         "dropped": 0, "generated_tokens": 0,
                         "swaps": 0, "swaps_rejected": 0}

        self._channel: Optional[CheckpointChannel] = None
        self._seen_seq = 0

    # -- admission ---------------------------------------------------------

    def submit(self, tokens, max_new_tokens: int,
               rid: Optional[int] = None) -> int:
        """Enqueue one request. Raises AdmissionError when the queue is
        full or the request cannot fit a slot cache."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise AdmissionError("max_new_tokens must be >= 1")
        need = len(tokens) + max_new_tokens - 1
        cap = self.cfg.max_len if self.cfg.window == 0 else None
        if cap is not None and need > cap:
            self._count("rejected")
            raise AdmissionError(
                f"request needs {need} cache slots "
                f"(prompt {len(tokens)} + {max_new_tokens} new) but "
                f"max_len is {cap}")
        if len(self._queue) >= self.cfg.max_queue:
            self._count("rejected")
            raise AdmissionError(
                f"queue full ({self.cfg.max_queue} pending)")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        self._queue.append(Request(rid, tokens, int(max_new_tokens),
                                   time.monotonic()))
        if obs.enabled("metrics"):
            obs.gauge("serve.queue_depth").set(len(self._queue))
        return rid

    # -- checkpoint hot-swap -----------------------------------------------

    def subscribe(self, channel: CheckpointChannel) -> None:
        """Watch a channel; ``step`` applies fresh checkpoints between
        decode steps."""
        self._channel = channel

    def maybe_swap(self) -> bool:
        """Apply the newest published checkpoint, if any. Returns True
        on a swap; a corrupt publish is rejected (counted, params kept)
        and its seq marked seen."""
        if self._channel is None:
            return False
        pub = self._channel.poll(self._seen_seq)
        if pub is None:
            return False
        self._seen_seq = pub.seq
        try:
            new_params = CheckpointChannel.decode(pub)
        except compression.WireCorruptionError:
            self._count("swaps_rejected")
            if obs.enabled("metrics"):
                obs.counter("serve.swap.rejected").inc()
            return False
        self.params = _to_device(new_params, self.device)
        self._count("swaps")
        if obs.enabled("metrics"):
            obs.counter("serve.swap.applied").inc()
        if obs.enabled("trace"):
            obs_trace.tracer().instant(
                f"hot-swap seq={pub.seq} step={pub.step}",
                worker=obs_trace.HOST, lane="host",
                t=time.monotonic() - self._t0, cat="serve.swap")
        return True

    # -- the engine tick ---------------------------------------------------

    def step(self) -> bool:
        """One tick: swap -> admit -> one decode step over all slots.
        Returns False once idle (no active slots, empty queue)."""
        self.maybe_swap()
        self._admit()
        if not any(a is not None and not a.done for a in self._slots):
            return bool(self._queue)
        key = prng.fold_in(self._key, self._step_idx)
        logits, self._state = self._serve_step(self.params, self._state,
                                               {"tokens": self._tokens})
        nxt = _sample(logits, key, self.cfg.temperature)
        self._tokens = nxt.view(-1, 1)
        self._step_idx += 1
        toks = nxt.tolist()
        for slot, active in enumerate(self._slots):
            if active is None or active.done:
                continue
            active.generated.append(int(toks[slot]))
            self._count("generated_tokens")
            active.remaining -= 1
            if active.remaining <= 0:
                self._finish(slot)
        return True

    def run(self) -> None:
        """Drive ticks until every queued/active request completed."""
        while self.step():
            pass

    def warmup(self, prompt_lens=()) -> None:
        """Run a prefill per distinct prompt length and one decode step
        on scratch states outside the timed path (library handles and
        the allocator's pools are set up here, not in the first
        request)."""
        key = prng.PRNGKey(0)
        for plen in sorted(set(int(p) for p in prompt_lens)):
            toks = torch.zeros((1, plen), dtype=torch.long,
                               device=self.device)
            self._prefill(toks, key)
        self._serve_step(self.params, _clone(self._state),
                         {"tokens": self._tokens})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- results -----------------------------------------------------------

    def result(self, rid: int) -> Optional[Completion]:
        return self._results.get(rid)

    @property
    def completions(self) -> dict[int, Completion]:
        return dict(self._results)

    def stats(self) -> dict:
        """Aggregate throughput/latency over completed requests."""
        lats = sorted(c.latency_s for c in self._results.values())
        wall = time.monotonic() - self._t0
        out = dict(self.counters)
        out.update({
            "wall_s": wall,
            "decode_steps": self._step_idx,
            "tokens_per_s": (self.counters["generated_tokens"] / wall
                             if wall > 0 else 0.0),
            "p50_ms": _percentile(lats, 50), "p99_ms": _percentile(lats, 99),
        })
        return out

    # -- internals ---------------------------------------------------------

    def _count(self, name: str, v: int = 1) -> None:
        self.counters[name] += v

    def _free_slots(self) -> list[int]:
        return [i for i, a in enumerate(self._slots) if a is None]

    def _admit(self) -> None:
        free = self._free_slots()
        if self.cfg.mode == "static" and len(free) < len(self._slots):
            return
        while self._queue and free:
            self._place(self._queue.popleft(), free.pop(0))
        if obs.enabled("metrics"):
            obs.gauge("serve.queue_depth").set(len(self._queue))

    def _prefill(self, toks: torch.Tensor, key) -> tuple:
        """Fill a fresh batch=1 state with ``toks`` (1, P); sample the
        first token."""
        logits, state1 = self._bulk_prefill(self.params, _clone(self._fresh),
                                            toks)
        return _sample(logits, key, self.cfg.temperature), state1

    def _place(self, req: Request, slot: int) -> None:
        """Prefill ``req`` and splice its state into row ``slot`` of the
        plane — the mid-decode admission path."""
        key = prng.fold_in(self._key, 0x7FFFFFFF - req.rid)
        toks = torch.as_tensor(req.tokens, dtype=torch.long,
                               device=self.device)[None]
        tok, state1 = self._prefill(toks, key)
        _splice(self._state, state1, slot)
        self._tokens[slot, 0] = tok[0]
        active = _Active(req, [int(tok[0])], req.max_new_tokens - 1)
        self._slots[slot] = active
        self._count("admitted")
        self._count("generated_tokens")
        if obs.enabled("metrics"):
            obs.counter("serve.admitted").inc()
        if active.remaining <= 0:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        active = self._slots[slot]
        now = time.monotonic()
        comp = Completion(active.request.rid, len(active.request.tokens),
                          active.generated,
                          now - active.request.submitted_at, now)
        self._results[comp.rid] = comp
        self._count("completed")
        if obs.enabled("metrics"):
            obs.counter("serve.completed").inc()
            obs.histogram("serve.latency_ms").observe(
                comp.latency_s * 1e3)
        if obs.enabled("trace"):
            obs_trace.tracer().sim_span(
                f"request {comp.rid}", worker=obs_trace.HOST, lane="host",
                t0=active.request.submitted_at - self._t0,
                t1=now - self._t0, cat="serve.request",
                args={"prompt": comp.prompt_len,
                      "generated": comp.n_generated})
        if self.cfg.mode == "static":
            active.done = True
            if all(a is None or a.done for a in self._slots):
                self._slots = [None] * len(self._slots)
        else:
            self._slots[slot] = None


def _sample(logits: torch.Tensor, key, temperature: float) -> torch.Tensor:
    """Greedy or temperature sampling over (n, vocab) logits -> (n,),
    one ``split`` key per row as in the JAX engine."""
    if temperature > 0:
        keys = prng.split(key, logits.shape[0])
        return torch.stack([prng.categorical(keys[i], row / temperature)
                            for i, row in enumerate(logits)])
    return torch.argmax(logits, dim=-1)


# batch axis of each part of a transformer_scan decode state
_BATCH_AXIS = {"prefix": 0, "scan": 1, "suffix": 0}


def _splice(stacked: dict, state1: dict, slot: int) -> None:
    """Copy a batch=1 decode state into row ``slot`` of the plane."""
    for part, axis in _BATCH_AXIS.items():
        for dst, src in zip(stacked[part], state1[part]):
            for name, t in dst.items():
                if isinstance(t, torch.Tensor):
                    t.select(axis, slot).copy_(src[name].select(axis, 0))


def _percentile(sorted_vals: list, q: float) -> float:
    """q-th percentile (ms) of pre-sorted latency seconds."""
    if not sorted_vals:
        return 0.0
    return float(np.percentile(np.asarray(sorted_vals), q) * 1e3)
