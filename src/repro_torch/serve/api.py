"""Programmatic serving entry point: ``serve.run(ServeConfig) -> ServeResult``.

The port of ``repro.serve.api``. ``run`` builds an ``Engine`` on
``device`` (``cuda`` unless ``"cpu"`` is passed), generates the
synthetic mixed-length workload the config describes, drives it to
completion and returns a structured result.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve.channel import CheckpointChannel
from repro_torch.serve.engine import Engine, Request, ServeConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """What a serve run measured (the machine-readable return value).

    completions: rid -> Completion (token streams + per-request latency)
    counters:    the engine's admitted/completed/rejected/dropped/swap
                 tallies
    device:      where it ran (``torch.cuda.get_device_name`` on a card)
    """

    config: ServeConfig
    completions: dict
    counters: dict
    wall_s: float
    decode_steps: int
    total_tokens: int
    tokens_per_s: float
    p50_ms: float
    p99_ms: float
    device: str = "cpu"

    @property
    def n_completed(self) -> int:
        return len(self.completions)

    def row(self, **identity) -> dict:
        """A result row (identity fields first)."""
        r = dict(identity)
        r.update({
            "device": self.device,
            "requests": self.n_completed,
            "decode_steps": self.decode_steps,
            "total_tokens": self.total_tokens,
            "tokens_per_s": self.tokens_per_s,
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "dropped": self.counters["dropped"],
            "rejected": self.counters["rejected"],
        })
        return r


def synthetic_requests(cfg: ServeConfig) -> list[Request]:
    """The deterministic mixed-length workload: fixed prompt length,
    per-request generation lengths cycling through ``mixed_gen`` (or
    uniform ``gen_tokens``). The same tokens as the JAX package's."""
    rng = np.random.default_rng(cfg.seed)
    gens = (list(cfg.mixed_gen) or [cfg.gen_tokens])
    reqs = []
    for i in range(cfg.n_requests):
        toks = rng.integers(0, _vocab(cfg), size=cfg.prompt_len,
                            dtype=np.int64).astype(np.int32)
        reqs.append(Request(i, toks, int(gens[i % len(gens)])))
    return reqs


def _vocab(cfg: ServeConfig) -> int:
    from repro_torch import configs
    mc = configs.get_config(cfg.arch)
    return (mc.reduced() if cfg.reduced else mc).vocab


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(cfg: ServeConfig, *, params: Optional[PyTree] = None,
        requests: Optional[list] = None,
        channel: Optional[CheckpointChannel] = None,
        engine: Optional[Engine] = None, warmup: bool = True,
        device=None) -> ServeResult:
    """Serve a workload to completion and measure it.

    params/requests/channel/engine let callers drop in a trained model,
    a custom request list, a live checkpoint channel, or a pre-built
    engine; by default everything is synthesized from the config. The
    first prefill per prompt length and the first decode step run
    before the clock starts (``Engine.warmup``).
    """
    if engine is None:
        engine = Engine(cfg, params=params, device=device)
    if channel is not None:
        engine.subscribe(channel)
    reqs = synthetic_requests(cfg) if requests is None else requests
    if warmup:
        engine.warmup(sorted({len(r.tokens) for r in reqs}))

    with obs.span(f"serve.run[{cfg.mode}]"):
        engine._t0 = time.monotonic()
        for r in reqs:
            engine.submit(r.tokens, r.max_new_tokens, rid=r.rid)
        engine.run()
    stats = engine.stats()

    result = ServeResult(
        config=cfg,
        completions=engine.completions,
        counters=dict(engine.counters),
        wall_s=stats["wall_s"],
        decode_steps=stats["decode_steps"],
        total_tokens=stats["generated_tokens"],
        tokens_per_s=stats["tokens_per_s"],
        p50_ms=stats["p50_ms"],
        p99_ms=stats["p99_ms"],
        device=device_name(engine.device),
    )
    if obs.enabled("metrics"):
        obs.histogram("serve.tokens_per_s", mode=cfg.mode).observe(
            result.tokens_per_s)
    return result


def format_result(res: ServeResult) -> str:
    """The CLI's human-readable summary block."""
    c = res.config
    lines = [
        f"[serve] arch={c.arch}{' (reduced)' if c.reduced else ''} "
        f"mode={c.mode} slots={c.slots} requests={res.n_completed} "
        f"device={res.device}",
        f"[serve] {res.total_tokens} tokens in {res.wall_s:.2f}s = "
        f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} decode "
        f"steps",
        f"[serve] latency p50={res.p50_ms:.1f}ms p99={res.p99_ms:.1f}ms"
        f" | dropped={res.counters['dropped']} "
        f"rejected={res.counters['rejected']} "
        f"swaps={res.counters['swaps']}",
    ]
    if res.completions:
        rid = min(res.completions)
        sample = res.completions[rid].tokens[:16]
        lines.append(f"[serve] sample request {rid} tokens[:16]: {sample}")
    return "\n".join(lines)
