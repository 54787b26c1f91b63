"""Per-device costs of one step, counted at the dispatcher while it runs.

The port of ``repro.launch.hlo_analysis``. The JAX package walks the
compiled, SPMD-partitioned HLO of a step; the port has no HLO. Instead
``analyze_step`` runs the step once under a ``TorchDispatchMode`` and
counts every aten op that reaches the dispatcher:

  * the mode sits below DTensor (it declines DTensor operands, so
    DTensor's own dispatch runs and hands it the local ops), so every
    count is PER DEVICE: the op on the local shards, and the collectives
    that DTensor issues between them. The ops DTensor's sharding
    propagation runs on fake tensors of the global shape are skipped;
  * dot FLOPs: ``2 * prod(result dims) * prod(contracted dims)`` for
    ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` (what ``matmul``,
    ``linear`` and ``einsum`` reach aten as, forward and backward) and
    the fused attention ops (two products each);
  * collective bytes from each functional collective's RESULT (JAX's
    convention), under JAX's names: ``all_gather_into_tensor`` ->
    all-gather, ``all_reduce`` -> all-reduce, ``reduce_scatter_tensor``
    -> reduce-scatter, ``all_to_all_single`` -> all-to-all, a permute or
    send / recv -> collective-permute;
  * live bytes: an op's result whose storage is not one of its inputs'
    is a fresh allocation, alive until its storage is freed;
    ``temp_bytes`` is the peak of those over the step (what is live
    beyond the arguments), ``output`` the step's return value.

Loops need no trip counts: eager execution dispatches every repetition
of a loop, so the totals count each trip by construction, and ``loops``
stays empty. The HLO text parser is not ported: the port produces no HLO.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import pytree

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective (``torch.ops._c10d_functional``) -> JAX's name
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
}

_aten = torch.ops.aten


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _mm_flops(a: torch.Tensor, out: torch.Tensor) -> float:
    """Contracted over a's last dim: 2 * |out| * k."""
    return 2.0 * _prod(out.shape) * int(a.shape[-1])


def _attn_flops(q: torch.Tensor, k: torch.Tensor, scale: float) -> float:
    """The two products of a fused attention over (B, H, S, D) q, k:
    2 * B*H*Sq*Sk*D each, ``scale`` times (1 forward, 2 backward)."""
    b, h, sq, d = q.shape
    return scale * 4.0 * b * h * sq * int(k.shape[-2]) * d


def _dot_flops(func, args, out) -> float:
    if func in (_aten.mm.default, _aten.bmm.default):
        return _mm_flops(args[0], out)
    if func in (_aten.addmm.default, _aten.baddbmm.default):
        return _mm_flops(args[1], out)
    name = func.__name__
    if name.startswith("_scaled_dot_product") or name.startswith(
            "_efficient_attention") or name.startswith("_flash_attention"):
        return _attn_flops(args[0], args[1],
                           2.0 if "backward" in name else 1.0)
    return 0.0


@dataclasses.dataclass
class HloCosts:
    dot_flops: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    loops: list = dataclasses.field(default_factory=list)
    unknown_loops: int = 0
    temp_bytes: int = 0
    output: Any = None

    def as_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": dict(self.collective_breakdown),
            "collective_counts": {k: int(v) for k, v in
                                  self.collective_counts.items()},
            "loops": self.loops,
            "unknown_loops": self.unknown_loops,
        }


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _is_wrapper(t: type) -> bool:
    """A tensor subclass that unwraps to local tensors (DTensor, the
    functional collectives' async wrapper); not a fake tensor."""
    return (t is not torch.Tensor and not issubclass(t, torch.nn.Parameter)
            and t.__name__ != "FakeTensor")


class _CostMode(TorchDispatchMode):
    """Counts dot FLOPs, collectives and live bytes of the local ops."""

    def __init__(self, costs: HloCosts):
        super().__init__()
        self.costs = costs
        self.live = 0
        self.peak = 0
        self._tracked: set = set()

    def _release(self, key: int, nbytes: int) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def _track(self, out, inputs) -> None:
        seen = {id(t.untyped_storage()) for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._tracked:
                continue
            seen.add(key)
            self._tracked.add(key)
            nbytes = st.nbytes()
            self.live += nbytes
            weakref.finalize(st, self._release, key, nbytes)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_wrapper(t) for t in types):
            return NotImplemented     # DTensor: let it hand us local ops
        out = func(*args, **kwargs)
        inputs = _tensors((args, kwargs))
        if any(_is_fake(t) for t in inputs + _tensors(out)):
            return out                # DTensor's sharding propagation
        c = self.costs
        c.dot_flops += _dot_flops(func, args, out)
        ns = getattr(func, "namespace", "")
        base = func.__name__.split(".")[0]
        if ns == "_c10d_functional" and base in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[base]
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(out))
            c.collective_bytes += nbytes
            c.collective_breakdown[kind] += nbytes
            c.collective_counts[kind] += 1
        self._track(out, inputs)
        return out


def analyze_step(fn, *args, **kwargs) -> HloCosts:
    """Run ``fn(*args, **kwargs)`` once and return its per-device costs
    (its return value in ``output``)."""
    costs = HloCosts()
    mode = _CostMode(costs)
    with mode:
        costs.output = fn(*args, **kwargs)
    costs.temp_bytes = mode.peak
    costs.collective_breakdown = defaultdict(
        float, {k: costs.collective_breakdown.get(k, 0.0)
                for k in _COLLECTIVES})
    return costs
