"""Byzantine-robust aggregation rules for the sync-PS quorum step.

The port of ``repro.cluster.aggregators``. The PS's mean is a single
point of statistical failure: one worker shipping ``-g`` (or ``8g``, or
noise) moves the aggregate by design — compression and the wire CRC
cannot help, because an adversarial payload frames perfectly. The
classical defense is to replace the mean with a rule whose breakdown
point tolerates ``f`` bad rows out of ``n``:

  mean               the baseline (breakdown 0): the masked average the
                     quorum replay always used.
  norm_clip          rows are scaled down to the masked median gradient
                     norm before averaging: defeats large-norm attacks
                     (``scale`` mode), not directional ones.
  trimmed_mean       per coordinate, drop the f smallest and f largest
                     contributions and average the rest (f = n // 4,
                     at least 1): tolerates f arbitrary rows.
  coordinate_median  per coordinate, the masked median: breakdown 1/2,
                     the most conservative rule here.

Every rule is mask-aware — ``mask`` is the (n,) 0/1 float row mask of
quorum contributors, so excluded uplinks (lost, corrupted, timed out)
never touch the statistic — and works on a tree whose leaves are
stacked over the leading worker dim (a single (n, total) flat buffer is
a tree of one leaf). An empty mask yields a zero update (the round
carries the previous params), matching the scheduler's
``QuorumShortfall`` semantics.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import pytree
from repro_torch.core.registry import Registry

# sorts masked-out rows past every real fp32 gradient without the NaN
# semantics of +inf arithmetic
_BIG = 3.0e38


def _bcast(mask: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (q.dim() - 1))


def _count_scale(mask: torch.Tensor) -> tuple:
    count = mask.sum()
    scale = torch.where(count > 0, 1.0 / torch.clamp_min(count, 1.0),
                        torch.zeros_like(count))
    return count, scale


def _masked_mean(q: torch.Tensor, mask: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    return (q * _bcast(mask, q)).sum(0) * scale


def mean(q_w, mask: torch.Tensor):
    """Masked average: the contributors' sum times 1 / count."""
    _, scale = _count_scale(mask)
    return pytree.tree_map(lambda q: _masked_mean(q, mask, scale), q_w)


def _masked_sort(q: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Ascending per-coordinate sort with masked-out rows pushed past
    the top (the first ``count`` rows are the real values)."""
    return torch.sort(torch.where(_bcast(mask, q) > 0, q,
                                  torch.full_like(q, _BIG)), dim=0).values


def _take_row(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` (a 0-d integer tensor) of the sorted (n, ...) stack,
    without a copy of the index to the host."""
    return torch.index_select(s, 0, idx.reshape(1).long())[0]


def _median_rows(count: torch.Tensor, n: int) -> tuple:
    """The two middle rows (lo, hi) of the first ``count`` of ``n``."""
    cnt = count.to(torch.int32)
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, n - 1)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), 0, n - 1)
    return lo, hi


def trimmed_mean(q_w, mask: torch.Tensor):
    """Per coordinate, drop the ``f`` smallest and ``f`` largest masked
    contributions (f = n//4, at least 1) and average the middle; falls
    back to the masked mean when fewer than ``2f + 1`` rows survive."""
    n = mask.shape[0]
    f = max(1, n // 4)
    count, scale = _count_scale(mask)

    def leaf(q):
        s = _masked_sort(q, mask)
        idx = torch.arange(n, device=q.device).reshape(
            (n,) + (1,) * (q.dim() - 1))
        keep = (idx >= f) & (idx < count - f)
        kept = torch.where(keep, s, torch.zeros_like(s)).sum(0)
        robust = kept / torch.clamp_min(count - 2 * f, 1.0)
        return torch.where(count > 2 * f, robust,
                           _masked_mean(q, mask, scale))

    return pytree.tree_map(leaf, q_w)


def coordinate_median(q_w, mask: torch.Tensor):
    """Per-coordinate masked median (even counts average the two middle
    values) — breakdown point 1/2; an empty mask yields zero."""
    count, _ = _count_scale(mask)
    lo, hi = _median_rows(count, mask.shape[0])

    def leaf(q):
        s = _masked_sort(q, mask)
        med = 0.5 * (_take_row(s, lo) + _take_row(s, hi))
        return torch.where(count > 0, med, torch.zeros_like(med))

    return pytree.tree_map(leaf, q_w)


def norm_clip(q_w, mask: torch.Tensor):
    """Clip each contribution's GLOBAL (whole-tree) norm to the masked
    median norm, then take the masked mean — the large-norm-attack
    defense; directional attacks at honest norms pass through."""
    n = mask.shape[0]
    sq = sum(torch.square(q).reshape(n, -1).sum(dim=1)
             for q in pytree.tree_leaves(q_w))
    norms = torch.sqrt(sq)                                      # (n,)
    s = torch.sort(torch.where(mask > 0, norms,
                               torch.full_like(norms, _BIG))).values
    count, scale = _count_scale(mask)
    lo, hi = _median_rows(count, n)
    med = 0.5 * (_take_row(s, lo) + _take_row(s, hi))
    clip = torch.where(norms > med, med / torch.clamp_min(norms, 1e-30),
                       torch.ones_like(norms))
    return pytree.tree_map(
        lambda q: _masked_mean(q, clip * mask, scale), q_w)


AGGREGATORS: Registry = Registry("aggregator", {
    "mean": mean,
    "norm_clip": norm_clip,
    "trimmed_mean": trimmed_mean,
    "coordinate_median": coordinate_median,
})


def aggregator(name: str) -> Callable:
    return AGGREGATORS.get(name)
