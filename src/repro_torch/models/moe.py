"""Mixture-of-Experts layer (GShard/Mixtral-style grouped capacity
dispatch).

The port of ``repro.models.moe``, with JAX's routing exactly: tokens
are split into GROUPS of at most ``MAX_GROUP`` consecutive tokens of the
flattened (B * S) batch (a group may span batch rows); within a group
each token picks its top-k experts, the gates are renormalised over the
k, and a (token, choice) takes the next free slot of its expert,
counted over (token, choice) pairs in token-major order; a choice past
the expert's capacity ``max(1, min(g, int(g * k * cf / E)))`` is dropped
and contributes nothing. The router aux loss is
``w * E * mean_G sum_e frac_tokens_e * mean_prob_e``.

Where JAX builds a (G, g, k, E, C) one-hot and dispatches and combines
through einsums with it (3 GB at a 4,096-token group of deepseek), the
port moves rows by index: each (expert, slot) names the token that
fills it, the tokens are gathered into an (E, G * C, d) block, the
experts run as batched matmuls over the expert axis, and each kept
choice gathers its expert's output row back. The values are the same
(a one-hot contraction adds exact zeros); the combine's k-term sum may
round in another order. ``rows=True`` makes every batch row its own
groups, as the JAX serve engine's vmapped batch-1 step groups them.

Under the launcher on several ranks (``sharding.rows_split``) a rank
holds its rows of the global batch, and the groups are JAX's groups of
that global batch: where they hold whole shares, each rank dispatches
its own (the ranks' mean aux loss is the mean over all groups); where a
group spans ranks, every rank gathers the global batch's tokens
(``sharding.gather_rows``), runs all its groups and keeps its own rows,
so the dispatch, capacity, drops and aux loss are the one device's.

``MoEConfig.dropless`` (the published DeepSeek-V2-Lite, not a JAX
routing) takes ``_dropless`` instead: no groups, no capacity, every
(token, choice) to its expert. The router's fp32 softmax, a greedy
top-k, the gates the probabilities themselves (not renormalised over
the k, as the capacity path's are); the choices sorted by expert
(stable, so in token order within an expert), each expert's SwiGLU over
exactly its own rows, the rows put back in (token, choice) order and
summed with their gates, in fp32, then the shared experts. Every token
routes alone, so a rank of a data-parallel step routes its own rows and
gathers nothing. Its spans ``moe.route``, ``moe.experts``, ``moe.combine`` and
``moe.shared`` nest under the block's ``block.ffn``. While spans record,
both paths count a layer call's routing in ``obs.metrics``' registry
(``_count``): the busiest expert's choices over the mean, a sample of
the histogram ``moe.expert_load``, and the choices dropped (every
(token, choice) less those computed), added to the counter
``moe.dropped_choices``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, MoEConfig
from repro_torch.obs import metrics, trace

MAX_GROUP = 4096


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple = (),
             dtype=torch.float32) -> dict:
    """Router (fp32, as JAX keeps it), fused expert banks (E, d, f) x2 +
    (E, f, d), and the shared experts' gated MLPs; ``lead`` prepends
    the scanned layers' n_rep dim."""
    mcfg = cfg.moe
    d, f, e = cfg.d_model, mcfg.d_ff_expert, mcfg.n_experts
    p = {
        "router": layers.dense_init(gen, d, e, lead=lead,
                                    dtype=torch.float32),
        "w_gate": layers.normal(gen, lead + (e, d, f), scale=1.0 / d**0.5,
                                dtype=dtype),
        "w_up": layers.normal(gen, lead + (e, d, f), scale=1.0 / d**0.5,
                              dtype=dtype),
        "w_down": layers.normal(gen, lead + (e, f, d), scale=1.0 / f**0.5,
                                dtype=dtype),
    }
    for i in range(mcfg.n_shared):
        p[f"shared_{i}"] = layers.mlp_init(gen, d, f, glu=True, lead=lead,
                                           dtype=dtype)
    return p


def _group_shape(n_tokens: int) -> tuple[int, int]:
    """(n_groups, group_size) with group_size <= MAX_GROUP dividing T."""
    g = min(n_tokens, MAX_GROUP)
    while n_tokens % g:
        g -= 1
    return n_tokens // g, g


def _capacity(mcfg: MoEConfig, group_size: int) -> int:
    cap = int(group_size * mcfg.top_k * mcfg.capacity_factor
              / mcfg.n_experts)
    return max(1, min(group_size, cap))


def route(p: dict, cfg: ModelConfig, xg: torch.Tensor) -> tuple:
    """Routing of (G, g, d) groups: (probs (G, g, E), gates (G, g, k)
    renormalised, expert ids (G, g, k), slot of each choice within its
    expert (G, g, k), kept (G, g, k) bool)."""
    mcfg = cfg.moe
    n_groups, g, _ = xg.shape
    k = mcfg.top_k
    logits = layers.dense(p["router"], xg.float())
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = ids.reshape(n_groups, g * k)
    onehot = F.one_hot(flat, mcfg.n_experts)
    pos = (onehot.cumsum(1) - onehot).gather(-1, flat[..., None])
    pos = pos.reshape(n_groups, g, k)
    return probs, gates, ids, pos, pos < _capacity(mcfg, g)


def _dispatch(ids: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
              e: int, cap: int) -> tuple:
    """(slot (G, g, k), src (E * G * C + 1,)): the slot (e, group, c) of
    each kept choice in the (E, G * C) block, a dropped choice pointing
    one past the block (a row of zeros); and the token that fills each
    slot, t (a zero row) where none does."""
    n_groups, g, _ = ids.shape
    t = n_groups * g
    dev = ids.device
    grp = torch.arange(n_groups, device=dev)[:, None, None]
    slot = torch.where(keep, (ids * n_groups + grp) * cap + pos,
                       e * n_groups * cap)
    tok = torch.arange(t, device=dev).view(n_groups, g, 1).expand_as(slot)
    src = torch.full((e * n_groups * cap + 1,), t, dtype=torch.long,
                     device=dev)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    return slot, src


def _kept_counts(ids: torch.Tensor, keep: torch.Tensor, e: int
                 ) -> torch.Tensor:
    """(G, E) kept choices per group and expert."""
    n_groups = ids.shape[0]
    kept = torch.zeros((n_groups, e), dtype=torch.float32, device=ids.device)
    kept.scatter_add_(1, ids.reshape(n_groups, -1),
                      keep.reshape(n_groups, -1).float())
    return kept


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              act: str = "silu", rows: bool = False) -> tuple:
    """x: (B, S, d). Returns (out, aux_loss). On a mesh whose batch shards
    hold whole groups of the global batch, each device dispatches its own
    tokens (``sharding.batch_local``); a rank of a data-parallel step
    groups as the global batch does (the module's docstring)."""
    if cfg.moe.dropless:
        return _dropless(p, cfg, x, act)
    b, s, _ = x.shape
    t = b * s
    if rows:
        per_row, g = _group_shape(s)
        n_groups = b * per_row
    else:
        n_groups, g = _group_shape(t)
    if sharding.is_dtensor(x):
        b_local = sharding.local_shape(
            (b,), sharding.batch_spec((b,), x.device_mesh), x.device_mesh)[0]
        if (s if rows else b_local * s) % g == 0:
            return sharding.batch_local(
                lambda p_, x_: moe_apply(p_, cfg, x_, act=act, rows=rows),
                p, x, whole=("router",))
    mesh = sharding.split_rows()
    if mesh is not None and not rows:
        group = mesh.get_group("data")
        n_all, g = _group_shape(group.size() * t)
        if t % g:       # a group spans ranks
            lo = mesh.get_local_rank("data") * b
            out, aux = _grouped(p, cfg, sharding.gather_rows(x, mesh),
                                n_all, g, act)
            return out[lo:lo + b], aux
        n_groups = t // g
    return _grouped(p, cfg, x, n_groups, g, act)


def _grouped(p: dict, cfg: ModelConfig, x: torch.Tensor, n_groups: int,
             g: int, act: str) -> tuple:
    """(out, aux) of x (B, S, d) dispatched as ``n_groups`` groups of
    ``g`` consecutive tokens."""
    mcfg = cfg.moe
    b, s, d = x.shape
    t = b * s
    cap = _capacity(mcfg, g)
    e = mcfg.n_experts
    xt = x.reshape(t, d)
    probs, gates, ids, pos, keep = route(p, cfg, xt.view(n_groups, g, d))

    # on a mesh the index arithmetic runs on gathered ids (DTensor has
    # no strategy for its scatters): the all-gather XLA inserts
    slot, src = sharding.replicate_call(_dispatch, ids, pos, keep, e, cap)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    xe = x_pad.index_select(0, src[:-1]).view(e, n_groups * cap, d)
    a = layers.ACTS[act]
    h = a(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(-1, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    picked = ye.index_select(0, slot.reshape(-1)).view(t, -1, d).float()
    w = (gates * keep).reshape(t, -1, 1)
    out = (picked * w).sum(1).reshape(b, s, d)

    for i in range(mcfg.n_shared):
        out = out + layers.mlp(p[f"shared_{i}"], xt, act=act,
                               glu=True).float().reshape(b, s, d)

    # load-balance auxiliary loss (mean over groups)
    kept = sharding.replicate_call(_kept_counts, ids, keep, e)
    frac_tokens = kept / max(1.0, float(g))
    aux = mcfg.router_aux_weight * e * (frac_tokens * probs.mean(1)
                                        ).sum(-1).mean()
    if trace.tracer().recording():
        _count(kept.sum(0).tolist(), ids.numel())
    return out.to(x.dtype), aux


def _count(rows: list, choices: int) -> None:
    """A layer call's routing into the metrics registry (the module's
    docstring): ``rows`` the choices each expert computed, ``choices``
    every (token, choice). The registry's own switch is left aside: the
    count records while spans do."""
    reg = metrics.registry()
    total = sum(rows)
    if total:
        reg.histogram("moe.expert_load").observe(
            max(rows) * len(rows) / total)
    reg.counter("moe.dropped_choices").inc(choices - total)


def _dropless(p: dict, cfg: ModelConfig, x: torch.Tensor, act: str
              ) -> tuple:
    """(out, aux) of x (B, S, d) with every choice kept (the module's
    docstring). One host sync a call: the experts' row counts, which
    slice the sorted rows. aux is the capacity path's formula over the
    batch as one group, with nothing dropped."""
    mcfg = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, mcfg.top_k, mcfg.n_experts
    xt = x.reshape(t, d)
    with trace.span("moe.route"):
        probs = torch.softmax(layers.dense(p["router"], xt.float()), dim=-1)
        gates, ids = torch.topk(probs, k, dim=-1)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=e)
        rows = counts.tolist()
        xs = xt.index_select(0, order // k)
    with trace.span("moe.experts"):
        a = layers.ACTS[act]
        # each expert writes its rows in place, unless autograd records
        # the call (an ``out=`` product has no gradient): then one cat
        record = torch.is_grad_enabled() and any(
            w.requires_grad for w in (xs, p["w_gate"], p["w_up"],
                                      p["w_down"]))
        ys = [] if record else torch.empty_like(xs)
        start = 0
        for i, n in enumerate(rows):
            if n:
                xi = xs[start:start + n]
                h = a(xi @ p["w_gate"][i]) * (xi @ p["w_up"][i])
                if record:
                    ys.append(h @ p["w_down"][i])
                else:
                    torch.matmul(h, p["w_down"][i], out=ys[start:start + n])
            start += n
        if record:
            ys = torch.cat(ys)
    with trace.span("moe.combine"):
        back = torch.empty_like(ys).index_copy_(0, order, ys)
        out = (back.view(t, k, d).float() * gates[..., None]).sum(1)
    with trace.span("moe.shared"):
        for i in range(mcfg.n_shared):
            out = out + layers.mlp(p[f"shared_{i}"], xt, act=act,
                                   glu=True).float()
    if trace.tracer().recording():
        _count(rows, t * k)
    aux = mcfg.router_aux_weight * e * (counts.float() / t
                                        * probs.mean(0)).sum()
    return out.reshape(b, s, d).to(x.dtype), aux
