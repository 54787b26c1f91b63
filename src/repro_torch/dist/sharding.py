"""Sharding rules for the production (mesh) tier, on DTensor.

The port of ``repro.dist.sharding``. One place holds every placement
decision, by the JAX package's rules:

  * params  — FSDP + tensor parallelism by parameter *name*:
      - matmul weights (d_in, d_out): column-parallel ('data', 'model')
        by default; output/down projections are row-parallel
        ('model', 'data');
      - stacked banks (the scanned layer stacks, MoE expert banks) carry
        leading replicated dims and shard their input dim over ALL
        data-like axes (('pod', 'data') on the multi-pod mesh);
      - the embedding table is fully sharded ('model', 'data'); the
        activations it produces are re-pinned by ``constrain_act``;
      - vectors (norm scales, biases) are replicated.
  * batches — leading batch dim over the activation batch axes
    (``set_activation_batch_axes``), skipped when the dim does not divide.
  * caches  — (batch, seq, heads, head_dim) KV layouts shard batch by
    'data' and heads by 'model', falling back to head_dim when the head
    count does not divide the model axis.

A rule returns a JAX-shaped spec: a tuple with one entry per tensor dim,
each ``None``, an axis name or a tuple of names — what
``jax.sharding.PartitionSpec`` holds, so the two compare entry for
entry. ``placements`` turns a spec into DTensor placements, one per mesh
dim (a tensor dim sharded over ('pod', 'data') is ``Shard(d)`` on both
mesh dims, pod-major as JAX's tuple is). ``_maybe`` is the single
divisibility gate: every rule degrades to replication when a dim does not
divide its axes.

``constrain_act`` / ``constrain_heads`` are the identity on a plain
tensor, so every one-card path (and every kernel) sees exactly what it
saw before; on a DTensor they redistribute to the batch, or heads /
head_dim, placement. So are the helpers the models call where DTensor's
own op-by-op planning has no strategy, or a costly one, for what XLA
lays out from the whole program: ``unshard`` (FSDP's gather of a
layer's parameters), ``heads_local`` (attention on each device's rows
and heads), ``batch_local`` (MoE dispatch on each device's groups),
``take_rows`` / ``take_label_logits`` (vocab-parallel lookup and label
gather), ``split_heads`` / ``merge_heads``, ``write_rows`` (in-place
cache writes), ``take_layer`` / ``put_layer`` (a layer of a
layer-sharded cache, and its write-back) and
``replicate_call`` (an op run on replicated operands: the all-gather
XLA would insert).

The launcher's data parallelism runs on plain tensors, one rank a card,
with the state replicated, over JAX's ``(n, 1)`` ('data', 'model') mesh:
``local_batch`` is this rank's rows of a global batch by the batch rule
(the counterpart of ``device_put`` by ``batch_shardings``), and
``rows_split`` marks a step whose batch rows are split over 'data', so
that a layer that groups rows across the batch (the MoE dispatch) forms
JAX's groups of the global batch (``gather_rows``).

``torch.distributed.tensor`` is imported only where a DTensor is built
or met, so importing this module (the models do) costs nothing.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import pytree

# Activation-batch axes: ('data',) single-pod, ('pod', 'data') multi-pod.
# Stacked parameter banks reuse this tuple as their FSDP axis set.
_ACT_BATCH_AXES: tuple = ("data",)

# Modules whose 2D weight is row-parallel (contracting dim sharded by
# 'model'): attention/mixer output projections and MLP down projections.
_ROW_PARALLEL = ("o", "down", "out")

# MoE expert banks: (n_experts, d_in, d_out) with the expert dim replicated.
_MOE_COL = ("w_gate", "w_up")
_MOE_ROW = ("w_down",)


def set_activation_batch_axes(axes: Sequence[str]) -> None:
    """Declare the mesh axes that carry the batch dim of activations."""
    global _ACT_BATCH_AXES
    _ACT_BATCH_AXES = tuple(axes)


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``) or of a JAX-style mesh object (``axis_names``,
    ``devices.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _maybe(axis, dim: int, mesh):
    """``axis`` if ``dim`` divides its mesh size, else None (replicate).

    ``axis`` may be a single name or a tuple of names (product of sizes);
    names absent from the mesh always replicate.
    """
    if axis is None:
        return None
    sizes = _axis_sizes(mesh)
    names = axis if isinstance(axis, tuple) else (axis,)
    total = 1
    for a in names:
        if a not in sizes:
            return None
        total *= sizes[a]
    return axis if total > 0 and dim % total == 0 else None


def _path_names(path) -> tuple:
    """A key path -> tuple of names. Takes the port's paths (tuples of
    dict keys and sequence indices, ``pytree.tree_flatten_with_path``)
    and objects carrying ``key`` / ``name`` / ``idx`` as JAX's keys do."""
    names = []
    for p in path:
        if hasattr(p, "key"):
            names.append(str(p.key))
        elif hasattr(p, "name"):
            names.append(str(p.name))
        elif hasattr(p, "idx"):
            names.append(str(p.idx))
        else:
            names.append(str(p))
    return tuple(names)


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------


def param_spec(path, shape: tuple, mesh) -> tuple:
    """The spec of one parameter leaf, keyed by its tree path."""
    names = _path_names(path)
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""

    if leaf == "embed" and len(shape) == 2:
        # fully sharded table: vocab x model, features x data (FSDP)
        return (_maybe("model", shape[0], mesh),
                _maybe("data", shape[1], mesh))

    if leaf in _MOE_COL + _MOE_ROW and len(shape) >= 3:
        lead = (None,) * (len(shape) - 2)
        din, dout = shape[-2], shape[-1]
        if leaf in _MOE_ROW:
            return (*lead, _maybe("model", din, mesh),
                    _maybe(_ACT_BATCH_AXES, dout, mesh))
        return (*lead, _maybe(_ACT_BATCH_AXES, din, mesh),
                _maybe("model", dout, mesh))

    if len(shape) >= 2:
        lead = (None,) * (len(shape) - 2)
        din, dout = shape[-2], shape[-1]
        # stacked (scan) params shard over the full data-axis tuple; plain
        # 2D weights use the bare 'data' axis
        dax = _ACT_BATCH_AXES if lead else "data"
        row = parent in _ROW_PARALLEL or (parent == "v" and "ffn" in names)
        if row:
            return (*lead, _maybe("model", din, mesh),
                    _maybe(dax, dout, mesh))
        return (*lead, _maybe(dax, din, mesh), _maybe("model", dout, mesh))

    return ()   # vectors / scalars replicate


# --------------------------------------------------------------------------
# Batches and caches
# --------------------------------------------------------------------------


def batch_spec(shape: tuple, mesh) -> tuple:
    """Leading dim over the activation batch axes; everything else
    replicated."""
    if not shape:
        return ()
    return (_maybe(_ACT_BATCH_AXES, shape[0], mesh),
            *(None,) * (len(shape) - 1))


def _heads_spec(ba, h: int, dh: int, mesh) -> tuple:
    if _maybe("model", h, mesh):
        return (ba, None, "model", None)
    if _maybe("model", dh, mesh):
        return (ba, None, None, "model")
    return (ba, None, None, None)


def cache_spec(path, shape: tuple, mesh) -> tuple:
    """KV caches (batch, seq, heads, head_dim): batch x 'data', heads x
    'model' with head_dim fallback; other state leaves shard batch only."""
    del path
    if len(shape) == 4:
        b, _, h, dh = shape
        return _heads_spec(_maybe("data", b, mesh), h, dh, mesh)
    if not shape:
        return ()
    return (_maybe("data", shape[0], mesh), *(None,) * (len(shape) - 1))


# --------------------------------------------------------------------------
# Specs made real: DTensor placements
# --------------------------------------------------------------------------


def _dt():
    import torch.distributed.tensor as dt
    return dt


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (never true before DTensor is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` on every mesh dim named
    by tensor dim d's entry, ``Replicate()`` elsewhere."""
    dt = _dt()
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(dt.Shard(dims[0]) if dims else dt.Replicate())
    return tuple(out)


def replicated(mesh) -> tuple:
    return tuple(_dt().Replicate() for _ in mesh.mesh_dim_names)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """A leaf's shard shape on one device under ``spec``."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for name in (e if isinstance(e, tuple) else (e,)):
            if name is not None:
                out[d] //= sizes[name]
    return tuple(out)


def _leaf_shape(leaf) -> tuple:
    return tuple(leaf.shape)


def params_shardings(params, mesh):
    return pytree.tree_map_with_path(
        lambda p, leaf: placements(param_spec(p, _leaf_shape(leaf), mesh),
                                   mesh), params)


def batch_shardings(batch, mesh):
    return pytree.tree_map(
        lambda leaf: placements(batch_spec(_leaf_shape(leaf), mesh), mesh),
        batch)


def cache_shardings(state, mesh):
    """The decode state's placements; its non-tensor leaves (a cache's
    window) as they are."""
    return pytree.tree_map_with_path(
        lambda p, leaf: placements(cache_spec(p, _leaf_shape(leaf), mesh),
                                   mesh)
        if isinstance(leaf, torch.Tensor) else leaf, state)


def distribute_leaf(leaf: torch.Tensor, spec: tuple, mesh):
    """``leaf`` as a DTensor laid out by ``spec``. A ``meta`` leaf
    becomes a DTensor over a ``meta`` shard of the local shape, so
    nothing is allocated; any other leaf is scattered by
    ``distribute_tensor``."""
    dt = _dt()
    pl = placements(spec, mesh)
    if leaf.device.type != "meta":
        return dt.distribute_tensor(leaf, mesh, pl)
    local = torch.empty(local_shape(_leaf_shape(leaf), spec, mesh),
                        dtype=leaf.dtype, device="meta")
    return dt.DTensor.from_local(local, mesh, pl, run_check=False,
                                 shape=leaf.shape, stride=leaf.stride())


def distribute(tree, mesh, spec_fn: Callable):
    """Every leaf of ``tree`` as a DTensor laid out by
    ``spec_fn(path, leaf)`` (``distribute_leaf``)."""
    return pytree.tree_map_with_path(
        lambda p, leaf: distribute_leaf(leaf, spec_fn(p, leaf), mesh), tree)


# --------------------------------------------------------------------------
# Activation constraints (the identity off a mesh)
# --------------------------------------------------------------------------


def _pinned(x, spec: tuple, *, grad_back: bool = False):
    """``x`` redistributed to ``spec``'s placement. Its gradient is
    pinned there too (``with_sharding_constraint``'s rule: the cotangent
    takes the same sharding; a plain ``redistribute`` would send it back
    to x's own placement, and the replicated gradient of the loss's sum
    would reach every block replicated), or with ``grad_back`` returned
    to x's own placement (where the op before the pin must see it so)."""
    pl = placements(spec, x.device_mesh)
    if tuple(x.placements) == pl and not x.requires_grad:
        return x
    back = pl
    if grad_back and not any(p.is_partial() for p in x.placements):
        back = tuple(x.placements)
    return _Pin.apply(x, pl, back)


class _Pin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl, back):
        ctx.back = back
        return x if tuple(x.placements) == pl else x.redistribute(
            x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.back:
            g = g.redistribute(g.device_mesh, ctx.back)
        # a local gradient may come back as a strided view (a transpose
        # inside a local attention); the backward of a view before the
        # pin needs it contiguous
        return g.contiguous(), None, None


def constrain_act(x):
    """Pin an activation's batch-dim placement, and its gradient's
    (identity on a plain tensor)."""
    if not is_dtensor(x):
        return x
    return _pinned(x, batch_spec(tuple(x.shape), x.device_mesh))


def constrain_heads(x):
    """Pin a (batch, seq, heads, head_dim) activation: batch over the data
    axes, heads over 'model' (head_dim fallback for narrow GQA); its
    gradient returns to its own placement (a repeated KV head's gradient
    is summed over its group there). Identity on a plain tensor."""
    if not is_dtensor(x) or x.ndim != 4:
        return x
    mesh = x.device_mesh
    b, _, h, dh = x.shape
    return _pinned(
        x, _heads_spec(_maybe(_ACT_BATCH_AXES, b, mesh), h, dh, mesh),
        grad_back=True)


def split_heads(x, n: int, d: int):
    """``x.reshape(*lead, n, d)`` of a (..., n * d) projection. On a mesh
    whose shards of the last dim do not hold whole heads (8 KV heads on
    a 16-way 'model' axis), that dim is gathered first: DTensor cannot
    unflatten a dim that splits unevenly."""
    if is_dtensor(x):
        last = x.ndim - 1
        ways = 1
        for i, p in enumerate(x.placements):
            if p.is_shard(last):
                ways *= x.device_mesh.shape[i]
        if ways > 1 and n % ways:
            dt = _dt()
            x = x.redistribute(x.device_mesh, tuple(
                dt.Replicate() if p.is_shard(last) else p
                for p in x.placements))
        return _grad_as_value(x.reshape(*x.shape[:-1], n, d))
    return x.reshape(*x.shape[:-1], n, d)


def _grad_as_value(y):
    """``y``, with its gradient brought to ``y``'s own placement before
    it reaches the reshape that made ``y`` (DTensor cannot undo the
    reshape on a gradient sharded otherwise)."""
    if not y.requires_grad:
        return y
    pl = tuple(y.placements)
    dt = _dt()
    back = tuple(dt.Replicate() if p.is_partial() else p for p in pl)
    return _Pin.apply(y, pl, back)


def heads_local(fn: Callable, q, k, v, *rest, **kw):
    """``fn(q, k, v, *rest, **kw)``: attention over (B, S, H, D) q, k, v.
    On a mesh each device attends its own batch rows and heads (the
    attention is independent over both): the batch over the data axes,
    the heads over 'model' when the query and KV head counts divide it
    (a query with several positions repeats each KV head to its group
    when only the query heads divide), else every head on every device;
    the other DTensor arguments (a mask over the batch) take the batch
    layout, and the result comes back in the heads layout. DTensor would
    otherwise run the softmax's every op, and re-shard the (B * H)
    batched products. Plain tensors: ``fn(q, k, v, *rest, **kw)``."""
    if not is_dtensor(q):
        return fn(q, k, v, *rest, **kw)
    dt = _dt()
    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    heads = _maybe("model", hq, mesh)
    if heads and not _maybe("model", hkv, mesh):
        if q.shape[1] > 1:
            k, v = (t.repeat_interleave(hq // hkv, dim=2) for t in (k, v))
        else:
            heads = None
    ba = _maybe(_ACT_BATCH_AXES, q.shape[0], mesh)
    spec4 = (ba, None, heads, None)

    def local(t):
        if not is_dtensor(t):
            return t
        spec = spec4 if t.ndim == 4 else (ba,) + (None,) * (t.ndim - 1)
        return _pinned(t, spec, grad_back=True).to_local()

    out = fn(local(q), local(k), local(v), *(local(a) for a in rest), **kw)
    return dt.DTensor.from_local(out, mesh, placements(spec4, mesh),
                                 run_check=False)


def merge_heads(x):
    """``x.reshape(*lead, n * d)`` of a (..., n, d) attention output. On
    a mesh a sharded head_dim (the fallback for a head count the 'model'
    axis does not divide), or heads split unevenly, are gathered first:
    DTensor cannot flatten them into the features, nor unflatten a
    gradient sharded otherwise, so the gradient is brought to the
    result's placement."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], -1)
    mesh, n = x.device_mesh, x.shape[-2]
    uneven = [i for i, p in enumerate(x.placements) if p.is_shard(x.ndim - 1)
              or (p.is_shard(x.ndim - 2) and n % mesh.shape[i])]
    if uneven:
        dt = _dt()
        x = x.redistribute(mesh, tuple(
            dt.Replicate() if i in uneven else p
            for i, p in enumerate(x.placements)))
    return _grad_as_value(x.reshape(*x.shape[:-2], -1))


def batch_local(fn: Callable, params, x, *, whole: tuple = ()):
    """``fn(params, x) -> (out, aux)`` run on each device's own batch rows
    with its own parameter shards: for a layer whose rows are independent
    groups (the MoE dispatch groups its tokens), which DTensor would
    otherwise run on gathered tokens. ``x`` (B, ...) is laid out by the
    batch rule; the parameters are unsharded over the data axes and keep
    their 'model' shards, so ``out`` is summed over 'model' when any of
    them is sharded there; the scalar ``aux``, a mean over the groups,
    is averaged over the data axes. Without a DTensor it is
    ``fn(params, x)``. The top-level entries named in ``whole`` (the
    router) are gathered whole on every device."""
    if not is_dtensor(x):
        return fn(params, x)
    dt = _dt()
    x = constrain_act(x)
    mesh = x.device_mesh

    def gather(t):
        return t.redistribute(mesh, replicated(mesh)) \
            if is_dtensor(t) else t

    params = {k: pytree.tree_map(gather if k in whole else unshard, v)
              for k, v in params.items()}
    local_p = pytree.tree_map(lambda t: t.to_local() if is_dtensor(t)
                              else t, params)
    split = any(p.is_shard() for t in pytree.tree_leaves(params)
                if is_dtensor(t) for p in t.placements)
    out, aux = fn(local_p, x.to_local())
    names = mesh.mesh_dim_names
    out_pl = tuple(dt.Partial() if names[i] == "model" and split else p
                   for i, p in enumerate(x.placements))
    aux_pl = tuple(dt.Partial("avg") if p.is_shard() else dt.Replicate()
                   for p in x.placements)
    out = dt.DTensor.from_local(out, mesh, out_pl, run_check=False,
                                shape=x.shape, stride=x.stride())
    if isinstance(aux, torch.Tensor):
        aux = dt.DTensor.from_local(aux, mesh, aux_pl, run_check=False)
    return out, aux


def take_rows(table, ids):
    """``table[ids]``: an embedding lookup. On a mesh each device looks
    up the ids that fall in its slice of the table's rows (zero
    elsewhere) and the partial rows are summed over those mesh axes
    (Megatron's vocab-parallel embedding), with the ids in their batch
    layout; DTensor's own lookup leaves its backward (an ``index_put``)
    to a strategy that some releases reject."""
    if not is_dtensor(table):
        return table[ids]
    dt = _dt()
    mesh = table.device_mesh
    row = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    tab_pl = tuple(p if i in row[:1] else dt.Replicate()
                   for i, p in enumerate(table.placements))
    if tab_pl != tuple(table.placements):
        table = table.redistribute(mesh, tab_pl)
    ba = _maybe(_ACT_BATCH_AXES, ids.shape[0], mesh)
    ids_spec = (ba,) + (None,) * (ids.ndim - 1)
    ids_pl = placements(ids_spec, mesh)
    local_ids = (ids.redistribute(mesh, ids_pl) if is_dtensor(ids)
                 else dt.distribute_tensor(ids, mesh, ids_pl)).to_local()
    local = table.to_local()
    if not row:
        out = local[local_ids]
        out_pl = placements(ids_spec + (None,), mesh)
    else:
        md = row[0]
        n = local.shape[0]
        idx = local_ids - mesh.get_coordinate()[md] * n
        hit = ((idx >= 0) & (idx < n))[..., None]
        out = torch.where(hit, local[idx.clamp(0, n - 1)],
                          torch.zeros((), dtype=local.dtype,
                                      device=local.device))
        out_pl = tuple(dt.Partial() if i == md else p for i, p in
                       enumerate(placements(ids_spec + (None,), mesh)))
    return dt.DTensor.from_local(out, mesh, out_pl, run_check=False)


def take_label_logits(logits, labels):
    """``logits.gather(-1, labels[..., None])[..., 0]``. On a mesh each
    device gathers the labels that fall in its vocab slice (zero
    elsewhere) and the partial results are summed: Megatron's
    vocab-parallel cross entropy, where JAX takes a one-hot dot.
    DTensor's own gather would build the global logits in its backward.
    Pending partial sums are reduced first, and a vocab sharded over
    several mesh dims keeps only the first."""
    if not is_dtensor(logits):
        return logits.gather(-1, labels[..., None])[..., 0]
    dt = _dt()
    mesh, vd = logits.device_mesh, logits.ndim - 1
    pl, md = [], None
    for i, p in enumerate(logits.placements):
        if p.is_partial() or (p.is_shard(vd) and md is not None):
            p = dt.Replicate()
        elif p.is_shard(vd):
            md = i
        pl.append(p)
    if tuple(pl) != tuple(logits.placements):
        logits = logits.redistribute(mesh, tuple(pl))
    lab_pl = tuple(dt.Replicate() if i == md else p for i, p in enumerate(pl))
    local = logits.to_local()
    lab = labels.redistribute(mesh, lab_pl).to_local()
    v_local = local.shape[-1]
    if md is None:      # the whole vocab on every device
        val = local.gather(-1, lab[..., None])[..., 0]
        return dt.DTensor.from_local(val, mesh, lab_pl, run_check=False)
    idx = lab - mesh.get_coordinate()[md] * v_local
    hit = (idx >= 0) & (idx < v_local)
    val = local.gather(-1, idx.clamp(0, v_local - 1)[..., None])[..., 0]
    val = torch.where(hit, val, torch.zeros_like(val))
    part = tuple(dt.Partial() if i == md else p for i, p in enumerate(lab_pl))
    return dt.DTensor.from_local(val, mesh, part, run_check=False
                                 ).redistribute(mesh, lab_pl)


def unshard(x):
    """A parameter as a layer uses it on a mesh (FSDP's unshard): its
    shards over the data axes are gathered, its 'model' shards kept (the
    Megatron layout), and a vector (a norm scale, a bias) is gathered
    whole; the gradient flows back as a reduce-scatter. Left to itself,
    DTensor would move the larger activations instead (a batch-sharded
    activation re-sharded onto a weight's contraction dim, the features
    of a whole batch scaled by a sharded scale). Anything but a DTensor
    is returned as it is."""
    if not is_dtensor(x):
        return x
    dt = _dt()
    names = x.device_mesh.mesh_dim_names
    pl = tuple(dt.Replicate() if x.ndim < 2 or names[i] != "model" else p
               for i, p in enumerate(x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _layer_dims(x) -> list:
    """The mesh dims a DTensor's leading (layer) dim is sharded over."""
    return [j for j, p in enumerate(x.placements) if p.is_shard(0)]


def _holds_layer(x, lay: list, i: int) -> tuple:
    """Whether this device's shard of ``x`` holds layer i, and i's index
    in that shard."""
    mesh, n = x.device_mesh, x.to_local().shape[0]
    coord = mesh.get_coordinate()
    chunk = 0
    for j in lay:
        chunk = chunk * mesh.shape[j] + coord[j]
    return chunk == i // n, i % n


def take_layer(x, i: int):
    """``x[i]`` of a stacked state leaf. On a mesh whose layer dim is
    sharded (JAX's cache rule puts it on 'data' when the layer count
    divides), each device gets layer i from the device holding it: the
    holder's slice, and zeros from every other device, summed over those
    mesh axes (an all-reduce of one layer, where DTensor's select would
    gather the whole stack). The slice is then a copy, which
    ``put_layer`` writes back once it is updated."""
    if not is_dtensor(x):
        return x[i]
    lay = _layer_dims(x)
    if not lay:
        return x[i]
    dt = _dt()
    mesh = x.device_mesh
    held, k = _holds_layer(x, lay, i)
    local = x.to_local()[k]
    if not held:
        local = torch.zeros_like(local)
    part = tuple(dt.Partial() if j in lay else
                 dt.Shard(p.dim - 1) if p.is_shard() else p
                 for j, p in enumerate(x.placements))
    y = dt.DTensor.from_local(local, mesh, part, run_check=False)
    return y.redistribute(mesh, tuple(dt.Replicate() if j in lay else p
                                      for j, p in enumerate(part)))


def put_layer(x, i: int, y) -> None:
    """Layer i of a stacked state leaf ``x`` set to ``y`` in place, where
    ``take_layer`` gave a copy (a layer-sharded DTensor): the device
    holding layer i copies ``y``'s shard into its own. Elsewhere
    ``x[i]`` was a view that took the update itself, and nothing is
    done."""
    if not is_dtensor(x):
        return
    lay = _layer_dims(x)
    if not lay:
        return
    held, k = _holds_layer(x, lay, i)
    if held:
        x.to_local()[k].copy_(y.to_local())


def unshard_tree(tree):
    return pytree.tree_map(unshard, tree)


def like(x, ref):
    """``x`` in ``ref``'s placement when both are DTensors (a gradient
    reduce-scattered onto its parameter's shards, as FSDP and JAX's
    ``out_shardings`` have it); else ``x``."""
    if not (is_dtensor(x) and is_dtensor(ref)) or \
            tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def write_rows(dst, rows, slot, value) -> None:
    """``dst[rows, slot] = value`` in place: row b of ``dst``
    (B, slots, ...) takes ``value[b]`` at slot ``slot[b]``; ``rows`` is
    ``arange(B)``, built once by the caller for all its writes. On a mesh
    (DTensor has no in-place strategy for this ``index_put_``) each
    device writes its own shard: the slots and values are laid out like
    the cache's rows, and where the slot dim is sharded a device writes
    only the slots it holds (``rows`` is then unused)."""
    if not is_dtensor(dst):
        dst[rows, slot] = value
        return
    dt = _dt()
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    if any(p.is_partial() for p in pl):
        raise NotImplementedError(f"write_rows into a cache placed {pl}")
    rep = dt.Replicate()
    row_pl = tuple(p if p.is_shard(0) else rep for p in pl)
    val_pl = tuple(dt.Shard(p.dim - 1) if p.is_shard() and p.dim > 1
                   else (p if p.is_shard(0) else rep) for p in pl)
    local = dst.to_local()
    idx = slot.redistribute(mesh, row_pl).to_local()
    val = value.redistribute(mesh, val_pl).to_local().to(local.dtype)
    n_local = local.shape[1]
    coord = mesh.get_coordinate()
    chunk = 0
    for i, p in enumerate(pl):
        if p.is_shard(1):
            chunk = chunk * mesh.shape[i] + coord[i]
    j = idx - chunk * n_local
    hit = ((j >= 0) & (j < n_local)).view(
        idx.shape + (1,) * (val.ndim - 1))
    j = j.clamp(0, n_local - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, j] = torch.where(hit, val, local[rows, j])


def replicate_call(fn: Callable, *args: Any, **kwargs: Any):
    """``fn(*args, **kwargs)`` for an op DTensor has no sharding strategy
    for: every DTensor operand is gathered to ``Replicate()`` (the
    all-gather XLA inserts), ``fn`` runs on the local tensors, and each
    tensor result comes back as a replicated DTensor. Without a DTensor
    operand it is ``fn(*args, **kwargs)``."""
    flat = list(args) + list(kwargs.values())
    mesh = next((a.device_mesh for a in flat if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args, **kwargs)
    dt = _dt()
    rep = replicated(mesh)

    def local(a):
        return a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a

    out = fn(*(local(a) for a in args),
             **{k: local(v) for k, v in kwargs.items()})

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return dt.DTensor.from_local(o, mesh, rep, run_check=False)
        return o

    if isinstance(out, (tuple, list)):
        return type(out)(wrap(o) for o in out)
    return wrap(out)


# --------------------------------------------------------------------------
# Data parallelism on plain tensors (the launcher on several ranks)
# --------------------------------------------------------------------------


def local_batch(batch: dict, mesh) -> tuple[dict, bool]:
    """(this rank's rows of a global batch, whether the rows were split).

    Each leaf's leading dim is split over the activation batch axes by
    ``batch_spec``, this rank taking the chunk at its coordinate along
    them; where their size does not divide it, every rank takes the
    whole batch, as ``_maybe`` replicates it in JAX. The rows are views
    of the batch."""
    sizes = _axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, ways = 0, 1
    for a in _ACT_BATCH_AXES:
        index = index * sizes[a] + coord[a]
        ways *= sizes[a]
    split = {k: v.ndim > 0 and batch_spec(tuple(v.shape), mesh)[0]
             is not None for k, v in batch.items()}
    if len(set(split.values())) > 1:
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        raise ValueError(f"batch leaves split unevenly over the data axes: "
                         f"{shapes}")
    if ways == 1 or not all(split.values()):
        return batch, False
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // ways
        out[k] = v[index * n:(index + 1) * n]
    return out, True


_SPLIT_ROWS = None


@contextlib.contextmanager
def rows_split(mesh):
    """Within the block (a forward and its backward), the batch rows a
    layer sees are this rank's share of a global batch split over the
    mesh's 'data' axis."""
    global _SPLIT_ROWS
    prev, _SPLIT_ROWS = _SPLIT_ROWS, mesh
    try:
        yield
    finally:
        _SPLIT_ROWS = prev


def split_rows():
    """The mesh whose 'data' axis the batch rows are split over
    (``rows_split``), or None."""
    return _SPLIT_ROWS


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch (n * B, ...) of the n ranks' rows ``x`` (B, ...)
    along the mesh's 'data' axis, rank-major. Its gradient is summed
    over the ranks and each rank keeps its own rows: with the step's
    mean of the ranks' gradients, a layer run on the gathered rows on
    every rank gets the gradient of the one global computation."""
    return _GatherRows.apply(x, mesh.get_group("data"),
                             mesh.get_local_rank("data"))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        import torch.distributed as dist
        ctx.group, ctx.lo, ctx.rows = group, index * x.shape[0], x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group.size())]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.lo:ctx.lo + ctx.rows], None, None
