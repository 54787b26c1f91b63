"""Step factories: the training step and the serving pair.

The port of ``repro.train.steps``, on one card or one rank a card:

  * ``make_train_step`` builds ``state, metrics = train_step(state,
    batch)``: loss and gradients (``torch.autograd.grad`` over the
    parameter leaves), global-norm clipping, then the paper's gradient
    compression through the fused flat tier — the gradient tree is
    flattened onto its ``FlatLayout``, the error-feedback residual (ONE
    flat fp32 buffer, ``state["ec_err"]``) is added, and the codec's
    ``flat_qdq`` (K1 + K4) quantizes it per bucket under
    ``fold_in(state["rng"], step)`` — then the optimizer update.
    ``metrics`` holds ``loss``, ``grad_norm``, ``step`` and
    ``comm_bytes`` (the measured wire bytes of the one fused message).
    The loss is the cross entropy plus the MoE router's aux loss.
    Given a mesh (the launcher on several ranks, the state replicated),
    the step takes the global batch, runs this rank's rows of it
    (``sharding.local_batch``) and averages the loss and the gradient
    over the 'data' axis (``reduce_over_data``: one all-reduce of one
    flat buffer) before the clip, so the clip, the codec (under the
    same key), the residual and the update run identically on every
    rank and the replicas stay equal. With no mesh, a 'data' axis of
    one rank, or a batch the axis does not divide (every rank then runs
    the whole batch), it is the one-card step.
  * ``make_serve_step`` / ``make_bulk_prefill``: the decode step and
    the prompt loop, over the unrolled tree (``transformer``, the
    default, as JAX's) or the scanned one (``scan_layers=True``,
    ``transformer_scan``); a decode state made with ``quantize_kv`` runs
    the int8 KV cache.
  * ``make_prefill_step``: the full-sequence forward returning the
    last position's logits, on the flash-attention kernel when
    ``use_flash``.

The train state mirrors JAX's ``{"params", "opt", "step", "rng",
"ec_err"?}``. ``step`` and ``rng`` are host tensors (0-d int32, and the
(2,) threefry key), so deriving the step's key reads nothing back from
the card. The step updates the state IN PLACE (parameters, moments,
residual) and returns it; JAX returns new arrays with the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core import compression, prng, pytree
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.models import layers, transformer, transformer_scan
from repro_torch.models.common import ModelConfig
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: bool = False
    use_flash: bool = False
    grad_clip: float = 1.0
    grad_compression: str = "none"    # compression registry key
    error_feedback: bool = False      # single-sided EC on the gradient
    param_dtype: torch.dtype = torch.float32
    scan_layers: bool = False         # stacked params, loop over blocks
    remat_policy: str = "full"        # full | dots (save matmul outputs)


def _impl(scan_layers: bool):
    return transformer_scan if scan_layers else transformer


def init_generator(key, device) -> torch.Generator:
    """The parameter-init generator seeded from a threefry key (both
    words). It draws other numbers than ``jax.random.normal`` under the
    same key: tests carry parameters across instead."""
    k0, k1 = (int(w) for w in key.tolist())
    return torch.Generator(device=torch.device(device)
                           ).manual_seed((k0 << 32) | k1)


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, key, *,
                     step_cfg: TrainStepConfig = TrainStepConfig(),
                     device=None) -> dict:
    """Parameters (on ``device``: ``cuda`` unless the caller asks for
    the CPU), optimizer state, step 0, the key, and a zero flat residual
    when error feedback is on."""
    gen = init_generator(key, resolve_device(device))
    return _train_state(cfg, optimizer, key, gen, step_cfg)


def _train_state(cfg, optimizer, key, gen, step_cfg) -> dict:
    params = _impl(step_cfg.scan_layers).init(cfg, gen,
                                              dtype=step_cfg.param_dtype)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32),
             "rng": torch.as_tensor(key, dtype=torch.int64).clone()}
    if step_cfg.error_feedback:
        total = compression.FlatLayout.from_tree(params).total
        state["ec_err"] = torch.zeros((total,), dtype=torch.float32,
                                      device=gen.device)
    return state


def abstract_train_state(cfg: ModelConfig, optimizer: Optimizer, *,
                         step_cfg: TrainStepConfig = TrainStepConfig()
                         ) -> dict:
    """The train state with every tensor on ``meta`` (the dry run's
    input; JAX's ``jax.eval_shape`` of ``init_train_state``): the same
    tree, shapes and dtypes, nothing allocated. The host leaves
    (``step``, ``rng``, the optimizer's ``step``) are ``meta`` too; the
    key is the port's (2,) int64 pair where JAX's is uint32."""
    state = _train_state(cfg, optimizer, torch.zeros(2, dtype=torch.int64),
                         layers.MetaGenerator(), step_cfg)
    return pytree.tree_map(lambda t: t.to("meta"), state)


_HOST_LEAVES = ("step", "rng")


def state_to(state: dict, device) -> dict:
    """A copy of a train state with its tensors on ``device``, except the
    host counters and key (``step``, ``rng``, the optimizer's ``step``),
    which are cloned where they are."""
    def place(key, sub):
        if key in _HOST_LEAVES:
            return sub.clone()
        if key == "opt":
            return {k: place(k, v) for k, v in sub.items()}
        return pytree.tree_map(lambda t: t.to(device, copy=True), sub)

    return {k: place(k, v) for k, v in state.items()}


def make_loss_fn(cfg: ModelConfig,
                 step_cfg: TrainStepConfig = TrainStepConfig()):
    """The production loss closure, ``loss(params, batch) -> scalar``."""
    impl = _impl(step_cfg.scan_layers)

    def loss(params, batch):
        kw = {}
        if step_cfg.scan_layers:
            kw["remat_policy"] = step_cfg.remat_policy
        return impl.loss_fn(params, cfg, batch, use_flash=step_cfg.use_flash,
                            remat=step_cfg.remat, **kw)

    return loss


def compress_grads(q_codec, grads, key, ec_err: Optional[torch.Tensor]
                   = None) -> tuple:
    """The codec stage of a train step: flatten the gradient tree onto
    its FlatLayout, add the flat residual when there is one, and
    quantize per bucket (``flat_qdq``). Returns (quantized gradient
    tree, new residual or None, comm bytes). The new residual ``v -
    qflat`` is written into ``ec_err`` in place; without error feedback
    the fresh flat buffer is dead after the qdq, so K4 writes over it."""
    layout = compression.FlatLayout.from_tree(grads)
    gflat = layout.flatten(grads)
    if ec_err is not None:
        v = gflat.add_(ec_err)
        qflat = q_codec.flat_qdq(v, key)
        ec_err = torch.sub(v, qflat, out=ec_err)
    else:
        qflat = q_codec.flat_qdq(gflat, key, donate=True)
    grads = layout.unflatten(qflat)
    return grads, ec_err, q_codec.tree_wire_bytes_flat(grads)


def value_and_grad(loss_fn, params, batch) -> tuple:
    """(loss, gradient tree) of ``loss_fn(params, batch)``, with
    ``torch.autograd.grad`` over the parameter leaves. A leaf the loss
    does not use (the token embedding of a stub frontend with an untied
    head) gets zeros, as ``jax.grad`` gives it."""
    leaves, treedef = pytree.tree_flatten(params)
    with torch.enable_grad():
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        with obs.span("train.forward"):
            loss = loss_fn(pytree.tree_unflatten(treedef, live), batch)
        with obs.span("train.backward"):
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
    # on a mesh each gradient takes its parameter's placement
    grads = [sharding.like(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), pytree.tree_unflatten(treedef, grads)


def reduce_over_data(loss: torch.Tensor, grads, mesh) -> tuple:
    """(loss, gradient tree), each the mean over the ranks of the mesh's
    'data' axis of the ranks' own: one all-reduce (a sum) of one fp32
    buffer, the gradient's FlatLayout with the loss after it, then a
    division by the rank count. Every rank gets the same bits."""
    import torch.distributed as dist
    group = mesh.get_group("data")
    layout = compression.FlatLayout.from_tree(grads)
    total = layout.total
    flat = layout.flatten(grads, padded_len=total + 1)
    flat[total] = loss
    dist.all_reduce(flat, group=group)
    flat.div_(group.size())
    return flat[total].clone(), layout.unflatten(flat[:total])


def data_value_and_grad(loss_fn, params, rows: dict, mesh) -> tuple:
    """``value_and_grad`` of a rank's rows of a global batch split over
    the mesh's 'data' axis (the model groups MoE tokens as the global
    batch does), reduced over it: the loss and gradient of the global
    batch."""
    with sharding.rows_split(mesh):
        loss, grads = value_and_grad(loss_fn, params, rows)
    return reduce_over_data(loss, grads, mesh)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    step_cfg: TrainStepConfig = TrainStepConfig(), *,
                    mesh=None):
    q_codec = compression.codec(step_cfg.grad_compression)
    loss_fn = make_loss_fn(cfg, step_cfg)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        with obs.span("train.step", args={"step": int(state["step"])}):
            return phases(state, batch)

    def phases(state: dict, batch: dict) -> tuple[dict, dict]:
        """The step, a span a phase: ``train.forward`` and
        ``train.backward`` (``value_and_grad``), ``train.clip``,
        ``train.compress`` and ``train.optimizer``."""
        split = False
        if mesh is not None:
            batch, split = sharding.local_batch(batch, mesh)
        if split:
            loss_val, grads = data_value_and_grad(loss_fn, state["params"],
                                                  batch, mesh)
        else:
            loss_val, grads = value_and_grad(loss_fn, state["params"],
                                             batch)
        if step_cfg.grad_clip > 0:
            with obs.span("train.clip"):
                grads, grad_norm = clip_by_global_norm(grads,
                                                       step_cfg.grad_clip)
        else:
            grad_norm = torch.zeros(())
        new_state = dict(state)
        comm_bytes = 0.0
        if step_cfg.grad_compression != "none":
            qkey = prng.fold_in(state["rng"], int(state["step"]))
            ec = state["ec_err"] if step_cfg.error_feedback else None
            # the residual is updated in place (new_state shares it)
            with obs.span("train.compress"):
                grads, _, comm_bytes = compress_grads(q_codec, grads, qkey,
                                                      ec)
        with obs.span("train.optimizer"):
            updates, new_opt = optimizer.update(grads, state["opt"],
                                                state["params"])
            new_state["params"] = apply_updates(state["params"], updates)
        new_state["opt"] = new_opt
        new_state["step"] = state["step"] + 1
        metrics = {"loss": loss_val, "grad_norm": grad_norm,
                   "step": state["step"],
                   "comm_bytes": torch.tensor(comm_bytes,
                                              dtype=torch.float32)}
        return new_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, *, scan_layers: bool = False,
                    moe_rows: bool = False):
    """decode: (params, decode_state, inputs) -> (next_token_logits,
    state), over the unrolled tree or, with ``scan_layers``, the scanned
    one. The state is updated in place. ``moe_rows``: each row's token
    is its own MoE group (the serve engine's slots, as the JAX engine's
    vmapped batch-1 step), else the rows are one group (JAX's batch-B
    step)."""
    impl = _impl(scan_layers)

    def serve_step(params, decode_state, inputs):
        logits, state = impl.decode_step(params, cfg, inputs, decode_state,
                                         moe_rows=moe_rows)
        return logits[:, -1], state

    return serve_step


def make_bulk_prefill(cfg: ModelConfig, *, scan_layers: bool = False):
    """Bulk cache fill: (params, decode_state, tokens (B, S)) ->
    (last_logits (B, V), filled decode_state).

    A loop of ``decode_step`` over the prompt positions — the JAX
    package's ``lax.scan`` of the same step — so the filled cache and
    the logits are bit-identical to feeding the tokens one at a time,
    by construction."""
    impl = _impl(scan_layers)
    if cfg.frontend != "token":
        raise ValueError(
            f"bulk prefill needs a token frontend, got '{cfg.frontend}'")

    def bulk_prefill(params, decode_state, tokens: torch.Tensor):
        logits = None
        for i in range(tokens.shape[1]):
            logits, decode_state = impl.decode_step(
                params, cfg, {"tokens": tokens[:, i:i + 1]}, decode_state)
        return logits[:, -1], decode_state

    return bulk_prefill


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False,
                      scan_layers: bool = False,
                      logits_positions: str = "all"):
    """prefill: ``prefill_step(params, batch) -> logits (B, V)`` of the
    last position, from the full-sequence forward (``remat`` when
    ``scan_layers``, as the JAX package sets it; ``logits_positions``
    applies to the scanned layout only). Cache population for decode
    goes through ``make_bulk_prefill``."""
    impl = _impl(scan_layers)

    def prefill_step(params, batch):
        kw = {}
        if scan_layers:
            kw["logits_positions"] = logits_positions
        with obs.span("prefill.step"):
            logits = impl.apply(params, cfg, batch, use_flash=use_flash,
                                remat=scan_layers, **kw)
            return logits[:, -1]

    return prefill_step
