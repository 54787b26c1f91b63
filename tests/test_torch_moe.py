"""repro_torch's MoE layer against repro's, on reduced
deepseek-v2-lite-16b and grok-1-314b MoE configurations with JAX's
parameters carried across (``interop.params_from_jax``) and inputs made
with numpy from a seed: the group shapes and capacities, the routing
(expert ids, slots, drops), ``moe_apply``'s output and router aux loss
with groups spanning batch rows, with a capacity factor that drops
choices, their gradients, and the serve engine's per-slot grouping
against the JAX engine's vmapped batch-1 step.

Tolerance rtol = atol = 1e-5 on outputs and aux (the frameworks sum
the matmuls, and the combine its k terms, in other orders); 1e-4 on the
layer's gradients, as tests/test_torch_rwkv.py holds gradients: the
router's sums over every token's k expert outputs of magnitude ~10, so
its fp32 rounding is ~3e-5 on elements of any size. Routing is compared
exactly: the expert ids are equal, and where a router near-tie (two
probabilities within 1e-6, which XLA and torch may round apart) orders
them otherwise the test asserts the tie instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer_scan as jts
from repro.train import steps as jsteps
from repro_torch import configs, interop
from repro_torch.core import pytree
from repro_torch.models import moe
from repro_torch.models import transformer_scan as tts
from repro_torch.train import steps

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
NEAR_TIE = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **moe_kw):
    j = jconfigs.get_config(arch).reduced()
    t = configs.get_config(arch).reduced()
    if moe_kw:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe_kw))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe_kw))
    return j, t


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_routing(p, mcfg, xg):
    """JAX's routing, as ``repro.models.moe.moe_apply`` computes it:
    (probs, expert ids, slot within the expert, kept)."""
    g, k = xg.shape[1], mcfg.top_k
    probs = jax.nn.softmax(jlayers.dense(p["router"], xg), -1)
    _, ids = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(ids, mcfg.n_experts, dtype=jnp.float32)
    flat = onehot.reshape(xg.shape[0], g * k, mcfg.n_experts)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
           * onehot).sum(-1)
    return (np.asarray(probs), np.asarray(ids), np.asarray(pos, np.int64),
            np.asarray(pos < jmoe._capacity(mcfg, g)))


def _assert_same_routing(tp, jp, tmc, jmc, x):
    """Expert ids equal (or a near-tie), slots and drops equal."""
    n_groups, g = moe._group_shape(x.shape[0] * x.shape[1])
    xg = x.reshape(n_groups, g, -1)
    probs, ids, pos, keep = _jax_routing(jp, jmc.moe, jnp.asarray(xg))
    _, _, tids, tpos, tkeep = moe.route(tp, tmc, torch.from_numpy(xg))
    tids = tids.numpy()
    for gi, ti, ki in zip(*np.nonzero(tids != ids)):
        # a near-tie, not a fault
        pj = probs[gi, ti, ids[gi, ti, ki]]
        pt = probs[gi, ti, tids[gi, ti, ki]]
        assert abs(pj - pt) < NEAR_TIE, (gi, ti, ki, pj, pt)
    if (tids == ids).all():
        np.testing.assert_array_equal(tpos.numpy(), pos)
        np.testing.assert_array_equal(tkeep.numpy(), keep)
    return keep


@pytest.mark.parametrize("t", [1, 4, 4100, 8192, 3 * 4096])
def test_group_shape_matches_jax(t):
    assert moe._group_shape(t) == jmoe._group_shape(t)


@pytest.mark.parametrize("g", [1, 4, 32, 480, 4096])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_capacity_matches_jax(arch, g):
    jm, tm = jconfigs.get_config(arch).moe, configs.get_config(arch).moe
    assert moe._capacity(tm, g) == jmoe._capacity(jm, g)


def test_deepseek_prefill_group_capacity():
    """A 1 x 4,096 deepseek prefill is one group at MAX_GROUP with
    capacity int(4096 * 6 * 1.25 / 64) = 480."""
    m = configs.get_config("deepseek-v2-lite-16b").moe
    assert moe._group_shape(4096) == (1, moe.MAX_GROUP)
    assert moe._capacity(m, 4096) == 480


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_moe_apply_matches_jax(arch, cf):
    """B 4 x S 8: one group of 32 tokens spanning the four rows; at
    capacity factor 0.5 choices drop (asserted; at 1.25 an unbalanced
    router may drop some too), and both layers drop the same ones."""
    jmc, tmc = _cfgs(arch, capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(5), jmc)
    tp = interop.params_from_jax(_np(jp))
    x = _x((4, 8, jmc.d_model), seed=6)
    keep = _assert_same_routing(tp, jp, tmc, jmc, x)
    if cf < 1.0:
        assert not keep.all()
    want, waux = jmoe.moe_apply(jp, jmc, jnp.asarray(x), act=jmc.act)
    got, gaux = moe.moe_apply(tp, tmc, torch.from_numpy(x), act=tmc.act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)


def test_moe_apply_over_several_groups_matches_jax():
    """T = 4 x 2,048 tokens: two groups of MAX_GROUP, each spanning two
    rows, each with its own capacity count."""
    jmc, tmc = _cfgs("grok-1-314b", capacity_factor=0.5)
    jmc = dataclasses.replace(jmc, d_model=32)
    tmc = dataclasses.replace(tmc, d_model=32)
    jmc = dataclasses.replace(jmc, moe=dataclasses.replace(jmc.moe,
                                                           d_ff_expert=16))
    tmc = dataclasses.replace(tmc, moe=dataclasses.replace(tmc.moe,
                                                           d_ff_expert=16))
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jmc)
    tp = interop.params_from_jax(_np(jp))
    x = _x((4, 2048, 32), seed=8)
    assert moe._group_shape(8192) == (2, 4096)
    _assert_same_routing(tp, jp, tmc, jmc, x)
    want, waux = jmoe.moe_apply(jp, jmc, jnp.asarray(x), act=jmc.act)
    got, gaux = moe.moe_apply(tp, tmc, torch.from_numpy(x), act=tmc.act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_gradients_match_jax(cf):
    """d(sum(out * c) + aux) by the parameters and the input."""
    jmc, tmc = _cfgs("deepseek-v2-lite-16b", capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(9), jmc)
    tp = interop.params_from_jax(_np(jp))
    x = _x((4, 8, jmc.d_model), seed=10)
    c = _x((4, 8, jmc.d_model), seed=11)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, jmc, x, act=jmc.act)
        return (out * c).sum() + aux, (out, aux)

    (_, (wout, waux)), (wgp, wgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    leaves, treedef = pytree.tree_flatten(tp)
    live = [t.clone().requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(pytree.tree_unflatten(treedef, live), tmc, xt,
                             act=tmc.act)
    loss = (out * torch.from_numpy(c)).sum() + aux
    grads = torch.autograd.grad(loss, live + [xt])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(wout), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(wgp) + [wgx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def _wide_router_cfgs():
    """Reduced deepseek with 16 experts, top-4: a batch-4 decode group
    has capacity int(4 * 4 * 1.25 / 16) = 1, so two slots choosing one
    expert drop a choice; one token alone never drops."""
    return _cfgs("deepseek-v2-lite-16b", n_experts=16, top_k=4)


def test_engine_slot_grouping_matches_the_vmapped_jax_step():
    """The engine's serve step (each slot its own group) == JAX's
    ``vmap`` of the batch-1 step, the JAX engine's form; the plain
    batch-4 step == JAX's batch-4 step (one group of 4); and the two
    groupings differ here (choices drop in the group of 4)."""
    jmc, tmc = _wide_router_cfgs()
    jmc, tmc = (dataclasses.replace(m, n_layers=3, block_pattern=("mla",) * 3)
                for m in (jmc, tmc))
    jp = jts.init(jmc, jax.random.PRNGKey(12))
    tp = interop.params_from_jax(_np(jp))
    S, P = 4, 6
    toks = np.random.default_rng(13).integers(0, jmc.vocab, size=(S, P)
                                              ).astype(np.int32)
    jstep = jsteps.make_serve_step(jmc, scan_layers=True)
    jfresh = jts.init_decode_state(jp, jmc, 1, P + 1, dtype=jnp.float32)
    jslots = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (S,) + a.shape) + 0, jfresh)
    jvm = jax.jit(lambda st, tok: jax.vmap(
        lambda s, t: jstep(jp, s, {"tokens": t}))(st, tok))
    jbatch = jax.jit(lambda st, tok: jstep(jp, st, {"tokens": tok}))
    jst = jts.init_decode_state(jp, jmc, S, P + 1, dtype=jnp.float32)
    rows_st = tts.init_decode_state(tp, tmc, S, P + 1, dtype=torch.float32)
    batch_st = tts.init_decode_state(tp, tmc, S, P + 1, dtype=torch.float32)
    rows_step = steps.make_serve_step(tmc, scan_layers=True,
                                       moe_rows=True)
    batch_step = steps.make_serve_step(tmc, scan_layers=True)
    differ = False
    for i in range(P):
        tok = toks[:, i:i + 1]
        jl_rows, jslots = jvm(jslots, jnp.asarray(tok)[:, :, None])
        jl_batch, jst = jbatch(jst, jnp.asarray(tok))
        tl_rows, rows_st = rows_step(tp, rows_st,
                                     {"tokens": torch.from_numpy(tok)})
        tl_batch, batch_st = batch_step(tp, batch_st,
                                        {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(tl_rows.numpy(),
                                   np.asarray(jl_rows)[:, 0], **TOL)
        np.testing.assert_allclose(tl_batch.numpy(), np.asarray(jl_batch),
                                   **TOL)
        differ |= not np.allclose(np.asarray(jl_rows)[:, 0],
                                  np.asarray(jl_batch), rtol=1e-3,
                                  atol=1e-3)
    assert differ, "the two groupings never differed: the test has no teeth"
