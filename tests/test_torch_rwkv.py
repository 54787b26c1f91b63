"""repro_torch's RWKV6 slice against repro's, on reduced rwkv6-3b (2
layers, d=256, 4 heads of 64, vocab 512) with JAX's parameters carried
across (``interop.params_from_jax``): LayerNorm, the time-mix (plain
chunked scan and the kernel path, fresh and carried state), the
channel-mix, one-token decode, the block, both layouts' forward, the
prefill step, the decode step and bulk prefill with every state leaf,
the serve engine's token streams, the loss and its gradients, and the
parameter tree at reduced and full width. Inputs are made with numpy
from a seed.

Tolerances: rtol = atol = 1e-5 on activations and logits, as the model
tests (the frameworks sum the matmuls in different orders); 1e-4 on the
wkv state and on gradients, the JAX package's own tolerance for the
scan's state (a sum of outer products whose rounding follows its terms'
magnitude, not the element's; the backward sums over every token).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.models import transformer as jt
from repro.models import transformer_scan as jts
from repro.train import steps as jsteps
from repro_torch import configs, interop, serve
from repro_torch.core import pytree
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.models import layers, rwkv
from repro_torch.models import transformer as tt
from repro_torch.models import transformer_scan as tts
from repro_torch.train import steps

ARCH = "rwkv6-3b"
TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
# JAX's jax.eval_shape(transformer_scan.init) at full width
FULL_PARAMS = 3_089_290_240
FULL_LEAVES = 24


@pytest.fixture(autouse=True, scope="module")
def _first_exp_done():
    """PyTorch 2.13's CPU build (AVX512) can compute the first
    multi-threaded ``torch.exp`` of a process with one thread's share of the elements
    off by up to 1.5e-4 relative (the next call is exact): one exp over
    2**16 elements before the comparisons keeps that library fault out
    of them."""
    torch.exp(torch.zeros(1 << 16))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def cfgs():
    return (jconfigs.get_config(ARCH).reduced(),
            configs.get_config(ARCH).reduced())


@pytest.fixture(scope="module")
def scanned(cfgs):
    """(JAX, port) params of the stacked tree."""
    jp = jts.init(cfgs[0], jax.random.PRNGKey(0))
    return jp, interop.params_from_jax(_np(jp))


@pytest.fixture(scope="module")
def unrolled(cfgs):
    jp = jt.init(cfgs[0], jax.random.PRNGKey(1))
    return jp, interop.params_from_jax(_np(jp))


@pytest.fixture(scope="module")
def mixer(cfgs):
    """(JAX, port) params of one time-mix and one channel-mix."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    jtm = jrwkv.time_mix_init(k1, cfgs[0])
    jcm = jrwkv.channel_mix_init(k2, cfgs[0])
    return (jtm, interop.params_from_jax(_np(jtm)),
            jcm, interop.params_from_jax(_np(jcm)))


def _x(b, s, d, seed):
    return (np.random.default_rng(seed).normal(size=(b, s, d)) * 0.5
            ).astype(np.float32)


def _tokens(mc, b, p, seed=1):
    return np.random.default_rng(seed).integers(
        0, mc.vocab, size=(b, p)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _state_close(tstate, jstate):
    """Every leaf of a decode state (or a time-mix state dict): the wkv
    state at STATE_TOL, the token-shift tails at TOL."""
    tl, tdef = pytree.tree_flatten(tstate)
    jl = jax.tree_util.tree_leaves(jstate)
    names = [n for n in _leaf_names(tstate)]
    assert len(tl) == len(jl) == len(names)
    for name, t, j in zip(names, tl, jl):
        assert tuple(t.shape) == tuple(j.shape), name
        _close(t.numpy(), j, STATE_TOL if name == "wkv" else TOL)


def _leaf_names(tree):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in
                (_leaf_names(tree[k]) if isinstance(tree[k], (dict, list))
                 else [k])]
    return [n for c in tree for n in _leaf_names(c)]


def test_config_copy_matches_jax():
    for reduced in (False, True):
        j, t = jconfigs.get_config(ARCH), configs.get_config(ARCH)
        j, t = (j.reduced(), t.reduced()) if reduced else (j, t)
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("shape", [(2, 5, 256), (3, 2560)])
def test_layernorm_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    d = shape[-1]
    p = {"scale": rng.normal(size=d).astype(np.float32),
         "bias": rng.normal(size=d).astype(np.float32)}
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind="layernorm", eps=1e-5)
    got = layers.apply_norm(interop.params_from_jax(p), torch.from_numpy(x),
                            kind="layernorm", eps=1e-5)
    _close(got.numpy(), want)
    init = layers.norm_init(d, "layernorm")
    assert sorted(init) == ["bias", "scale"]
    assert torch.equal(init["bias"], torch.zeros(d))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["chunked", "kernel_path"])
def test_time_mix_matches_jax(cfgs, mixer, use_kernel):
    """Port time_mix (the chunked scan on a CPU tensor) against JAX's
    time_mix on both of its scan paths (the Pallas kernel in interpret
    mode, padded), S = 96 (a padded second chunk)."""
    jmc, tmc = cfgs
    jtm, ttm, _, _ = mixer
    x = _x(2, 96, tmc.d_model, seed=3)
    want, jst = jrwkv.time_mix(jtm, jmc, jnp.asarray(x),
                               use_kernel=use_kernel)
    wk.reset_launches()
    got, tst = rwkv.time_mix(ttm, tmc, torch.from_numpy(x))
    assert wk.wkv6_bhsk.launches == 0
    _close(got.numpy(), want)
    _state_close(tst, jst)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["chunked", "kernel_path"])
def test_time_mix_with_a_carried_state_matches_jax(cfgs, mixer, use_kernel):
    """Streaming: the state after a 16-token segment carried into the
    next 24 tokens, against JAX's segment streaming on both of its scan
    paths (the kernel path folds the state in after the scan)."""
    jmc, tmc = cfgs
    jtm, ttm, _, _ = mixer
    x = _x(1, 40, tmc.d_model, seed=4)
    j1, jst = jrwkv.time_mix(jtm, jmc, jnp.asarray(x[:, :16]),
                             use_kernel=use_kernel)
    j2, jst2 = jrwkv.time_mix(jtm, jmc, jnp.asarray(x[:, 16:]), state=jst,
                              use_kernel=use_kernel)
    t1, tst = rwkv.time_mix(ttm, tmc, torch.from_numpy(x[:, :16]))
    t2, tst2 = rwkv.time_mix(ttm, tmc, torch.from_numpy(x[:, 16:]),
                             state=tst)
    _close(t1.numpy(), j1)
    _close(t2.numpy(), j2)
    _state_close(tst2, jst2)


@pytest.mark.parametrize("on_card,grad_mode,requires_grad,want", [
    (True, False, True, "kernel"),     # serving: torch.no_grad
    (True, True, False, "kernel"),     # a prefill of plain tensors
    (True, True, True, "chunked"),     # a train step on the card
    (False, False, False, "chunked"),
    (False, True, True, "chunked"),
])
def test_wkv_scan_for_picks_the_chunked_scan_when_grad_is_recorded(
        on_card, grad_mode, requires_grad, want):
    """K7 is forward-only: it runs only on card tensors while autograd
    records nothing; a recorded scan (training) takes the chunked scan
    on either device, as JAX's model block always does. The inputs are
    stand-ins with the two attributes the choice reads."""
    ins = [types.SimpleNamespace(is_cuda=on_card, requires_grad=False)
           for _ in range(5)]
    ins[3].requires_grad = requires_grad
    with torch.set_grad_enabled(grad_mode):
        got = rwkv.wkv_scan_for(*ins, None)
    assert got is {"kernel": rwkv.wkv_ops.wkv6,
                   "chunked": rwkv.wkv_chunked}[want]


def test_rwkv_decode_state_stays_fp32_under_the_bf16_default(cfgs,
                                                             scanned):
    """The cache dtype defaults to bf16, as JAX's; the recurrent state
    is fp32 whatever it is, in both packages."""
    jmc, tmc = cfgs
    jp, tp = scanned
    jst = jts.init_decode_state(jp, jmc, 2, 8)
    tst = tts.init_decode_state(tp, tmc, 2, 8)
    for name, leaf in tst["scan"][0].items():
        assert leaf.dtype == torch.float32, name
        assert np.dtype(jst["scan"][0][name].dtype) == np.float32, name


@pytest.mark.parametrize("with_prev", [False, True])
def test_channel_mix_matches_jax(cfgs, mixer, with_prev):
    jmc, tmc = cfgs
    _, _, jcm, tcm = mixer
    x = _x(2, 7, tmc.d_model, seed=5)
    prev = _x(1, 2, tmc.d_model, seed=6)[0] if with_prev else None
    want, jprev = jrwkv.channel_mix(
        jcm, jmc, jnp.asarray(x),
        prev_x=None if prev is None else jnp.asarray(prev))
    got, tprev = rwkv.channel_mix(
        tcm, tmc, torch.from_numpy(x),
        prev_x=None if prev is None else torch.from_numpy(prev))
    _close(got.numpy(), want)
    _close(tprev.numpy(), jprev)


def test_time_mix_decode_matches_jax_and_the_chunked_form(cfgs, mixer):
    """13 one-token steps against JAX's, output and state at every step;
    the stacked outputs against the port's own chunked time_mix (JAX's
    chunk-vs-decode tolerance, 2e-3)."""
    jmc, tmc = cfgs
    jtm, ttm, _, _ = mixer
    x = _x(1, 13, tmc.d_model, seed=7)
    jst = jrwkv.init_state(jmc, 1)
    tst = rwkv.init_state(tmc, 1)
    outs = []
    for i in range(13):
        jo, jst = jrwkv.time_mix_decode(jtm, jmc, jnp.asarray(x[:, i:i + 1]),
                                        jst)
        to, tst = rwkv.time_mix_decode(ttm, tmc,
                                       torch.from_numpy(x[:, i:i + 1]), tst)
        _close(to.numpy(), jo)
        _state_close(tst, jst)
        outs.append(to[:, 0])
    full, _ = rwkv.time_mix(ttm, tmc, torch.from_numpy(x))
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3,
                               atol=2e-3)


def test_block_matches_jax(cfgs, unrolled):
    jmc, tmc = cfgs
    jp, tp = unrolled
    x = _x(2, 70, tmc.d_model, seed=8)
    pos = np.broadcast_to(np.arange(70)[None], (2, 70))
    want, _ = jt._block_apply(jp["layers"][0], jmc, "rwkv", 0,
                              jnp.asarray(x), jnp.asarray(pos))
    got = tt._block_apply(tp["layers"][0], tmc, "rwkv", 0,
                          torch.from_numpy(x), torch.from_numpy(pos.copy()))
    _close(got.numpy(), want)


@pytest.mark.parametrize("layout", ["unrolled", "scanned"])
def test_apply_matches_jax(cfgs, unrolled, scanned, layout):
    jmc, tmc = cfgs
    jm, tm, (jp, tp) = ((jt, tt, unrolled) if layout == "unrolled"
                        else (jts, tts, scanned))
    tok = _tokens(jmc, 2, 80, seed=9)
    want, _ = jm.apply(jp, jmc, {"tokens": jnp.asarray(tok)})
    got = tm.apply(tp, tmc, {"tokens": torch.from_numpy(tok)})
    _close(got.numpy(), want)


@pytest.mark.parametrize("positions", ["all", "last"])
def test_prefill_step_matches_jax(cfgs, scanned, positions):
    jmc, tmc = cfgs
    jp, tp = scanned
    tok = _tokens(jmc, 2, 150, seed=10)
    kw = dict(scan_layers=True, logits_positions=positions)
    want = jax.jit(jsteps.make_prefill_step(jmc, **kw))(
        jp, {"tokens": jnp.asarray(tok)})
    wk.reset_launches()
    got = steps.make_prefill_step(tmc, **kw)(
        tp, {"tokens": torch.from_numpy(tok)})
    assert wk.wkv6_bhsk.launches == 0          # CPU: plain chunked scan
    assert tuple(got.shape) == (2, tmc.vocab)
    _close(got.numpy(), want)


def test_decode_step_matches_jax_in_every_state_leaf(cfgs, scanned):
    """The port's in-place decode state (views of the stacked leaves)
    against JAX's returned state, step by step."""
    jmc, tmc = cfgs
    jp, tp = scanned
    B, P = 2, 9
    toks = _tokens(jmc, B, P, seed=11)
    jst = jts.init_decode_state(jp, jmc, B, P, dtype=jnp.float32)
    tst = tts.init_decode_state(tp, tmc, B, P, dtype=torch.float32)
    assert sorted(tst["scan"][0]) == ["prev_x", "prev_x_ffn", "wkv"]
    jstep = jax.jit(jsteps.make_serve_step(jmc, scan_layers=True))
    tstep = steps.make_serve_step(tmc, scan_layers=True)
    for i in range(P):
        jl, jst = jstep(jp, jst, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        tl, tst = tstep(tp, tst,
                        {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()})
        _close(tl.numpy(), jl)
        _state_close(tst, jst)
    # the state was written in place, into the stacked leaves
    assert float(tst["scan"][0]["wkv"].abs().sum()) > 0


def test_bulk_prefill_equals_token_by_token_and_jax(cfgs, scanned):
    jmc, tmc = cfgs
    jp, tp = scanned
    B, P = 2, 11
    toks = _tokens(jmc, B, P, seed=12)
    bulk = steps.make_bulk_prefill(tmc, scan_layers=True)
    lb, sb = bulk(tp, tts.init_decode_state(tp, tmc, B, P,
                                            dtype=torch.float32),
                  torch.from_numpy(toks))
    step = steps.make_serve_step(tmc, scan_layers=True)
    st = tts.init_decode_state(tp, tmc, B, P, dtype=torch.float32)
    for i in range(P):
        ls, st = step(tp, st, {"tokens": torch.from_numpy(toks[:, i:i + 1])})
    assert torch.equal(lb, ls)
    for a, b in zip(pytree.tree_leaves(sb), pytree.tree_leaves(st)):
        assert torch.equal(a, b)
    jl, jst = jax.jit(jsteps.make_bulk_prefill(jmc, scan_layers=True))(
        jp, jts.init_decode_state(jp, jmc, B, P, dtype=jnp.float32),
        jnp.asarray(toks))
    _close(lb.numpy(), jl)
    _state_close(sb, jst)


def test_engine_streams_equal_the_jax_engine():
    """The serve engine on reduced rwkv6-3b (CPU): greedy streams equal
    the JAX engine's on the same params and requests, to completion with
    0 dropped."""
    kw = dict(arch=ARCH, slots=2, max_len=32, prompt_len=6, n_requests=5,
              mixed_gen=(3, 7), seed=1, temperature=0.0)
    jeng = jserve.Engine(jserve.ServeConfig(**kw))
    jres = jserve.run(jserve.ServeConfig(**kw), params=jeng.params)
    tres = serve.run(serve.ServeConfig(**kw),
                     params=interop.params_from_jax(_np(jeng.params)),
                     device="cpu")
    assert tres.n_completed == jres.n_completed == 5
    assert tres.counters["dropped"] == 0
    assert tres.decode_steps == jres.decode_steps
    for rid, comp in jres.completions.items():
        assert tres.completions[rid].tokens == comp.tokens


def test_loss_and_gradients_match_jax(cfgs, unrolled):
    """CPU training works through the plain chunked scan: the loss and
    every gradient leaf against jax.value_and_grad (gradients at
    1e-4)."""
    jmc, tmc = cfgs
    jp, tp = unrolled
    tok = _tokens(jmc, 2, 33, seed=13)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def jloss(p):
        logits, _ = jt.apply(p, jmc, {"tokens": jnp.asarray(batch["tokens"])})
        return jt.sharded_cross_entropy(logits, jnp.asarray(batch["labels"]))

    jl, jg = jax.value_and_grad(jloss)(jp)
    tl, tg = steps.value_and_grad(
        lambda p, b: tt.loss_fn(p, tmc, b), tp,
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in batch.items()})
    _close(tl.numpy(), jl)
    for a, b in zip(pytree.tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(a.numpy(), b, STATE_TOL)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_param_tree_matches_jax(width):
    """The port's init gives JAX's tree leaf for leaf, in shapes and in
    order; at full width (built without memory under FakeTensorMode, as
    jax.eval_shape builds JAX's) 3,089,290,240 parameters in 24
    leaves."""
    jmc, tmc = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    if width == "reduced":
        jmc, tmc = jmc.reduced(), tmc.reduced()
    jtree = jax.eval_shape(lambda: jts.init(jmc, jax.random.PRNGKey(0)))
    jl, jdef = jax.tree_util.tree_flatten(jtree)
    with FakeTensorMode():
        tree = tts.init(tmc, tts.generator(0))
        tl, tdef = pytree.tree_flatten(tree)
        shapes = [tuple(t.shape) for t in tl]
    assert shapes == [tuple(a.shape) for a in jl]
    assert _leaf_names(tree) == [str(p[-1].key) if hasattr(p[-1], "key")
                                 else str(p[-1]) for p, _ in
                                 jax.tree_util.tree_flatten_with_path(
                                     jtree)[0]]
    if width == "full":
        assert (sum(int(np.prod(s)) for s in shapes), len(shapes)) == \
            (FULL_PARAMS, FULL_LEAVES)
