"""repro_torch's RG-LRU block and GELU against repro's, on reduced
recurrentgemma-9b (d = 256, RG-LRU width 256) with JAX's parameters
carried across (``interop.params_from_jax``) and inputs made with numpy
from a seed: GELU (``jax.nn.gelu``'s tanh form), the causal conv, the
gate coefficients, the log-depth doubling scan against JAX's
associative scan (with and without h0, in the model's decay range and
at decays near e^-13.6 and near 1), the full-sequence block with and
without a carried state, 70 decode steps across the conv window, and
the conv state's dtype.

Tolerance rtol = atol = 1e-5, as the model tests: the two scans
associate the products in other orders, and the frameworks sum the
matmuls in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro_torch import configs, interop
from repro_torch.models import layers, rglru

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _first_exp_done():
    """The CPU build's first multi-threaded ``torch.exp`` of a process
    can be off in one thread's share (see tests/test_torch_rwkv.py): one
    exp over 2**16 elements before the comparisons."""
    torch.exp(torch.zeros(1 << 16))


@pytest.fixture(scope="module")
def cfgs():
    return (jconfigs.get_config(ARCH).reduced(),
            configs.get_config(ARCH).reduced())


@pytest.fixture(scope="module")
def block(cfgs):
    jp = jrglru.rglru_block_init(jax.random.PRNGKey(3), cfgs[0])
    return jp, interop.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,scale", [((3, 7, 256), 1.0),
                                         ((2, 4096), 6.0)])
def test_gelu_matches_jax(shape, scale):
    x = _normal(shape, seed=len(shape), scale=scale)
    _close(layers.gelu(torch.from_numpy(x)), jax.nn.gelu(jnp.asarray(x)))


def test_gelu_mlp_matches_jax():
    from repro.models import layers as jlayers
    jp = jlayers.mlp_init(jax.random.PRNGKey(1), 64, 96, glu=True)
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x = _normal((2, 5, 64), seed=2)
    want = jlayers.mlp(jp, jnp.asarray(x), act="gelu", glu=True)
    _close(layers.mlp(tp, torch.from_numpy(x), act="gelu", glu=True), want)


def _decays(regime, shape, seed):
    """log a drawn uniformly over the regime's range: the model's
    (-8 softplus(lam) r over lam in [0.3, 1.5], r in (0, 1)), the
    strongest decay the model reaches (near e^-13.6), or near 1."""
    lo, hi = {"model": (-13.6, -0.01), "strong": (-13.6, -13.0),
              "weak": (-1e-4, -1e-7)}[regime]
    log_a = np.random.default_rng(seed).uniform(lo, hi, size=shape)
    return np.exp(log_a).astype(np.float32)


@pytest.mark.parametrize("regime", ["model", "strong", "weak"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 2, 100, 257])
def test_rglru_scan_matches_jax(regime, with_h0, s):
    shape = (2, s, 48)
    a = _decays(regime, shape, seed=s)
    b = _normal(shape, seed=s + 1)
    h0 = _normal((2, 48), seed=s + 2) if with_h0 else None
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                             h0=None if h0 is None else jnp.asarray(h0))
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           h0=None if h0 is None else torch.from_numpy(h0))
    _close(got, want)


def test_rglru_scan_is_the_recurrence():
    """The doubling scan against the plain loop h_t = a_t h_{t-1} + b_t
    in float64, in the strong-decay regime (the running products
    underflow; nothing is divided)."""
    a = _decays("strong", (1, 300, 8), seed=7)
    b = _normal((1, 300, 8), seed=8)
    h, want = np.zeros((1, 8)), []
    for t in range(300):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want.append(h)
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(torch.isfinite(got).all())
    _close(got, np.stack(want, 1))


def test_conv_and_coefficients_match_jax(cfgs, block):
    jp, tp = block
    x = _normal((2, 9, 256), seed=11)
    st = _normal((2, 3, 256), seed=12)
    for state in (None, st):
        jout, jst = jrglru._causal_conv(
            jp, jnp.asarray(x), state=None if state is None
            else jnp.asarray(state))
        tout, tst = rglru._causal_conv(
            tp, torch.from_numpy(x), state=None if state is None
            else torch.from_numpy(state))
        _close(tout, jout)
        _close(tst, jst)
    ja, jb = jrglru._rglru_coeffs(jp, jnp.asarray(x))
    ta, tb = rglru._rglru_coeffs(tp, torch.from_numpy(x))
    _close(ta, ja)
    _close(tb, jb)


@pytest.mark.parametrize("carried", [False, True])
def test_block_matches_jax(cfgs, block, carried):
    jmc, tmc = cfgs
    jp, tp = block
    x = _normal((2, 33, 256), seed=13)
    jst = tst = None
    if carried:
        conv, h = _normal((2, 3, 256), seed=14), _normal((2, 256), seed=15)
        jst = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
        tst = {"conv": torch.from_numpy(conv), "h": torch.from_numpy(h)}
    jout, jnew = jrglru.rglru_block(jp, jmc, jnp.asarray(x), state=jst)
    tout, tnew = rglru.rglru_block(tp, tmc, torch.from_numpy(x), state=tst)
    _close(tout, jout)
    for name in ("conv", "h"):
        _close(tnew[name], jnew[name])


def test_decode_70_steps_match_jax_across_the_conv_window(cfgs, block):
    """70 one-token steps from the default (bf16-cache) state: the
    outputs, h and the conv window equal JAX's at every step; JAX's conv
    leaf starts bf16 and comes back fp32 after one step, the port's is
    fp32 throughout (its bf16 zeros are exact in fp32)."""
    jmc, tmc = cfgs
    jp, tp = block
    xs = _normal((2, 70, 256), seed=16)
    jst = jrglru.init_state(jmc, 2)
    tst = rglru.init_state(tmc, 2)
    assert jst["conv"].dtype == jnp.bfloat16
    assert tst["conv"].dtype == torch.float32
    jstep = jax.jit(lambda p, x, s: jrglru.rglru_block_decode(p, jmc, x, s))
    for t in range(70):
        jout, jst = jstep(jp, jnp.asarray(xs[:, t:t + 1]), jst)
        tout, tst = rglru.rglru_block_decode(
            tp, tmc, torch.from_numpy(xs[:, t:t + 1]), tst)
        _close(tout, jout)
        for name in ("conv", "h"):
            assert str(tst[name].dtype).removeprefix("torch.") == \
                np.dtype(jst[name].dtype).name == "float32"
            _close(tst[name], jst[name])


def test_decode_steps_equal_the_block(cfgs, block):
    """Token by token through the decode step == the full-sequence
    block, within the port (output and final state)."""
    _, tmc = cfgs
    _, tp = block
    x = torch.from_numpy(_normal((2, 20, 256), seed=17))
    full, fst = rglru.rglru_block(tp, tmc, x)
    st = rglru.init_state(tmc, 2, dtype=torch.float32)
    outs = []
    for t in range(20):
        out, st = rglru.rglru_block_decode(tp, tmc, x[:, t:t + 1], st)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)
    for name in ("conv", "h"):
        torch.testing.assert_close(st[name], fst[name], **TOL)


def test_bf16_weights_keep_a_bf16_conv_state(cfgs):
    """With bf16 weights JAX's conv window stays bf16 (bf16 + bf16), so
    the port allocates it bf16 too."""
    _, tmc = cfgs
    st = rglru.init_state(tmc, 2, param_dtype=torch.bfloat16)
    assert st["conv"].dtype == torch.bfloat16
    assert st["h"].dtype == torch.float32


def test_block_params_have_the_jax_tree(cfgs, block):
    jp, _ = block
    tp = rglru.rglru_block_init(torch.Generator().manual_seed(0),
                                dataclasses.replace(cfgs[1]))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k]["w"].shape if isinstance(tp[k], dict)
                     else tp[k].shape) == tuple(
            jp[k]["w"].shape if isinstance(jp[k], dict) else jp[k].shape)
