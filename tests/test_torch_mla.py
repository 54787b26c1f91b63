"""repro_torch's multi-head latent attention against repro's, on reduced
deepseek-v2-lite-16b (d = 256, 4 heads, kv_lora_rank 64, rope dim 32)
with JAX's parameters carried across (``interop.params_from_jax``) and
inputs made with numpy from a seed: the full-sequence ``mla_attention``,
the absorbed decode against the full-sequence form, the cache dtypes,
and decode past a 64-slot ring window with rows at different cursors,
each row against JAX's (scalar-cursor) decode of that row alone.

Tolerance rtol = atol = 1e-5, as the model tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mla as jmla
from repro_torch import configs, interop
from repro_torch.models import mla

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-5, atol=1e-5)
WINDOW = 64


@pytest.fixture(scope="module")
def cfgs():
    return (jconfigs.get_config(ARCH).reduced(),
            configs.get_config(ARCH).reduced())


@pytest.fixture(scope="module")
def params(cfgs):
    jp = jmla.mla_init(jax.random.PRNGKey(4), cfgs[0])
    return jp, interop.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_matches_jax(cfgs, params, causal):
    jmc, tmc = cfgs
    jp, tp = params
    x = _x((2, 37, jmc.d_model), seed=1)
    pos = np.broadcast_to(np.arange(37)[None], (2, 37)).astype(np.int32)
    want = jmla.mla_attention(jp, jmc, jnp.asarray(x), jnp.asarray(pos),
                              causal=causal)
    got = mla.mla_attention(tp, tmc, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), causal=causal)
    _close(got, want)


def test_absorbed_decode_equals_the_full_sequence(cfgs, params):
    """Token by token through the latent cache (fp32) == the causal
    full-sequence form, within the port."""
    _, tmc = cfgs
    _, tp = params
    x = torch.from_numpy(_x((2, 30, tmc.d_model), seed=2))
    pos = torch.arange(30)[None].expand(2, 30)
    full = mla.mla_attention(tp, tmc, x, pos)
    cache = mla.init_cache(tmc, 2, 30, dtype=torch.float32)
    outs = []
    for t in range(30):
        out, cache = mla.decode_attention(tp, tmc, x[:, t:t + 1], cache)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_cache_stays_bf16_by_default(cfgs, params):
    """c_kv and k_rope are bf16 before and after a step, in JAX and in
    the port (the values written are rounded to bf16 in both)."""
    jmc, tmc = cfgs
    jp, tp = params
    x = _x((2, 1, jmc.d_model), seed=3)
    jc = jmla.init_cache(jmc, 2, 8)
    tc = mla.init_cache(tmc, 2, 8)
    jout, jc = jmla.decode_attention(jp, jmc, jnp.asarray(x), jc)
    tout, tc = mla.decode_attention(tp, tmc, torch.from_numpy(x), tc)
    for name in ("c_kv", "k_rope"):
        assert np.dtype(jc[name].dtype).name == "bfloat16"
        assert tc[name].dtype == torch.bfloat16
        _close(tc[name].float(), jnp.asarray(jc[name], jnp.float32))
    _close(tout, jout)


def test_ring_decode_with_rows_at_different_cursors_matches_jax(cfgs,
                                                                 params):
    """Rows that start at cursors 0, 23 and 50 (each filled alone first),
    then 80 steps together through a ring of 64 slots (every row wraps):
    each row's outputs and cache equal JAX's decode of that row alone."""
    jmc, tmc = cfgs
    jp, tp = params
    starts = (0, 23, 50)
    steps_ = 80
    xs = _x((len(starts), max(starts) + steps_, jmc.d_model), seed=5)
    jstep = jax.jit(lambda c, x: jmla.decode_attention(jp, jmc, x, c))
    jcaches, tcaches = [], []
    for r, n in enumerate(starts):
        jc = jmla.init_cache(jmc, 1, 512, window=WINDOW, dtype=jnp.float32)
        tc = mla.init_cache(tmc, 1, 512, window=WINDOW, dtype=torch.float32)
        for t in range(n):
            _, jc = jstep(jc, jnp.asarray(xs[r:r + 1, t:t + 1]))
            _, tc = mla.decode_attention(
                tp, tmc, torch.from_numpy(xs[r:r + 1, t:t + 1]), tc)
        jcaches.append(jc)
        tcaches.append(tc)
    # the rows side by side: one batch-3 cache with per-row cursors
    tc = {k: (torch.cat([c[k] for c in tcaches])
              if isinstance(v, torch.Tensor) else v)
          for k, v in tcaches[0].items()}
    assert tc["cursor"].tolist() == list(starts)
    for t in range(steps_):
        x = np.stack([xs[r, n + t] for r, n in enumerate(starts)])[:, None]
        tout, tc = mla.decode_attention(tp, tmc, torch.from_numpy(x), tc)
        for r in range(len(starts)):
            jout, jcaches[r] = jstep(jcaches[r], jnp.asarray(x[r:r + 1]))
            _close(tout[r:r + 1], jout)
    for r in range(len(starts)):
        jc = jcaches[r]
        assert int(tc["cursor"][r]) == int(jc["cursor"])
        np.testing.assert_array_equal(tc["slot_pos"][r].numpy(),
                                      np.asarray(jc["slot_pos"])[0])
        for name in ("c_kv", "k_rope"):
            _close(tc[name][r], np.asarray(jc[name])[0])
