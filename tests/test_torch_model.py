"""repro_torch's model path against repro's: reduced qwen1.5-0.5b
(2 layers, d=256, vocab 512) parameters carried across with
``params_from_jax`` give the JAX decode step's and bulk prefill's
logits, fp32, for the full and the ring-buffer (window=4) cache.

Tolerance rtol = atol = 1e-5: the two frameworks sum the matmuls and
the softmax in different orders; a different model would be off by
orders of magnitude more."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer_scan as jts
from repro.train import steps as jsteps
from repro_torch import configs, interop
from repro_torch.core import pytree
from repro_torch.models import attention as tattn
from repro_torch.models import transformer_scan as tts
from repro_torch.train import steps

from _config_parity import assert_same_config

ARCH = "qwen1.5-0.5b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    jmc = jconfigs.get_config(ARCH).reduced()
    tmc = configs.get_config(ARCH).reduced()
    jp = jts.init(jmc, jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jmc, tmc, jp, tp


def _tokens(mc, b, p, seed=1):
    return np.random.default_rng(seed).integers(
        0, mc.vocab, size=(b, p)).astype(np.int32)


def test_config_copy_matches_jax():
    for reduced in (False, True):
        j = jconfigs.get_config(ARCH)
        t = configs.get_config(ARCH)
        j, t = (j.reduced(), t.reduced()) if reduced else (j, t)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "qkv_bias", "rope_theta",
                  "tie_embeddings", "block_pattern", "norm_eps"):
            assert getattr(t, f) == getattr(j, f), f


def test_other_architectures_are_not_ported_yet():
    """Every architecture of the JAX package is ported now: all 11 of its
    arch ids resolve to the port's copy of the config, and an unknown id
    still raises a KeyError that lists them."""
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")
    for arch in jconfigs._MODULES:
        assert_same_config(configs.get_config(arch),
                           jconfigs.get_config(arch), arch)
    assert len(jconfigs._MODULES) == 11
    assert not hasattr(configs, "NOT_PORTED")


def test_port_init_has_the_jax_tree(model):
    jmc, tmc, jp, _ = model
    gp = tts.init(tmc, tts.generator(0))
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl = pytree.tree_leaves(gp)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert sorted(gp) == ["embed", "final_norm", "prefix_layers",
                          "scan_blocks", "suffix_layers"]
    assert tts.pattern_segments(tmc) == jts.pattern_segments(jmc)


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("window", [0, 4])
def test_decode_caches_default_to_the_jax_dtype(model, window):
    """``init_decode_state`` and ``attention.init_cache`` called without
    a dtype store K and V in JAX's default (bf16); the fp32 callers pass
    it explicitly."""
    jmc, tmc, jp, tp = model
    jst = jts.init_decode_state(jp, jmc, 2, 8, window=window)
    tst = tts.init_decode_state(tp, tmc, 2, 8, window=window)
    jc = jattn.init_cache(jmc, 2, 8, window=window)
    tc = tattn.init_cache(tmc, 2, 8, window=window)
    for j, t in [(jst["scan"][0], tst["scan"][0]), (jc, tc)]:
        for name in ("k", "v"):
            assert _dtype_name(t[name]) == np.dtype(j[name].dtype).name \
                == "bfloat16"
    fp32 = tts.init_decode_state(tp, tmc, 2, 8, window=window,
                                 dtype=torch.float32)
    assert fp32["scan"][0]["k"].dtype == torch.float32


@pytest.mark.parametrize("window", [0, 4])
def test_decode_step_logits_match_jax(model, window):
    jmc, tmc, jp, tp = model
    B, P = 2, 9
    toks = _tokens(jmc, B, P)
    jst = jts.init_decode_state(jp, jmc, B, P + 4, window=window,
                                dtype=jnp.float32)
    tst = tts.init_decode_state(tp, tmc, B, P + 4, window=window,
                                dtype=torch.float32)
    jstep = jax.jit(jsteps.make_serve_step(jmc, scan_layers=True))
    tstep = steps.make_serve_step(tmc, scan_layers=True)
    for i in range(P):
        jl, jst = jstep(jp, jst, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        tl, tst = tstep(tp, tst,
                        {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the caches agree too (post-RoPE keys, values, slot positions)
    jc, tc = jst["scan"][0], tst["scan"][0]
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    assert (tc["cursor"].numpy() == np.asarray(jc["cursor"])[:, None]).all()


@pytest.mark.parametrize("window", [0, 4])
def test_bulk_prefill_matches_jax_and_is_token_by_token(model, window):
    jmc, tmc, jp, tp = model
    B, P = 2, 7
    toks = _tokens(jmc, B, P, seed=2)
    jst = jts.init_decode_state(jp, jmc, B, P + 3, window=window,
                                dtype=jnp.float32)
    jl, _ = jax.jit(jsteps.make_bulk_prefill(jmc, scan_layers=True))(
        jp, jst, jnp.asarray(toks))
    bulk = steps.make_bulk_prefill(tmc, scan_layers=True)
    tst = tts.init_decode_state(tp, tmc, B, P + 3, window=window,
                                dtype=torch.float32)
    tl, bst = bulk(tp, tst, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # within the port: bit-identical to feeding the tokens one by one
    st = tts.init_decode_state(tp, tmc, B, P + 3, window=window,
                               dtype=torch.float32)
    step = steps.make_serve_step(tmc, scan_layers=True)
    for i in range(P):
        logits, st = step(tp, st,
                          {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()})
    assert torch.equal(logits, tl)
    for a, b in zip(pytree.tree_leaves(st), pytree.tree_leaves(bst)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


def test_rows_keep_their_own_cursor(model):
    """The slot axis is a batch axis: a row advanced alone equals the
    same row decoded in a batch (per-row cursor and ring slot)."""
    _, tmc, _, tp = model
    toks = torch.from_numpy(_tokens(tmc, 2, 5, seed=3)).long()
    step = steps.make_serve_step(tmc, scan_layers=True)
    both = tts.init_decode_state(tp, tmc, 2, 8, window=4,
                                 dtype=torch.float32)
    for i in range(5):
        lb, both = step(tp, both, {"tokens": toks[:, i:i + 1]})
    solo = tts.init_decode_state(tp, tmc, 1, 8, window=4,
                                 dtype=torch.float32)
    for i in range(5):
        ls, solo = step(tp, solo, {"tokens": toks[1:, i:i + 1]})
    torch.testing.assert_close(ls[0], lb[1], rtol=1e-5, atol=1e-5)


def test_unported_norm_and_activation_raise(model):
    """A norm kind outside rmsnorm / layernorm (LayerNorm came with the
    rwkv slice) has no JAX counterpart; the port refuses it instead of
    computing something else. (M-RoPE is ported: tests/test_torch_mrope.py.)"""
    import dataclasses
    _, tmc, _, _ = model
    mc = dataclasses.replace(tmc, norm="groupnorm")
    with pytest.raises(NotImplementedError, match="not ported"):
        p = tts.init(mc, tts.generator(0))
        st = tts.init_decode_state(p, mc, 1, 4, dtype=torch.float32)
        tts.decode_step(p, mc, {"tokens": torch.zeros((1, 1),
                                                      dtype=torch.long)},
                        st)
