"""The encoder-decoder stack of repro_torch against repro's:
seamless-m4t-large-v2 (frame-stub embeddings, a bidirectional encoder,
decoder blocks with cross attention over the encoder memory).

The reduced model (2 encoder and 2 decoder layers, d 256) with JAX's
parameters carried across (``interop.params_from_jax``, checked bit for
bit on the encoder and cross leaves, fp32 and bf16) and inputs made with
numpy from a seed: ``cross_attention`` / ``memory_kv``, ``encode`` in
both tree forms, the prefill (the port's flash path on the decoder,
plain on the CPU, against JAX's non-flash prefill), the unrolled and
scanned forward, a train step's loss and gradients, and the decode over
the encoder memory on the fp32, bf16 and int8 caches against JAX's
jitted decode. At full width: the config field for field and the
parameter count.

Tolerances: cross attention and the encoder 1e-5; prefill and forward
logits rtol = atol = 1e-4; the loss and gradients 1e-5 (the frameworks
sum the matmuls in other orders); the fp32-cache decode 1e-5; the bf16
and int8 caches within 2e-3 of the logits' scale (a K/V value at a
rounding half lands one bf16 ulp or one int8 step apart where the
float32 sums differ by an ulp, as in tests/test_torch_decode.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models import transformer_scan as jts
from repro.train import steps as jsteps
from repro_torch import configs, interop
from repro_torch.core import pytree
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models import transformer_scan as tts
from repro_torch.train import steps

from _config_parity import assert_same_config

ARCH = "seamless-m4t-large-v2"
FULL_PARAMS = 1_632_550_912
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_REL = 2e-3
B, S, SRC = 2, 24, 20


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _emb(mc, b, s, seed):
    return (np.random.default_rng(seed).normal(size=(b, s, mc.d_model))
            * 0.5).astype(np.float32)


def _batch(mc, seed, *, labels=False):
    batch = {"embeddings": _emb(mc, B, S, seed),
             "src_embeddings": _emb(mc, B, SRC, seed + 100)}
    if labels:
        batch["labels"] = np.random.default_rng(seed).integers(
            0, mc.vocab, size=(B, S)).astype(np.int32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX stacked + unrolled params, the port's)."""
    jmc = jconfigs.get_config(ARCH).reduced()
    tmc = configs.get_config(ARCH).reduced()
    jp = jts.init(jmc, jax.random.PRNGKey(0))
    jpu = jt.init(jmc, jax.random.PRNGKey(1))
    return (jmc, tmc, jp, interop.params_from_jax(_np(jp)), jpu,
            interop.params_from_jax(_np(jpu)))


def test_config_copy_matches_jax():
    j, t = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert_same_config(b, a)
    assert t.reduced().n_encoder_layers == 2 and t.is_encdec


def test_count_params_matches_jax():
    t = configs.get_config(ARCH)
    assert tt.count_params(t) == jconfigs.get_config(ARCH).param_count() \
        == FULL_PARAMS


def test_all_configs_and_get_shape_match_jax():
    """``all_configs`` holds the JAX package's 11 arch ids (each config is
    compared in tests/test_torch_model.py) and ``get_shape`` its four
    input shapes."""
    assert sorted(configs.all_configs()) == sorted(jconfigs.all_configs())
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(jconfigs.get_shape(name))


@pytest.mark.parametrize("form", ["unrolled", "scanned"])
def test_port_init_has_the_jax_tree(model, form):
    """The port's own init: JAX's leaves (encoder, cross and ln_cross
    included), shapes and order, in both tree forms."""
    jmc, tmc, jp, _, jpu, _ = model
    impl, want = (tt, jpu) if form == "unrolled" else (tts, jp)
    got = impl.init(tmc, tts.generator(0))
    assert sorted(got) == sorted(want)
    assert sorted(got["encoder"]) == sorted(want["encoder"])
    jl = jax.tree_util.tree_leaves(want)
    tl = pytree.tree_leaves(got)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_carries_encoder_and_cross_leaves(model, dtype):
    """``params_from_jax`` carries the encoder subtree and the decoder's
    ``cross`` / ``ln_cross`` leaves of both tree forms bit for bit."""
    _, _, jp, _, jpu, _ = model
    for tree in (jp, jpu):
        tree = jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)
        got = interop.params_from_jax(_np(tree))
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(_np(tree)),
                pytree.tree_leaves(got)):
            assert str(b.dtype).removeprefix("torch.") == dtype
            bits = np.uint16 if dtype == "bfloat16" else np.uint32
            view = torch.int16 if dtype == "bfloat16" else torch.int32
            np.testing.assert_array_equal(b.view(view).numpy().view(bits),
                                          a.view(bits), err_msg=str(path))
        keys = jax.tree_util.keystr
        names = [keys(p) for p, _ in jax.tree_util.tree_leaves_with_path(
            tree)]
        assert any("encoder" in n for n in names)
        assert any("ln_cross" in n for n in names)


def test_cross_attention_and_memory_kv_match_jax(model):
    jmc, tmc, _, _, jpu, tpu = model
    memory, x = _emb(jmc, B, SRC, 7), _emb(jmc, B, S, 8)
    jp, tp = jpu["layers"][0]["cross"], tpu["layers"][0]["cross"]
    jkv = jattn.memory_kv(jp, jmc, jnp.asarray(memory))
    tkv = tattn.memory_kv(tp, tmc, torch.from_numpy(memory))
    for a, b in zip(tkv, jkv):
        assert tuple(a.shape) == (B, SRC, tmc.n_kv_heads, tmc.head_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    want = jattn.cross_attention(jp, jmc, jnp.asarray(x), jkv)
    got = tattn.cross_attention(tp, tmc, torch.from_numpy(x), tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", ["unrolled", "scanned"])
def test_encode_matches_jax(model, form):
    jmc, tmc, jp, tp, jpu, tpu = model
    src = _emb(jmc, B, SRC, 9)
    if form == "unrolled":
        want = jt.encode(jpu, jmc, jnp.asarray(src))
        got = tt.encode(tpu, tmc, torch.from_numpy(src))
    else:
        want = jts.encode(jp, jmc, jnp.asarray(src))
        got = tts.encode(tp, tmc, torch.from_numpy(src), remat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_logits_match_jax_and_flash_runs_on_the_decoder_only(
        model, monkeypatch):
    """The port's flash prefill (plain flash on the CPU) against JAX's
    non-flash prefill; the flash path is taken once per decoder layer
    and never in the encoder or the cross attention."""
    jmc, tmc, jp, tp, _, _ = model
    batch = _batch(jmc, seed=1)
    want = jax.jit(jsteps.make_prefill_step(jmc, scan_layers=True))(
        jp, _jax(batch))
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = steps.make_prefill_step(tmc, use_flash=True, scan_layers=True,
                                  logits_positions="last")(tp, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)
    assert len(calls) == tmc.n_layers
    tts.encode(tp, tmc, torch.from_numpy(batch["src_embeddings"]))
    assert len(calls) == tmc.n_layers


def test_unrolled_and_scanned_apply_match_jax(model):
    jmc, tmc, _, _, jpu, tpu = model
    batch = _batch(jmc, seed=2)
    want, _ = jax.jit(lambda p, b: jt.apply(p, jmc, b))(jpu, _jax(batch))
    got = tt.apply(tpu, tmc, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)
    scanned = tts.apply(_stacked_like_scan(tpu, tmc), tmc, _torch(batch))
    np.testing.assert_allclose(scanned.numpy(), got.numpy(), **TOL)


def _stacked_like_scan(params, cfg):
    """The unrolled tree as the scanned one (the same weights): decoder
    layers stacked on n_rep, the encoder's layers into its one stacked
    block."""
    prefix, unit, n_rep, _ = tts.pattern_segments(cfg)
    lay = params["layers"]
    stack = lambda blocks: pytree.tree_map(  # noqa: E731
        lambda *xs: torch.stack(xs), *blocks)
    out = {k: v for k, v in params.items() if k not in ("layers",
                                                         "encoder")}
    out["prefix_layers"] = lay[:len(prefix)]
    out["scan_blocks"] = [stack([lay[len(prefix) + r * len(unit) + j]
                                 for r in range(n_rep)])
                          for j in range(len(unit))]
    out["suffix_layers"] = lay[len(prefix) + n_rep * len(unit):]
    out["encoder"] = {"scan_blocks": stack(params["encoder"]["layers"]),
                      "final_norm": params["encoder"]["final_norm"]}
    return out


def test_train_step_loss_and_gradients_match_jax(model):
    """Loss and every gradient (encoder and cross attention included) of
    a scanned, rematerialised train step on stub embeddings, source
    frames and labels."""
    jmc, tmc, jp, tp, _, _ = model
    batch = _batch(jmc, seed=3, labels=True)
    scfg = dict(scan_layers=True, remat=True)
    jloss = jsteps.make_loss_fn(jmc, jsteps.TrainStepConfig(**scfg))
    wl, wg = jax.jit(jax.value_and_grad(jloss))(jp, _jax(batch))
    tloss = steps.make_loss_fn(tmc, steps.TrainStepConfig(**scfg))
    gl, gg = steps.value_and_grad(tloss, tp, _torch(batch))
    np.testing.assert_allclose(float(gl), float(wl), **TOL)
    wleaves, gleaves = jax.tree_util.tree_leaves(wg), pytree.tree_leaves(gg)
    assert len(wleaves) == len(gleaves)
    for a, b in zip(gleaves, wleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
def test_decode_with_memory_matches_jax_jitted(model, cache):
    """8 token steps over the encoder memory against JAX's jitted
    make_serve_step; the scanned port equals the unrolled one bit for
    bit; the memory K/V keep the params' dtype (fp32) on every cache, and
    the int8 cache quantizes the self-attention K/V only."""
    jmc, tmc, _, _, jpu, tpu = model
    src = _emb(jmc, B, SRC, 10)
    toks = np.random.default_rng(11).integers(0, jmc.vocab, size=(B, 8)
                                              ).astype(np.int32)
    q = cache == "int8"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if cache == "bf16"
                else (jnp.float32, torch.float32))
    jmem = jt.encode(jpu, jmc, jnp.asarray(src))
    tmem = tt.encode(tpu, tmc, torch.from_numpy(src))
    jst = jt.init_decode_state(jpu, jmc, B, 10, dtype=jdt, quantize_kv=q,
                               memory=jmem)
    tst = tt.init_decode_state(tpu, tmc, B, 10, dtype=tdt, quantize_kv=q,
                               memory=tmem)
    sp = _stacked_like_scan(tpu, tmc)
    sst = tts.init_decode_state(sp, tmc, B, 10, dtype=tdt, quantize_kv=q,
                                memory=tts.encode(sp, tmc,
                                                  torch.from_numpy(src)))
    for k, v in tst["memory_kv"]:
        assert k.dtype == v.dtype == torch.float32
    assert tst["layers"][0]["k"].dtype == (torch.int8 if q else tdt)
    jstep = jax.jit(jsteps.make_serve_step(jmc))
    tstep, sstep = (steps.make_serve_step(tmc),
                    steps.make_serve_step(tmc, scan_layers=True))
    for i in range(8):
        tok = toks[:, i:i + 1]
        jl, jst = jstep(jpu, jst, {"tokens": jnp.asarray(tok)})
        tl, tst = tstep(tpu, tst, {"tokens": torch.from_numpy(tok)})
        sl, sst = sstep(sp, sst, {"tokens": torch.from_numpy(tok)})
        assert torch.equal(sl, tl)
        want = np.asarray(jl)
        if cache == "fp32":
            np.testing.assert_allclose(tl.numpy(), want, **TOL)
        else:
            assert np.abs(tl.numpy() - want).max() <= \
                CACHE_REL * np.abs(want).max()


def test_decode_over_memory_equals_the_full_sequence_apply(model):
    """Greedy tokens decoded over the encoder memory (fp32 cache) give,
    step by step, the logits of one full-sequence apply on the same
    tokens and source frames (how the card run holds the full model)."""
    _, tmc, _, tp, _, _ = model
    src = torch.from_numpy(_emb(tmc, 1, SRC, 12))
    st = tts.init_decode_state(tp, tmc, 1, 12, dtype=torch.float32,
                               memory=tts.encode(tp, tmc, src))
    step = steps.make_serve_step(tmc, scan_layers=True)
    tok, toks, outs = torch.zeros((1, 1), dtype=torch.int32), [], []
    for _ in range(12):
        toks.append(tok)
        logits, st = step(tp, st, {"tokens": tok})
        outs.append(logits)
        tok = logits.argmax(-1, keepdim=True).int()
    full = tts.apply(tp, tmc, {"tokens": torch.cat(toks, 1),
                               "src_embeddings": src})
    torch.testing.assert_close(torch.stack(outs, 1), full, **TOL)


@pytest.mark.parametrize("form", ["unrolled", "scanned"])
def test_init_decode_state_without_memory_raises(model, form):
    """As JAX's: the enc-dec decode needs the encoder memory."""
    jmc, tmc, jp, tp, jpu, tpu = model
    impl, jimpl, p, jparams = ((tt, jt, tpu, jpu) if form == "unrolled"
                               else (tts, jts, tp, jp))
    with pytest.raises(ValueError, match="needs encoder memory"):
        impl.init_decode_state(p, tmc, 1, 4)
    with pytest.raises(ValueError, match="needs encoder memory"):
        jimpl.init_decode_state(jparams, jmc, 1, 4)
