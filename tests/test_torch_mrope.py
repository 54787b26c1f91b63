"""M-RoPE and the embedding frontend of repro_torch against repro's:
qwen2-vl-72b (patch-stub embeddings, 3-axis positions).

``apply_mrope`` on its own, then the reduced model (2 layers, d 256,
sections (16, 8, 8)) with JAX's parameters carried across
(``interop.params_from_jax``) and embeddings and position grids made
with numpy from a seed: the prefill (the port's flash path, plain on the
CPU, against JAX's non-flash prefill), the unrolled and scanned forward,
a train step's loss and gradients, and the decode fed embeddings on the
fp32, bf16 and int8 caches against JAX's jitted decode. At full width:
the config field for field and the parameter count.

Tolerances: ``apply_mrope`` 1e-6 (cos, sin and the products in fp32 on
both sides); prefill and forward logits rtol = atol = 1e-4 and the loss
and gradients 1e-5 (the frameworks sum the matmuls in other orders);
the fp32-cache decode 1e-5; the bf16 and int8 caches within 2e-3 of the
logits' scale (a K/V value at a rounding half lands one bf16 ulp or one
int8 step apart where the float32 sums differ by an ulp, as in
tests/test_torch_decode.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro.models import transformer_scan as jts
from repro.train import steps as jsteps
from repro_torch import configs, interop, serve
from repro_torch.core import pytree
from repro_torch.data import pipeline
from repro_torch.models import layers
from repro_torch.models import transformer as tt
from repro_torch.models import transformer_scan as tts
from repro_torch.train import steps

from _config_parity import assert_same_config

ARCH = "qwen2-vl-72b"
FULL_PARAMS = 72_706_203_648
FRONTEND_ARCHS = ("qwen2-vl-72b", "seamless-m4t-large-v2")
MROPE_TOL = dict(rtol=1e-6, atol=1e-6)
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_REL = 2e-3
B, S = 2, 40


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grid(b: int, s: int, seed: int) -> np.ndarray:
    """(B, 3, S) Qwen2-VL-style ids: text, a patch grid at one temporal
    id with row / column ids, text again, each row shifted."""
    rng = np.random.default_rng(seed)
    out = np.empty((b, 3, s), np.int32)
    for r in range(b):
        t0, rows, cols = int(rng.integers(0, 5)), 3, 5
        n = rows * cols
        text = np.arange(t0)
        grid = t0 + np.stack([np.zeros(n, int), np.repeat(np.arange(rows),
                                                           cols),
                              np.tile(np.arange(cols), rows)])
        tail = t0 + max(rows, cols) + np.arange(s - t0 - n)
        for a in range(3):
            out[r, a] = np.concatenate([text, grid[a], tail])
    return out


def _batch(mc, b, s, seed, *, positions3=True, labels=False):
    rng = np.random.default_rng(seed)
    batch = {"embeddings": (rng.normal(size=(b, s, mc.d_model)) * 0.5)
             .astype(np.float32)}
    if positions3:
        batch["positions3"] = _grid(b, s, seed)
    if labels:
        batch["labels"] = rng.integers(0, mc.vocab, size=(b, s)).astype(
            np.int32)
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
    assert t.reduced().mrope_sections == (16, 8, 8)


def test_count_params_matches_jax():
    t = configs.get_config(ARCH)
    assert tt.count_params(t) == jconfigs.get_config(ARCH).param_count() \
        == FULL_PARAMS


@pytest.mark.parametrize("case", ["three_axes", "grid", "bf16", "batched"])
def test_apply_mrope_matches_jax(case):
    """Each frequency slot takes its angle from its section's axis: three
    different axes (random ids), a patch grid, bf16 x, and positions
    with two leading batch dims."""
    rng = np.random.default_rng(3)
    lead = (2, 3) if case == "batched" else (2,)
    x = rng.normal(size=lead + (S, 4, 64)).astype(np.float32)
    pos = (_grid(2, S, 4) if case == "grid" else
           rng.integers(0, 5000, size=lead + (3, S)).astype(np.int32))
    kw = dict(theta=1_000_000.0, sections=(16, 8, 8))
    jx = jnp.asarray(x, jnp.bfloat16) if case == "bf16" else jnp.asarray(x)
    want = jlayers.apply_mrope(jx, jnp.asarray(pos), **kw)
    tx = torch.from_numpy(x)
    got = layers.apply_mrope(tx.bfloat16() if case == "bf16" else tx,
                             torch.from_numpy(pos), **kw)
    assert str(got.dtype).removeprefix("torch.") == np.dtype(
        want.dtype).name
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **MROPE_TOL)


def test_text_positions_make_mrope_rope():
    """With text ids (all three axes at the position) M-RoPE is RoPE, bit
    for bit; ``text_mrope_positions`` stacks as JAX's does."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, S, 4, 64)).astype(np.float32))
    pos = torch.arange(S)[None].expand(2, S)
    p3 = layers.text_mrope_positions(pos)
    np.testing.assert_array_equal(
        p3.numpy(), np.asarray(jlayers.text_mrope_positions(
            jnp.asarray(pos.numpy()))))
    got = layers.apply_mrope(x, p3, theta=1e6, sections=(16, 8, 8))
    assert torch.equal(got, layers.apply_rope(x, pos, theta=1e6))


@pytest.mark.parametrize("positions3", [True, False])
def test_prefill_logits_match_jax(model, positions3):
    """The port's flash prefill (plain flash on the CPU) of stub
    embeddings, on a position grid or at the default text positions,
    against JAX's non-flash prefill."""
    jmc, tmc, jp, tp, _, _ = model
    batch = _batch(jmc, B, S, seed=1, positions3=positions3)
    want = jax.jit(jsteps.make_prefill_step(jmc, scan_layers=True))(
        jp, _jax(batch))
    got = steps.make_prefill_step(tmc, use_flash=True, scan_layers=True,
                                  logits_positions="last")(tp, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)


def test_unrolled_and_scanned_apply_match_jax(model):
    """JAX's unrolled forward against the port's unrolled one; the port's
    scanned form on the same weights (stacked) gives the same logits."""
    jmc, tmc, _, _, jpu, tpu = model
    batch = _batch(jmc, B, S, seed=2)
    want, _ = jax.jit(lambda p, b: jt.apply(p, jmc, b))(jpu, _jax(batch))
    got = tt.apply(tpu, tmc, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)
    scanned = tts.apply(_stacked_like_scan(tpu, tmc), tmc, _torch(batch))
    np.testing.assert_allclose(scanned.numpy(), got.numpy(), **TOL)


def _stacked_like_scan(params, cfg):
    """The unrolled tree as the scanned one (the same weights)."""
    prefix, unit, n_rep, _ = tts.pattern_segments(cfg)
    lay = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["prefix_layers"] = lay[:len(prefix)]
    out["scan_blocks"] = [
        pytree.tree_map(lambda *xs: torch.stack(xs),
                        *[lay[len(prefix) + r * len(unit) + j]
                          for r in range(n_rep)])
        for j in range(len(unit))]
    out["suffix_layers"] = lay[len(prefix) + n_rep * len(unit):]
    return out


def test_train_step_loss_and_gradients_match_jax(model):
    """Loss and every gradient of a scanned, rematerialised train step on
    embeddings, positions3 and labels; the port's make_train_step takes
    the same batch."""
    jmc, tmc, jp, tp, _, _ = model
    batch = _batch(jmc, B, 24, seed=3, labels=True)
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
    from repro_torch.optim import optimizers
    opt = optimizers.adamw(1e-3)
    state = {"params": pytree.tree_map(torch.clone, tp),
             "opt": opt.init(tp), "step": torch.zeros((), dtype=torch.int32),
             "rng": torch.zeros(2, dtype=torch.int64)}
    step = steps.make_train_step(tmc, opt, steps.TrainStepConfig(**scfg))
    _, metrics = step(state, _torch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(wl), **TOL)


@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
def test_decode_of_embeddings_matches_jax_jitted(model, cache):
    """8 decode steps fed stub embeddings (M-RoPE at text positions, as
    JAX's decode rotates) against JAX's jitted make_serve_step; the
    scanned port equals the unrolled one bit for bit."""
    jmc, tmc, _, _, jpu, tpu = model
    emb = _batch(jmc, B, 8, seed=4, positions3=False)["embeddings"]
    q = cache == "int8"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if cache == "bf16"
                else (jnp.float32, torch.float32))
    jst = jt.init_decode_state(jpu, jmc, B, 10, dtype=jdt, quantize_kv=q)
    tst = tt.init_decode_state(tpu, tmc, B, 10, dtype=tdt, quantize_kv=q)
    sp = _stacked_like_scan(tpu, tmc)
    sst = tts.init_decode_state(sp, tmc, B, 10, dtype=tdt, quantize_kv=q)
    jstep = jax.jit(jsteps.make_serve_step(jmc))
    tstep, sstep = (steps.make_serve_step(tmc),
                    steps.make_serve_step(tmc, scan_layers=True))
    for i in range(8):
        e = emb[:, i:i + 1]
        jl, jst = jstep(jpu, jst, {"embeddings": jnp.asarray(e)})
        tl, tst = tstep(tpu, tst, {"embeddings": torch.from_numpy(e)})
        sl, sst = sstep(sp, sst, {"embeddings": torch.from_numpy(e)})
        assert torch.equal(sl, tl)
        want = np.asarray(jl)
        if cache == "fp32":
            np.testing.assert_allclose(tl.numpy(), want, **TOL)
        else:
            assert np.abs(tl.numpy() - want).max() <= \
                CACHE_REL * np.abs(want).max()


def test_decode_at_text_positions_equals_the_prefill(model):
    """Embeddings fed one at a time through make_serve_step (fp32 cache)
    give the last logits of the prefill at text positions, within 1e-5;
    a token step afterwards looks the token up in the embedding."""
    _, tmc, _, _, _, tpu = model
    emb = torch.from_numpy(_batch(tmc, B, 12, seed=5,
                                  positions3=False)["embeddings"])
    want = steps.make_prefill_step(tmc)(tpu, {"embeddings": emb})
    st = tt.init_decode_state(tpu, tmc, B, 16, dtype=torch.float32)
    step = steps.make_serve_step(tmc)
    for i in range(12):
        logits, st = step(tpu, st, {"embeddings": emb[:, i:i + 1]})
    torch.testing.assert_close(logits, want, **TOL)
    tok = logits.argmax(-1, keepdim=True)
    logits, st = step(tpu, st, {"tokens": tok})
    assert logits.shape == (B, tmc.vocab) and bool(torch.isfinite(
        logits).all())
    assert int(st["layers"][0]["cursor"][0]) == 13


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_engine_and_bulk_prefill_refuse_stub_frontends(arch):
    """The serve engine and the bulk prefill speak token frontends only,
    as JAX's do (tests/test_serve.py)."""
    tmc = configs.get_config(arch).reduced()
    jmc = jconfigs.get_config(arch).reduced()
    kw = dict(arch=arch, slots=1, max_len=8, prompt_len=2, n_requests=1)
    with pytest.raises(ValueError, match="token frontends"):
        serve.Engine(serve.ServeConfig(**kw), model_cfg=tmc, device="cpu")
    with pytest.raises(ValueError, match="token frontends"):
        jserve.Engine(jserve.ServeConfig(**kw), model_cfg=jmc)
    for make in (steps.make_bulk_prefill, jsteps.make_bulk_prefill):
        with pytest.raises(ValueError, match="token frontend"):
            make(tmc if make is steps.make_bulk_prefill else jmc)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_batch_shapes_match_jax(arch, shape):
    """``make_batch_shapes`` of the frontend configs: the names, shapes and
    dtypes of JAX's (embeddings, positions3, src_embeddings, labels)."""
    want = jpipeline.make_batch_shapes(jconfigs.get_config(arch),
                                       jconfigs.get_shape(shape))
    got = pipeline.make_batch_shapes(configs.get_config(arch),
                                     configs.get_shape(shape))
    assert sorted(got) == sorted(want)
    for k, sd in want.items():
        assert tuple(got[k].shape) == tuple(sd.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == \
            np.dtype(sd.dtype).name, k
