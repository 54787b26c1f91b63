"""repro_torch's unrolled decode and int8 KV cache against repro's, and
bf16 trees carried across with ``interop``.

The same reduced parameters (JAX's init, carried across with
``interop.params_from_jax``) and the same tokens (numpy from a seed) go
through JAX's JITTED ``transformer.decode_step`` (how JAX serves) and
the port's. Tolerances:

  * fp32 cache: rtol = atol = 1e-5 on the logits, as
    tests/test_torch_model.py (float32 sums in another order);
  * int8 cache: max |d logits| <= INT8_REL * max |logits|, and the int8
    codes equal JAX's but for a few that differ by one. A code is
    round(kv / scale); where an ulp of upstream float32 difference puts
    kv / scale on the other side of a half, the code moves by one step
    (max|kv| / 127), and the logits by a few 1e-4 relative (5e-4
    measured on reduced qwen1.5-0.5b). Comparing the codes bit for bit
    would test the matmul order, not the cache;
  * bf16 prefill: relative L2 <= 0.05, chip_smoke.py's bf16 rule (bf16
    rounds at other places in the two frameworks).
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
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models import transformer_scan as tts
from repro_torch.train import steps

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_REL = 2e-3
BF16_REL_L2 = 0.05
ARCHS = ("qwen1.5-0.5b", "rwkv6-3b", "recurrentgemma-9b",
         "deepseek-v2-lite-16b", "grok-1-314b")
B, P = 2, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, port cfg, JAX unrolled params, port params)."""
    out = {}
    for arch in ARCHS:
        jmc = jconfigs.get_config(arch).reduced()
        tmc = configs.get_config(arch).reduced()
        jp = jt.init(jmc, jax.random.PRNGKey(0))
        out[arch] = (jmc, tmc, jp, interop.params_from_jax(_np(jp)))
    return out


def _tokens(vocab, b=B, p=P, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, p)).astype(np.int32)


def _stacked_like_scan(params, cfg):
    """The port's unrolled tree as the scanned tree: the repeating
    unit's layers stacked on a leading n_rep dim (the same weights)."""
    prefix, unit, n_rep, suffix = tts.pattern_segments(cfg)
    layers = params["layers"]
    off = len(prefix) + n_rep * len(unit)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["prefix_layers"] = layers[:len(prefix)]
    out["scan_blocks"] = [
        pytree.tree_map(lambda *xs: torch.stack(xs),
                        *[layers[len(prefix) + r * len(unit) + j]
                          for r in range(n_rep)])
        for j in range(len(unit))] if n_rep else []
    out["suffix_layers"] = layers[off:]
    return out


# ---------------------------------------------------------------------------
# bf16 across interop
# ---------------------------------------------------------------------------


def test_bf16_trees_and_decode_caches_cross_bit_for_bit(models):
    """A bf16 parameter tree, train state and exchange state, and JAX's
    default (bf16) decode caches, carried across bit for bit as
    torch.bfloat16."""
    jmc, _, jp32, _ = models["qwen1.5-0.5b"]
    jp = _bf16(jp32)
    rng = np.random.default_rng(7)
    jst = jax.tree_util.tree_map(           # JAX's default caches, filled
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype)
        if a.dtype == jnp.bfloat16 else a,
        jt.init_decode_state(jp, jmc, 2, 8))
    for tree, carry in ((jp, interop.params_from_jax),
                        (jst, interop.params_from_jax),
                        ({"params": jp}, interop.train_state_from_jax),
                        (jp, interop.exchange_state_from_jax)):
        jl = jax.tree_util.tree_leaves(_np(tree))
        tl = pytree.tree_leaves(carry(_np(tree)))
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            if a.dtype.name != "bfloat16":
                continue
            assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
    assert any(t.dtype == torch.bfloat16 for t in pytree.tree_leaves(
        interop.params_from_jax(_np(jst))))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "command-r-35b"])
def test_reduced_bf16_prefill_matches_jax(arch):
    """bf16 parameters from JAX (JAX's init cast to bf16, as its
    ``dtype=bf16`` init casts), the same 2 x 100 tokens through both
    packages' prefill: the port's logits within relative L2 0.05 of
    JAX's, bf16 both."""
    jmc = jconfigs.get_config(arch).reduced()
    tmc = configs.get_config(arch).reduced()
    jp = _bf16(jt.init(jmc, jax.random.PRNGKey(2)))
    tp = interop.params_from_jax(_np(jp))
    toks = _tokens(jmc.vocab, 2, 100, seed=3)
    want = np.asarray(jax.jit(jsteps.make_prefill_step(jmc))(
        jp, {"tokens": jnp.asarray(toks)}), np.float32)
    got = steps.make_prefill_step(tmc)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------


def test_quantize_kv_equals_jax_jitted():
    """``_quantize_kv`` codes and scales equal JAX's JITTED ones, where
    XLA folds max|kv| / 127 into a multiply by the fp32 reciprocal; JAX's
    eager form divides truly and gives other scales at this shape (the
    pin: the two JAX forms differ). Dequantize equals JAX's."""
    kv = (np.random.default_rng(4).normal(size=(64, 1, 16, 64)) * 3).astype(
        np.float32)
    kv[0, 0, 0] = 0.0                            # the 1e-8 floor
    jcodes, jscale = jax.jit(jattn._quantize_kv)(jnp.asarray(kv))
    _, escale = jattn._quantize_kv(jnp.asarray(kv))
    assert (np.asarray(escale) != np.asarray(jscale)).any()
    codes, scale = tattn._quantize_kv(torch.from_numpy(kv))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(jscale).view(np.uint32))
    want = jax.jit(jattn._dequantize_kv, static_argnums=2)(
        jcodes, jscale, jnp.float32)
    np.testing.assert_array_equal(
        tattn._dequantize_kv(codes, scale, torch.float32).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_init_decode_state_matches_jax(models, quantize_kv):
    """Unrolled and scanned decode states: the same leaves with the same
    shapes and dtypes as JAX's for every block kind (K/V int8 and fp32
    scales with quantize_kv). Kept the port's own: the per-row (B,)
    int64 cursor against JAX's scalar int32 one, int64 slot positions,
    and the rglru window in the promoted dtype."""
    for arch in ARCHS:
        jmc, tmc, jp, tp = models[arch]
        jst = jt.init_decode_state(jp, jmc, B, 16, quantize_kv=quantize_kv)
        tst = tt.init_decode_state(tp, tmc, B, 16, quantize_kv=quantize_kv)
        assert len(jst["layers"]) == len(tst["layers"])
        for kind, js, ts in zip(jmc.block_pattern, jst["layers"],
                                tst["layers"]):
            assert sorted(js) == sorted(ts), (arch, kind)
            for name, a in js.items():
                t = ts[name]
                if name in ("cursor", "window"):
                    continue
                assert tuple(t.shape) == a.shape, (arch, kind, name)
                if name == "slot_pos":
                    assert t.dtype == torch.int64
                elif not (kind == "rglru" and name == "conv"):
                    assert str(t.dtype).removeprefix("torch.") == \
                        np.dtype(a.dtype).name, (arch, kind, name)
            if "k_scale" in ts:
                assert ts["k"].dtype == torch.int8 and \
                    ts["k_scale"].shape == ts["k"].shape[:-1] + (1,)
        jss = jts.init_decode_state(None, jmc, B, 16,    # params: enc-dec
                                    quantize_kv=quantize_kv)
        tss = tts.init_decode_state(_stacked_like_scan(tp, tmc), tmc, B, 16,
                                    quantize_kv=quantize_kv)
        for part in ("prefix", "scan", "suffix"):
            for js, ts in zip(jss[part], tss[part]):
                assert sorted(js) == sorted(ts)
                for name in ("k", "v", "k_scale", "v_scale"):
                    if name in js:
                        assert tuple(ts[name].shape) == js[name].shape
                        assert str(ts[name].dtype).removeprefix("torch.") \
                            == np.dtype(js[name].dtype).name


def _codes_close(jst, tst) -> None:
    """int8 codes equal JAX's but for at most a few per thousand, each
    off by one (a rounding half, see the module note)."""
    for js, ts in zip(jst["layers"], tst["layers"]):
        for name in ("k", "v"):
            if name + "_scale" not in js:
                continue
            a = np.asarray(js[name]).astype(np.int32)
            b = ts[name].numpy().astype(np.int32)
            assert np.abs(a - b).max() <= 1
            assert (a != b).mean() <= 1e-3


# every block kind on the fp32 cache; the int8 cache where a model has an
# attention KV cache to quantize (rwkv6-3b has none, and deepseek's MLA
# latent cache stays unquantized in JAX too, so their int8 runs are the
# fp32 ones)
@pytest.mark.parametrize("arch,quantize_kv", [
    ("qwen1.5-0.5b", False), ("qwen1.5-0.5b", True), ("rwkv6-3b", False),
    ("recurrentgemma-9b", False), ("recurrentgemma-9b", True),
    ("deepseek-v2-lite-16b", False), ("grok-1-314b", False),
    ("grok-1-314b", True)])
def test_unrolled_decode_matches_jax_jitted(models, arch, quantize_kv):
    """12 steps of the unrolled decode (fp32 cache, or int8 with
    quantize_kv) against JAX's jitted make_serve_step: logits at TOL
    (fp32) or within INT8_REL of the logits' scale (int8), the int8
    codes with them; the unrolled port equals its scanned form."""
    jmc, tmc, jp, tp = models[arch]
    toks = _tokens(jmc.vocab)
    jst = jt.init_decode_state(jp, jmc, B, P + 2, dtype=jnp.float32,
                               quantize_kv=quantize_kv)
    tst = tt.init_decode_state(tp, tmc, B, P + 2, dtype=torch.float32,
                               quantize_kv=quantize_kv)
    sp = _stacked_like_scan(tp, tmc)
    sst = tts.init_decode_state(sp, tmc, B, P + 2, dtype=torch.float32,
                                quantize_kv=quantize_kv)
    jstep = jax.jit(jsteps.make_serve_step(jmc))
    tstep = steps.make_serve_step(tmc)
    sstep = steps.make_serve_step(tmc, scan_layers=True)
    for i in range(P):
        tok = toks[:, i:i + 1]
        jl, jst = jstep(jp, jst, {"tokens": jnp.asarray(tok)})
        tl, tst = tstep(tp, tst, {"tokens": torch.from_numpy(tok).long()})
        sl, sst = sstep(sp, sst, {"tokens": torch.from_numpy(tok).long()})
        torch.testing.assert_close(sl, tl, rtol=0, atol=0)
        want = np.asarray(jl)
        if quantize_kv:
            assert np.abs(tl.numpy() - want).max() <= \
                INT8_REL * np.abs(want).max()
        else:
            np.testing.assert_allclose(tl.numpy(), want, **TOL)
    if quantize_kv:
        _codes_close(jst, tst)
    # JAX's int32 slot positions and scalar cursor; the port's int64 and
    # per-row: the values agree
    for js, ts in zip(jst["layers"], tst["layers"]):
        if "slot_pos" in js:
            np.testing.assert_array_equal(ts["slot_pos"].numpy(),
                                          np.asarray(js["slot_pos"]))
            assert (ts["cursor"].numpy() == int(js["cursor"])).all()


def test_bulk_prefill_unrolled_with_int8_cache(models):
    """make_bulk_prefill(scan_layers=False) on the int8 cache: JAX's
    jitted bulk prefill's last logits (INT8_REL), and within the port
    bit-identical to make_serve_step token by token; the int8 logits
    meet JAX's own rule against the fp32 cache (0 < max|d| / max|l| <
    0.05, tests/test_models.py)."""
    jmc, tmc, jp, tp = models["qwen1.5-0.5b"]
    toks = _tokens(jmc.vocab, seed=5)
    jst = jt.init_decode_state(jp, jmc, B, P, dtype=jnp.float32,
                               quantize_kv=True)
    jl, _ = jax.jit(jsteps.make_bulk_prefill(jmc))(jp, jst,
                                                   jnp.asarray(toks))
    bulk = steps.make_bulk_prefill(tmc)
    mk = lambda q: tt.init_decode_state(  # noqa: E731
        tp, tmc, B, P, dtype=torch.float32, quantize_kv=q)
    tl, bst = bulk(tp, mk(True), torch.from_numpy(toks).long())
    want = np.asarray(jl)
    assert np.abs(tl.numpy() - want).max() <= INT8_REL * np.abs(want).max()
    st, step = mk(True), steps.make_serve_step(tmc)
    for i in range(P):
        logits, st = step(tp, st,
                          {"tokens": torch.from_numpy(toks[:, i:i + 1])
                           .long()})
    assert torch.equal(logits, tl)
    for a, b in zip(pytree.tree_leaves(st), pytree.tree_leaves(bst)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    full, _ = bulk(tp, mk(False), torch.from_numpy(toks).long())
    rel = float((tl - full).abs().max() / full.abs().max())
    assert 1e-5 < rel < 0.05, rel


def test_unported_encdec_decode_raises(models):
    """The encoder-decoder decode is ported; as JAX's, its state needs the
    encoder memory, and a state made without it raises ValueError
    (tests/test_torch_encdec.py runs it with memory)."""
    _, tmc, _, tp = models["qwen1.5-0.5b"]
    mc = dataclasses.replace(tmc, n_encoder_layers=2)
    with pytest.raises(ValueError, match="needs encoder memory"):
        tt.init_decode_state(tp, mc, 1, 4)
