"""repro_torch's per-leaf codec tier against repro's: the per-leaf
``ops.quantize_dequantize`` / ``encode`` / ``decode``, ``Packed`` and the
codecs' tree forms, the function-form registry, CRC framing of a
``Packed``, and the three exchanges at ``flat=False``.

Inputs are numpy from a seed, given to both packages. The codec is held
bit for bit wherever the reference has a fixed order (payload, params,
qdq values, the ring's per-leaf chains); where a mean over workers
(``pmean``) or over elements (``sign1``'s scale) sums, at rtol = atol =
1e-6, as in tests/test_torch_parallel.py. JAX's per-leaf Pallas kernels
run as JAX's own tests run them on the CPU: ``backend="pallas"``
(interpret mode) at small shapes, ``"jnp"`` elsewhere; the two give the
same bits (tests/test_codec.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import communicators as JC
from repro.core import compression as jcomp
from repro.core import parallel as JP
from repro.kernels.quant import ops as jops
from repro_torch import interop
from repro_torch.core import communicators as TC
from repro_torch.core import compression as tcomp
from repro_torch.core import parallel as TP
from repro_torch.core import prng, pytree
from repro_torch.kernels.quant import ops, ref

AXIS = "workers"
TOL = dict(rtol=1e-6, atol=1e-6)


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same_bits(want, got) -> None:
    """Equal bits where not NaN, NaN at the same places."""
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert w.shape == g.shape
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan)
    np.testing.assert_array_equal(_u32(g[~nan]), _u32(w[~nan]))


def _leaf(shape, seed, special=False) -> np.ndarray:
    x = (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(
        np.float32)
    if special:
        flat = x.reshape(-1)
        flat[3], flat[-2] = np.inf, -np.inf
    return x


# ---------------------------------------------------------------------------
# ops: one leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape,backend", [
    ((1000,), "pallas"), ((4, 5, 409), "jnp")])
def test_leaf_ops_equal_jax(bits, shape, backend):
    """qdq values, payload, params and decode equal JAX's bit for bit at
    odd sizes (zero-padded to the granule, not edge-padded; JAX's Pallas
    kernels in interpret mode on the first), in 1-d and 3-d;
    decode(encode) == qdq; the plain per-leaf ``ref`` forms give the
    same."""
    x = _leaf(shape, seed=bits + len(shape))
    jk, tk = jax.random.PRNGKey(bits), prng.PRNGKey(bits)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jops.quantize_dequantize(jx, jk, bits=bits, backend=backend)
    jpay, jpar = jops.encode(jx, jk, bits=bits, backend=backend)
    jdec = jops.decode(jpay, jpar, shape=shape, bits=bits, backend=backend)
    got = ops.quantize_dequantize(tx, tk, bits=bits)
    pay, par = ops.encode(tx, tk, bits=bits)
    dec = ops.decode(pay, par, shape=shape, bits=bits)
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(_u32(par.numpy()), _u32(jpar))
    _same_bits(want, got.numpy())
    _same_bits(jdec, dec.numpy())
    _same_bits(got.numpy(), dec.numpy())
    assert pay.shape == (ops.leaf_payload_rows(x.size, bits=bits), ops.LANES)
    # the literal per-leaf plain versions, on the same zero-padded view
    pack = 8 // bits
    x3 = torch.zeros(pack * pay.shape[0] * ops.LANES)
    x3[:x.size] = tx.reshape(-1)
    x3 = x3.view(pack, -1, ops.LANES)
    u3 = prng.uniform(tk, tuple(x3.shape))
    lo, scale = ref.quant_params(tx, bits)
    assert torch.equal(ref.encode_packed(x3, u3, lo, scale, bits=bits), pay)
    _same_bits(dec.numpy(), ref.decode_packed(pay, lo, scale, bits=bits)
               .reshape(-1)[:x.size].reshape(shape).numpy())
    u = u3.reshape(-1)[:x.size].reshape(shape)
    _same_bits(got.numpy(),
               ref.quantize_dequantize(tx, u, bits=bits).numpy())


@pytest.mark.parametrize("bits", [8, 2])
def test_leaf_with_inf_and_nan_keeps_jax_behaviour(bits):
    """(lo, scale) come from the unpadded leaf through one aminmax: an
    Inf makes the scale Inf, a NaN makes lo NaN (and scale 1, as
    ``where(hi > lo)`` is false), exactly as JAX's reduction gives; the
    values, payload and params then equal JAX's (NaN at JAX's places)."""
    for x in (_leaf((1000,), 5, special=True),
              np.where(np.arange(700) == 9, np.nan,
                       _leaf((700,), 6)).astype(np.float32)):
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        jk, tk = jax.random.PRNGKey(7), prng.PRNGKey(7)
        want = jops.quantize_dequantize(jx, jk, bits=bits, backend="jnp")
        jpay, jpar = jops.encode(jx, jk, bits=bits, backend="jnp")
        pay, par = ops.encode(tx, tk, bits=bits)
        _same_bits(want, ops.quantize_dequantize(tx, tk, bits=bits).numpy())
        np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
        _same_bits(jpar, par.numpy())
        _same_bits(jops.decode(jpay, jpar, shape=x.shape, bits=bits,
                               backend="jnp"),
                   ops.decode(pay, par, shape=x.shape, bits=bits).numpy())


def test_rows_launch_form_equals_single_leaves():
    """The stacked form (one launch over N leaf messages) gives each
    row what the single-leaf call gives it; a repeated key draws once
    and gives the same values; a bf16 leaf comes back bf16, as JAX's."""
    x = _leaf((3, 40, 30), seed=9)
    keys = [prng.PRNGKey(1), prng.PRNGKey(2), prng.PRNGKey(1)]
    tx = torch.from_numpy(x)
    q = ops.quantize_dequantize_rows(tx, keys, bits=4)
    pay, par = ops.encode_rows(tx, keys, bits=4)
    dec = ops.decode_rows(pay, par, shape=(40, 30), bits=4)
    for i, k in enumerate(keys):
        assert torch.equal(q[i], ops.quantize_dequantize(tx[i], k, bits=4))
        p1, q1 = ops.encode(tx[i], k, bits=4)
        assert torch.equal(pay[i], p1) and torch.equal(par[i:i + 1], q1)
        assert torch.equal(dec[i], q[i])
    xb = jnp.asarray(x[0], jnp.bfloat16)
    want = jops.quantize_dequantize(xb, jax.random.PRNGKey(3), bits=8,
                                    backend="jnp")
    got = ops.quantize_dequantize(interop.params_from_jax(np.asarray(xb)),
                                  prng.PRNGKey(3), bits=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


# ---------------------------------------------------------------------------
# compression: Packed, tree forms, registry, framing
# ---------------------------------------------------------------------------


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa
    return {"w": f(33, 31), "b": f(7), "z": [f(4099), f(2, 3)]}


@pytest.mark.parametrize("name", ["rq4"])
def test_tree_encode_keys_payloads_and_wire_bytes_equal_jax(name):
    """tree_encode splits the key over the leaves in JAX's sorted order:
    every Packed's payload, params, shape and codec equal JAX's;
    tree_decode and tree_qdq give JAX's values; Packed.wire_bytes,
    wire_bytes and tree_wire_bytes are JAX's."""
    jc, tc = jcomp.codec(name), tcomp.codec(name)
    tree = _tree(1)
    jt, tt = jax.tree_util.tree_map(jnp.asarray, tree), \
        interop.params_from_jax(tree)
    jenc = jc.tree_encode(jt, jax.random.PRNGKey(5))
    tenc = tc.tree_encode(tt, prng.PRNGKey(5))
    jl = jax.tree_util.tree_leaves(
        jenc, is_leaf=lambda n: isinstance(n, jcomp.Packed))
    tl = pytree.tree_leaves(tenc)
    assert len(jl) == len(tl) == 4
    for a, b in zip(jl, tl):
        assert isinstance(b, tcomp.Packed)
        np.testing.assert_array_equal(b.payload.numpy(),
                                      np.asarray(a.payload))
        np.testing.assert_array_equal(_u32(b.params.numpy()),
                                      _u32(a.params))
        assert (b.shape, b.codec, b.dtype) == (a.shape, a.codec,
                                               torch.float32)
        assert b.wire_bytes == a.wire_bytes
    for want, got in ((jc.tree_decode(jenc), tc.tree_decode(tenc)),
                      (jc.tree_qdq(jt, jax.random.PRNGKey(5)),
                       tc.tree_qdq(tt, prng.PRNGKey(5)))):
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        pytree.tree_leaves(got)):
            _same_bits(a, b.numpy())
    assert tc.tree_wire_bytes(tt) == jc.tree_wire_bytes(jt)
    assert tc.wire_bytes(tt["w"]) == jc.wire_bytes(jt["w"])


def test_function_registry_tree_compress_and_tree_bytes_equal_jax():
    """REGISTRY / get / tree_compress / tree_bytes / CompressionSpec.ratio
    as JAX's: the same names and specs, an unknown name a KeyError
    listing them, tree_compress with a registry operator giving JAX's
    values, and the same bytes for every codec and a non-packable codec's
    encode refused as JAX refuses it."""
    assert sorted(tcomp.REGISTRY) == sorted(jcomp.REGISTRY)
    tree = _tree(2)
    jt, tt = jax.tree_util.tree_map(jnp.asarray, tree), \
        interop.params_from_jax(tree)
    for name in jcomp.REGISTRY:
        jfn, jspec = jcomp.get(name)
        tfn, tspec = tcomp.get(name)
        assert tspec == tcomp.CompressionSpec(
            *[getattr(jspec, f) for f in ("name", "unbiased", "bits_per_el",
                                          "density", "overhead_bytes")])
        assert tcomp.tree_bytes(tt, tspec) == jcomp.tree_bytes(jt, jspec)
        assert tspec.ratio(1000) == jspec.ratio(1000)
        assert tcomp.codec(name).tree_wire_bytes(tt) == \
            jcomp.codec(name).tree_wire_bytes(jt)
    for name in ("rq4", "rand_sparse_10", "clip16"):
        want = jcomp.tree_compress(jt, jax.random.PRNGKey(1),
                                   jcomp.get(name)[0])
        got = tcomp.tree_compress(tt, prng.PRNGKey(1), tcomp.get(name)[0])
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        pytree.tree_leaves(got)):
            _same_bits(a, b.numpy())
    with pytest.raises(KeyError, match="unknown compression"):
        tcomp.get("rq16")
    with pytest.raises(NotImplementedError, match="no packed wire format"):
        tcomp.codec("sign1").encode(tt["b"], prng.PRNGKey(0))


def test_crc_framing_and_checked_decode_on_a_packed():
    """A Packed frames with JAX's CRC (the same bytes), a JAX Packed
    carried across with interop decodes to JAX's values, checked_decode
    returns the decode, and a flipped bit (payload or params) or a
    wrong CRC is refused."""
    x = _leaf((3, 1500), seed=11)
    jp = jcomp.codec("rq4").encode(jnp.asarray(x), jax.random.PRNGKey(2))
    cdc = tcomp.codec("rq4")
    tp = cdc.encode(torch.from_numpy(x), prng.PRNGKey(2))
    carried = interop.packed_from_jax(jp)
    assert torch.equal(carried.payload, tp.payload)
    assert (carried.shape, carried.dtype, carried.codec) == \
        (tp.shape, tp.dtype, tp.codec)
    crc = tcomp.wire_crc32(tp)
    assert crc == jcomp.wire_crc32(jp)
    assert tcomp.wire_bits(tp) == jcomp.wire_bits(jp)
    packed, framed = tcomp.frame(carried)
    out = tcomp.checked_decode(cdc, packed, framed)
    _same_bits(jcomp.codec("rq4").decode(jp), out.numpy())
    for bit in (5, tp.payload.numel() * 8 + 3):
        with pytest.raises(tcomp.WireCorruptionError, match="CRC32"):
            tcomp.checked_decode(cdc, tcomp.flip_bit(tp, bit), crc)
    with pytest.raises(tcomp.WireCorruptionError):
        tcomp.verify_wire(tp, crc ^ 1)


# ---------------------------------------------------------------------------
# exchanges at flat=False
# ---------------------------------------------------------------------------


def _stacked(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)  # noqa
    return {"a": f(33), "b": {"w": f(7, 5)}, "c": [f(3000)]}


def _jax_exchange(ex, g, state, key):
    return jax.vmap(lambda gg, ss: ex(gg, ss, key, axis_name=AXIS),
                    axis_name=AXIS)(jax.tree_util.tree_map(jnp.asarray, g),
                                    state)


def _same(jtree, ttree, *, exact: bool):
    jl, tl = jax.tree_util.tree_leaves(jtree), pytree.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(np.shape(a)) == tuple(b.shape)
        if exact:
            np.testing.assert_array_equal(_u32(b.numpy()), _u32(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("name,compressor,n,exact", [
    ("csgd_ring", "rq4", 4, True), ("csgd_ring", "rq8", 3, True),
    ("csgd_ring", "sign1", 3, False), ("csgd_ps", "rq4", 3, False)])
def test_per_leaf_exchanges_equal_jax(name, compressor, n, exact):
    """The ring's per-leaf Packed chain (tree_encode -> (ppermute,
    tree_decode + grad, tree_encode under fold_in(wkey, h)) x (n-1) ->
    tree_decode, then / n) and its qdq chain for a qdq-only codec, and
    the PS form (tree_qdq, pmean, shared-key tree_qdq), against JAX's
    vmapped exchange at flat=False; message_bytes equal JAX's; the input
    stays untouched."""
    g = _stacked(n, seed=n + len(compressor))
    jex = JC.make_exchange(name, compressor=compressor, flat=False)
    want, _ = _jax_exchange(jex, g, (), jax.random.PRNGKey(3))
    tg = interop.params_from_jax(g)
    keep = pytree.tree_map(torch.clone, tg)
    tex = TC.make_exchange(name, compressor=compressor, flat=False)
    got, state = tex(tg, tex.init(tg), prng.PRNGKey(3))
    assert state == ()
    _same(want, got, exact=exact)
    for a, b in zip(pytree.tree_leaves(tg), pytree.tree_leaves(keep)):
        assert torch.equal(a, b)
    row = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), g)
    assert tex.message_bytes(pytree.tree_map(lambda a: a[0], tg),
                             n_workers=n) == \
        jex.message_bytes(row, n_workers=n)


@pytest.mark.parametrize("compressor", ["rq4", "sign1"])
def test_per_leaf_ecsgd_equals_jax_with_carried_error_trees(compressor):
    """Two ECSGD steps at flat=False from the same nonzero per-leaf
    error trees (carried from JAX with interop): updates and both error
    trees at TOL (the server side reduces through pmean)."""
    jex = JC.ECSGDExchange(compressor=compressor, flat=False)
    tex = TC.ECSGDExchange(compressor=compressor, flat=False)
    rng = np.random.default_rng(5)
    g0 = _stacked(4, seed=0)
    jstate = jax.tree_util.tree_map(
        lambda v: jnp.asarray((rng.normal(size=v.shape) * 0.1).astype(
            np.float32)),
        jax.vmap(jex.init)(jax.tree_util.tree_map(jnp.asarray, g0)))
    tstate = interop.exchange_state_from_jax(jstate)
    init = tex.init(interop.params_from_jax(g0))
    assert [t.shape for t in pytree.tree_leaves(init)] == \
        [t.shape for t in pytree.tree_leaves(tstate)]
    for t in range(2):
        g = _stacked(4, seed=10 + t)
        want, jstate = _jax_exchange(jex, g, jstate, jax.random.PRNGKey(t))
        got, tstate = tex(interop.params_from_jax(g), tstate,
                          prng.PRNGKey(t))
        _same(want, got, exact=False)
        _same(jstate, tstate, exact=False)
    assert tex.message_bytes(interop.params_from_jax(_tree())) == \
        jex.message_bytes(jax.tree_util.tree_map(jnp.asarray, _tree()))


@pytest.mark.parametrize("method", ["csgd_ring"])
def test_per_leaf_run_quadratic_matches_jax(method, monkeypatch):
    """30 steps of the per-leaf ring on JAX's own quadratic (rq4, N =
    4; ECSGD's per-leaf steps are held above from carried error trees):
    losses and parameters at rtol 1e-3 (a stochastic-rounding
    decision flipped by an ulp moves a coordinate by a whole step, as in
    tests/test_torch_parallel.py), equal wire bytes."""
    kw = {"exchange_kw": {"compressor": "rq4", "flat": False}}
    want = JP.run_quadratic(method, n_workers=4, steps=30, lr=0.1, seed=2,
                            **kw)
    prob = interop.quadratic_from_jax(JP.Quadratic.make(
        jax.random.PRNGKey(2), d=32, n_workers=4))
    monkeypatch.setattr(TP.Quadratic, "make",
                        staticmethod(lambda *a, **k: prob))
    got = TP.run_quadratic(method, n_workers=4, steps=30, lr=0.1, seed=2,
                           device="cpu", **kw)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-3)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=1e-3, atol=1e-6)
    assert got.comm_bytes_per_step == want.comm_bytes_per_step


@pytest.fixture(scope="module")
def lm_grads():
    """Four workers' gradient-shaped trees of the reduced repro-100m
    unrolled tree (JAX's init, scaled noise), as numpy."""
    from repro import configs as jconfigs
    from repro.models import transformer as jtransformer

    cfg = jconfigs.get_config("repro-100m").reduced(n_layers=1, d_model=32,
                                                    vocab=64)
    params = jtransformer.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=(4,) + p.shape) * 0.01).astype(
            np.float32), params)


@pytest.mark.parametrize("name,compressor,exact", [
    ("csgd_ring", "rq4", True)])
def test_per_leaf_exchanges_on_a_reduced_lm_tree(lm_grads, name, compressor,
                                                 exact):
    """The per-leaf ring on the reduced LM's gradient tree (its leaves
    in JAX's sorted order, odd sizes among them), N = 4, bit for bit;
    message_bytes are JAX's tree_wire_bytes geometry."""
    jex = JC.make_exchange(name, compressor=compressor, flat=False)
    tex = TC.make_exchange(name, compressor=compressor, flat=False)
    want, _ = _jax_exchange(jex, lm_grads, (), jax.random.PRNGKey(9))
    tg = interop.params_from_jax(lm_grads)
    got, _ = tex(tg, (), prng.PRNGKey(9))
    _same(want, got, exact=exact)
    row = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), lm_grads)
    trow = pytree.tree_map(lambda a: a[0], tg)
    assert tex.message_bytes(trow, n_workers=4) == \
        jex.message_bytes(row, n_workers=4)
    hops = 3 if name == "csgd_ring" else 2
    assert tex.message_bytes(trow, n_workers=4) == \
        hops * jcomp.codec(compressor).tree_wire_bytes(row)
