"""repro_torch's algorithm tier against repro's: the exchanges, the
qdq-only codecs, the gossip matrices, ``prng.normal`` and
``run_quadratic`` / ``run_distributed``.

Each exchange gets the same stacked gradients (numpy from a seed) and
the same state (carried across with ``interop``) as the JAX package's
exchange under ``vmap``. Where nothing in between reduces in floating
point the outputs are held bit for bit; where a mean over workers
(``pmean``) or over elements (``sign1``'s scale) sums, they are held at
rtol = atol = 1e-6: a float32 sum in another order moves the last bit or
two, and nothing else differs. (The ring's own bit-exact chains are in
tests/test_torch_ring.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import communicators as JC
from repro.core import compression as jcomp
from repro.core import mixing as jmix
from repro.core import parallel as JP
from repro_torch import interop
from repro_torch.core import communicators as TC
from repro_torch.core import compression as tcomp
from repro_torch.core import mixing as tmix
from repro_torch.core import parallel as TP
from repro_torch.core import prng, pytree

AXIS = "workers"
TOL = dict(rtol=1e-6, atol=1e-6)


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _stacked(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)  # noqa
    return {"a": f(33), "b": {"w": f(7, 5)}, "c": [f(300)]}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_exchange(ex, g, state, key):
    return jax.vmap(lambda gg, ss: ex(gg, ss, key, axis_name=AXIS),
                    axis_name=AXIS)(_jax(g), state)


def _same(jtree, ttree, *, exact: bool, tol: dict = TOL):
    jl, tl = jax.tree_util.tree_leaves(jtree), pytree.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(np.shape(a)) == tuple(b.shape)
        if exact:
            np.testing.assert_array_equal(_u32(b.numpy()), _u32(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("mbsgd", {}), ("csgd_ps", {"compressor": "rq8"}),
    ("csgd_ps", {"compressor": "rq2"}), ("csgd_ps", {"compressor": "sign1"}),
    ("csgd_ring", {"compressor": "sign1"}),
    ("csgd_ring", {"compressor": "rand_sparse_10"})])
def test_stateless_exchanges_match_jax(name, kw):
    """mbsgd and csgd_ps (a pmean, then for csgd_ps the shared-key
    server qdq), and the ring's qdq chain for qdq-only codecs, against
    JAX at TOL; the input stays untouched."""
    g = _stacked(4, seed=len(name) + len(str(kw)))
    want, _ = _jax_exchange(JC.make_exchange(name, **kw), g, (),
                            jax.random.PRNGKey(3))
    tg = interop.params_from_jax(g)
    keep = pytree.tree_map(torch.clone, tg)
    ex = TC.make_exchange(name, **kw)
    got, state = ex(tg, ex.init(tg), prng.PRNGKey(3))
    assert state == ()
    _same(want, got, exact=False)
    for a, b in zip(pytree.tree_leaves(tg), pytree.tree_leaves(keep)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compressor", ["sign1", "rq4", "topk_1", "clip16"])
def test_ecsgd_matches_jax_with_carried_residuals(compressor):
    """Two ECSGD steps from the same nonzero residuals (carried from JAX
    with interop): updates and both residual buffers at TOL."""
    jex = JC.ECSGDExchange(compressor=compressor)
    tex = TC.ECSGDExchange(compressor=compressor)
    rng = np.random.default_rng(5)
    g0 = _stacked(4, seed=0)
    jstate = {k: jnp.asarray((rng.normal(size=v.shape) * 0.1).astype(
        np.float32)) for k, v in jax.vmap(jex.init)(_jax(g0)).items()}
    tstate = interop.exchange_state_from_jax(jstate)
    assert tstate["worker_err"].shape == \
        tex.init(interop.params_from_jax(g0))["worker_err"].shape
    for t in range(2):
        g = _stacked(4, seed=10 + t)
        want, jstate = _jax_exchange(jex, g, jstate, jax.random.PRNGKey(t))
        got, tstate = tex(interop.params_from_jax(g), tstate,
                          prng.PRNGKey(t))
        _same(want, got, exact=False)
        _same(jstate, tstate, exact=False)


@pytest.mark.parametrize("kw", [
    {"tau": 2}, {"tau": 0}, {"tau": 3, "schedule": [0, 3, 1]},
    {"tau": 2, "schedule": [[0, 1, 2], [2, 1, 0], [1, 1, 1], [0, 0, 2]]}])
def test_delayed_exchange_matches_jax(kw):
    """FIFO and trace-driven (1-D and per-worker 2-D) staleness: five
    steps from JAX's initial state, the same stale updates (TOL: the
    inner pmean) and the same heads."""
    jex = JC.DelayedExchange(inner=JC.MbSGDExchange(), **kw)
    tex = TC.DelayedExchange(inner=TC.MbSGDExchange(), **kw)
    g0 = _stacked(4, seed=0)
    jstate = jax.vmap(jex.init)(_jax(g0))
    tstate = interop.exchange_state_from_jax(jstate)
    assert tstate["head"].dtype == torch.int32 and \
        tstate["head"].device.type == "cpu"
    for t in range(5):
        g = _stacked(4, seed=20 + t)
        want, jstate = _jax_exchange(jex, g, jstate, jax.random.PRNGKey(t))
        got, tstate = tex(interop.params_from_jax(g), tstate,
                          prng.PRNGKey(t))
        _same(want, got, exact=False)
        np.testing.assert_array_equal(tstate["head"].numpy(),
                                      np.asarray(jstate["head"]))
    bad = TC.DelayedExchange(tau=2, schedule=[[0, 1]] * 3)
    st = bad.init(interop.params_from_jax(g0))
    with pytest.raises(ValueError, match="rows"):
        bad(interop.params_from_jax(g0), st, prng.PRNGKey(0))


@pytest.mark.parametrize("kw,n", [
    ({"topology": "ring"}, 4), ({"topology": "ring"}, 2),
    ({"topology": "torus"}, 6), ({"w": jmix.ring(5)}, 5),
    ({"topology": "full"}, 4)])
def test_gossip_mix_matches_jax(kw, n):
    """Ring, torus, an explicit W (gathers scaled by the Birkhoff
    coefficients, elementwise: bit for bit) and full (a pmean: TOL)."""
    p = _stacked(n, seed=n)
    want = jax.vmap(lambda x: JC.GossipMix(**kw)(x, axis_name=AXIS),
                    axis_name=AXIS)(_jax(p))
    mix = TC.GossipMix(**kw)
    got = mix(interop.params_from_jax(p))
    _same(want, got, exact=kw.get("topology") != "full")
    tree = {"a": np.zeros((100,), np.float32)}
    assert mix.message_bytes(interop.params_from_jax(tree), n_workers=n) == \
        JC.GossipMix(**kw).message_bytes(_jax(tree), n_workers=n)


@pytest.mark.parametrize("cls,compressor,exact", [
    ("DCDGossipExchange", "rq4", True), ("DCDGossipExchange", "none", True),
    ("ECDGossipExchange", "sign1", False)])
def test_dcd_ecd_match_jax_with_replicas(cls, compressor, exact):
    """DCD/ECD on the ring of 5: the replica state from init_stacked,
    then three mixes — models, public copies, replicas and residuals
    equal JAX's bit for bit, except ECD's sign1: its scale is a mean over
    the whole buffer, an ulp of which moves every coordinate, and the
    residual feeds that back each mix, so ECD is held at rtol = atol =
    1e-5 (values of order 1, three mixes). The replica invariant holds
    bit for bit in the port."""
    jex = getattr(JC, cls)(compressor=compressor)
    tex = getattr(TC, cls)(compressor=compressor)
    p = _stacked(5, seed=7)
    jstate = jex.init_stacked(_jax(p))
    tstate = tex.init_stacked(interop.params_from_jax(p))
    _same(jstate, tstate, exact=True)
    _, terms = tex.birkhoff_terms(5)
    for t in range(3):
        pp = _stacked(5, seed=30 + t)
        want, jstate = jax.vmap(
            lambda a, s, k: jex(a, s, k, axis_name=AXIS), axis_name=AXIS,
            in_axes=(0, 0, None))(_jax(pp), jstate, jax.random.PRNGKey(t))
        got, tstate = tex(interop.params_from_jax(pp), tstate,
                          prng.PRNGKey(t))
        tol = dict(rtol=1e-5, atol=1e-5)
        _same(want, got, exact=exact, tol=tol)
        _same(jstate, tstate, exact=exact, tol=tol)
        layout = tcomp.FlatLayout.from_tree(
            pytree.tree_map(lambda a: a[0], got))
        flat = torch.stack([layout.flatten(pytree.tree_map(
            lambda a: a[i], got)) for i in range(5)])
        assert torch.equal(flat, tstate["xhat"])
        for k, (_, perm) in enumerate(terms):
            src = [0] * 5
            for s, d in perm:
                src[d] = s
            assert torch.equal(tstate["nbr"][:, k], tstate["xhat"][src])


def test_exchange_registry_and_refusals():
    assert sorted(TC.EXCHANGES) == sorted(JC.EXCHANGES)
    assert isinstance(TC.make_exchange("csgd_ring", compressor="rq4"),
                      TC.CSGDRingExchange)
    ecd = TC.make_exchange("ecd", topology="torus")
    assert ecd.error_compensated and ecd.compressor == "sign1"
    g = interop.params_from_jax(_stacked(2, seed=1))
    for ex in (TC.CSGDPSExchange(flat=False), TC.ECSGDExchange(flat=False),
               TC.CSGDRingExchange(flat=False)):
        out, _ = ex(g, ex.init(g), prng.PRNGKey(0))
        assert [t.shape for t in pytree.tree_leaves(out)] == \
            [t.shape for t in pytree.tree_leaves(g)]
    with pytest.raises(NotImplementedError, match="no packed wire format"):
        tcomp.codec("sign1").encode(torch.zeros(4), prng.PRNGKey(0))


# ---------------------------------------------------------------------------
# codecs, matrices, draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,exact", [
    ("sign1", False), ("topk_1", True), ("clip16", True),
    ("rand_sparse_10", True), ("none", True)])
def test_qdq_only_codecs_match_jax(name, exact):
    """The qdq-only operators against JAX's, called alike on the same x
    and key: topk_1 and clip16 are exact, rand_sparse_10 too through the
    port's bernoulli; sign1's scale is a mean (TOL). Flat and partitioned
    wire bytes and the specs are JAX's."""
    x = (np.random.default_rng(1).normal(size=(40, 51)) * 0.1).astype(
        np.float32)
    want = jcomp.codec(name).qdq(jnp.asarray(x), jax.random.PRNGKey(4))
    got = tcomp.codec(name).qdq(torch.from_numpy(x), prng.PRNGKey(4))
    assert got.shape == x.shape and got.dtype == torch.float32
    _same(want, got, exact=exact)
    tree = {"a": np.zeros((4099,), np.float32),
            "b": np.zeros((3, 7), np.float32)}
    jc, tc = jcomp.codec(name), tcomp.codec(name)
    assert tc.packable is False and tc.spec == tcomp.CompressionSpec(
        *[getattr(jc.spec, f) for f in ("name", "unbiased", "bits_per_el",
                                        "density", "overhead_bytes")])
    assert tc.tree_wire_bytes_flat(interop.params_from_jax(tree)) == \
        jc.tree_wire_bytes_flat(_jax(tree))
    assert tc.tree_wire_bytes_partitioned(interop.params_from_jax(tree),
                                          4) == \
        jc.tree_wire_bytes_partitioned(_jax(tree), 4)


def test_codec_registry_covers_jax_and_randomized_quantize_matches():
    assert sorted(tcomp.CODECS) == sorted(jcomp.CODECS)
    x = (np.random.default_rng(2).normal(size=(33, 17))).astype(np.float32)
    for bits in (8, 4, 2):
        want = jcomp.randomized_quantize(jnp.asarray(x),
                                         jax.random.PRNGKey(bits), bits=bits)
        got = tcomp.randomized_quantize(torch.from_numpy(x),
                                        prng.PRNGKey(bits), bits=bits)
        np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


def test_mixing_matrices_and_birkhoff_terms_equal():
    for n in range(1, 9):
        for build in ("fully_connected", "ring", "disconnected"):
            w = getattr(tmix, build)(n)
            np.testing.assert_array_equal(w, getattr(jmix, build)(n))
            assert tmix.spectral_rho(w) == jmix.spectral_rho(w)
            assert tmix.degree(w) == jmix.degree(w)
        assert tmix.near_square_factors(n) == jmix.near_square_factors(n)
        rows, cols = tmix.near_square_factors(n)
        w = tmix.torus_2d(rows, cols)
        np.testing.assert_array_equal(w, jmix.torus_2d(rows, cols))
        for mat in (w, tmix.ring(n), tmix.fully_connected(n)):
            assert tmix.birkhoff_decomposition(mat) == \
                jmix.birkhoff_decomposition(mat)
    tmix.check_assumption7(tmix.ring(6))
    with pytest.raises(ValueError, match="spectral gap"):
        tmix.check_assumption7(tmix.disconnected(5))
    assert tmix.ring_rho_paper_estimate(8) == jmix.ring_rho_paper_estimate(8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normal_allclose_to_jax(seed):
    """prng.normal draws JAX's uniforms through XLA's float32 erfinv
    polynomial; only log1p is PyTorch's. About 1 % of the draws differ,
    almost all by one or two ulps; a draw whose w = -log1p(-u^2) falls
    within an ulp of the polynomials' split at 5 can take the other
    branch (one such in 32,768 moved 7e-4). Held at atol 1e-6 + rtol
    1e-3, with at most 2 % of the draws differing at all."""
    for shape in ((1024, 32), (1000,), (7,)):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.normal(prng.PRNGKey(seed), shape).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
        assert (got != want).mean() <= 0.02


# ---------------------------------------------------------------------------
# run_quadratic and run_distributed
# ---------------------------------------------------------------------------


def test_quadratic_make_allclose_to_jax():
    for het, n in ((0.0, 8), (0.3, 3)):
        jp = JP.Quadratic.make(jax.random.PRNGKey(1), d=32, n_workers=n,
                               heterogeneity=het)
        tp = TP.Quadratic.make(prng.PRNGKey(1), d=32, n_workers=n,
                               heterogeneity=het, device="cpu")
        np.testing.assert_allclose(tp.a.numpy(), np.asarray(jp.a),
                                   rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(tp.b.numpy(), np.asarray(jp.b),
                                   rtol=1e-3, atol=1e-5)
        assert abs(tp.lipschitz() - jp.lipschitz()) < 1e-6
        back = interop.quadratic_from_jax(jp)
        assert back.worker_slices == n
        assert abs(float(back.minimum()) - float(jp.minimum())) < 1e-6


QUAD_CASES = [("gd", {}), ("sgd", {}), ("mbsgd", {}), ("asgd",
              {"exchange_kw": {"tau": 2}}), ("dsgd", {"heterogeneity": 0.3}),
              ("csgd_ps", {"exchange_kw": {"compressor": "rq4"}}),
              ("csgd_ring", {"exchange_kw": {"compressor": "rq4"}}),
              ("ecsgd", {}), ("dcd", {}), ("ecd", {})]
COMPRESSED = ("csgd_ps", "csgd_ring", "ecsgd", "dcd", "ecd")


@pytest.mark.parametrize("method,kw", QUAD_CASES)
def test_run_quadratic_matches_jax(method, kw, monkeypatch):
    """30 steps of every method on JAX's own (a, b), N = 4: the same
    batches and codec keys. Uncompressed methods: losses at rtol 1e-5
    (float32 products in another order over 30 steps). Compressed
    methods: rtol 1e-3, because one stochastic-rounding decision flipped
    by an ulp of difference moves that coordinate by a whole
    quantization step (a 1/15 of its bucket's range at rq4) and the loss
    by up to ~1e-4 relative. Consensus and wire bytes agree too."""
    het = kw.get("heterogeneity", 0.0)
    want = JP.run_quadratic(method, n_workers=4, steps=30, lr=0.1, seed=2,
                            **kw)
    prob = interop.quadratic_from_jax(JP.Quadratic.make(
        jax.random.PRNGKey(2), d=32, n_workers=4, heterogeneity=het))
    monkeypatch.setattr(TP.Quadratic, "make",
                        staticmethod(lambda *a, **k: prob))
    got = TP.run_quadratic(method, n_workers=4, steps=30, lr=0.1, seed=2,
                           device="cpu", **kw)
    rtol = 1e-3 if method in COMPRESSED else 1e-5
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=rtol)
    np.testing.assert_allclose(got.consensus.numpy(),
                               np.asarray(want.consensus), rtol=1e-2,
                               atol=1e-9)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=rtol, atol=1e-6)
    assert got.comm_bytes_per_step == want.comm_bytes_per_step
    assert got.params.shape == (1 if method in ("gd", "sgd") else 4, 32)


def test_run_quadratic_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.run_quadratic("mbsgd", steps=1)


def test_reduced_lm_ring_run_matches_jax():
    """run_distributed with the rq4 partitioned ring on a reduced
    repro-100m, N = 4, two steps, from JAX's initial parameters and with
    JAX's LM sampler (randint tokens): the loss at the mean iterate
    within 1e-4 of JAX's (float32 model maths in another order), and the
    port's workers bit-identical (consensus exactly 0)."""
    from repro import configs as jconfigs
    from repro.models import transformer as jtransformer
    from repro.train import steps as jsteps
    from repro_torch import configs
    from repro_torch.train import steps

    jcfg = jconfigs.get_config("repro-100m").reduced(n_layers=1, d_model=32,
                                                     vocab=64)
    cfg = configs.get_config("repro-100m").reduced(n_layers=1, d_model=32,
                                                   vocab=64)
    jloss, tloss = jsteps.make_loss_fn(jcfg), steps.make_loss_fn(cfg)
    jparams = jtransformer.init(jcfg, jax.random.PRNGKey(0))
    seq = 8

    def jbatch(key):
        tok = jax.random.randint(key, (2, seq + 1), 0, jcfg.vocab)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def tbatch(key, worker=0):
        tok = prng.randint(key, (2, seq + 1), 0, cfg.vocab)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    jeval, teval = jbatch(jax.random.PRNGKey(1)), tbatch(prng.PRNGKey(1))
    want = JP.run_distributed(
        jloss, lambda p: jloss(p, jeval),
        lambda p: jax.grad(jloss)(p, jeval), jparams, jbatch, n_workers=4,
        steps=2, lr=0.1, exchange=JC.CSGDRingExchange(compressor="rq4"))
    got = TP.run_distributed(
        tloss, lambda p: tloss(p, teval),
        lambda p: steps.value_and_grad(tloss, p, teval)[1],
        interop.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jparams)),
        tbatch, n_workers=4, steps=2, lr=0.1,
        exchange=TC.CSGDRingExchange(compressor="rq4"), device="cpu")
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-4)
    assert got.consensus.tolist() == [0.0, 0.0]
    assert got.comm_bytes_per_step == want.comm_bytes_per_step
