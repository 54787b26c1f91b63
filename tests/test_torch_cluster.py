"""repro_torch's virtual-cluster tier against repro's: the event
simulator, the theory table, the codec's per-message wire sizing, the
scheduler's traces (every protocol, with and without each fault
factory), the robust aggregators, the replays on the quadratic and the
reduced LM, the timeline renderer, ``checked_decode`` and the flight
recorder.

The scheduler, the faults, ``eventsim`` and ``theory`` are numpy / stdlib
in both packages, so their results are held EXACTLY (traces field for
field, floats with ``==``). The aggregators and the replays reduce in
floating point (a mean over workers, a matmul, XLA's fused reductions):
the aggregators at rtol = atol = 1e-6 (the median, which only selects
and halves, bit for bit), replay losses at rtol = 1e-5. Each replay
starts from JAX's problem carried across (``interop``): the quadratic's
(a, b), the LM's parameters.
"""
import dataclasses
import json
import zlib

import jax
import numpy as np
import pytest
import torch

from repro import cluster as JCL
from repro.cluster import aggregators as JA
from repro.cluster import faults as JF
from repro.core import compression as jcomp
from repro.core import eventsim as JE
from repro.core import mixing as jmix
from repro.core import parallel as JP
from repro.core import theory as JT
from repro.obs import export as jexport
from repro.obs import trace as jtrace
from repro_torch import cluster as TCL
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch.cluster import aggregators as TA
from repro_torch.cluster import execute as TEX
from repro_torch.cluster import faults as TF
from repro_torch.core import compression as tcomp
from repro_torch.core import eventsim as TE
from repro_torch.core import mixing as tmix
from repro_torch.core import parallel as TPAR
from repro_torch.core import prng
from repro_torch.core import theory as TT
from repro_torch.obs import export as texport
from repro_torch.obs import flight as tflight
from repro_torch.obs import trace as ttrace

N = 4
PROTOCOLS = ("sync_ps", "async_ps", "local_sgd", "dsgd", "dcd", "ecd", "laq")
RTOL = 1e-5
AGG_TOL = dict(rtol=1e-6, atol=1e-6)


def plain(o):
    """A dataclass tree as nested tuples of builtins (numpy arrays by
    dtype, shape and bytes), so two packages' objects compare with ==."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return (type(o).__name__,) + tuple(
            (f.name, plain(getattr(o, f.name)))
            for f in dataclasses.fields(o))
    if isinstance(o, np.ndarray):
        return ("ndarray", o.dtype.str, o.shape, o.tobytes())
    if isinstance(o, (list, tuple)):
        return (type(o).__name__,) + tuple(plain(x) for x in o)
    if isinstance(o, dict):
        return ("dict",) + tuple(sorted((k, plain(v)) for k, v in o.items()))
    return o


def _spec(mod, **kw):
    base = dict(n_workers=N, t_compute=1.0,
                multipliers=mod.straggler_multipliers(N, factor=4.0),
                t_lat=1e-2, t_tr=2e-3, size_mb=1.0, codec="rq4")
    base.update(kw)
    return mod.ClusterSpec(**base)


def _plan(mod, fault):
    """The same FaultPlan from either package's factory."""
    return {
        None: lambda: None,
        "lossy_network": lambda: mod.lossy_network(
            N, p_drop=0.2, p_dup=0.1, delay_scale=0.05, seed=1),
        "crash_restart": lambda: mod.crash_restart(
            N, worker=2, t_down=1.5, t_up=5.0, p_drop=0.1, seed=1),
        "churn": lambda: mod.churn(N, departures=((3, 2.0),),
                                   joins=((2, 1.5),), seed=2),
        "corrupt_wire": lambda: mod.corrupt_wire(
            N, p_corrupt=0.2, p_poison=0.1, seed=3),
        "byzantine_workers": lambda: mod.byzantine_workers(
            N, f=1, mode="sign_flip"),
    }[fault]()


def _schedule(mod, name, fault=None, *, rounds=3, **proto_kw):
    spec = _spec(mod)
    plan = _plan(mod, fault)
    kw = dict(proto_kw)
    if name in ("sync_ps", "laq") and fault is not None and \
            fault != "byzantine_workers":
        kw.setdefault("quorum", N - 1)
    proto = mod.make_protocol(name, **kw)
    if name == "async_ps":
        return proto.schedule(spec, horizon=3 * 4.2, plan=plan)
    return proto.schedule(spec, rounds=rounds, plan=plan)


def _outcome(fn):
    """('ok', plain(result)) or ('raised', exception type name)."""
    try:
        return ("ok", plain(fn()))
    except (ValueError, KeyError, NotImplementedError) as e:
        return ("raised", type(e).__name__)


# ---------------------------------------------------------------------------
# Wire sizing, eventsim and theory: exact
# ---------------------------------------------------------------------------

WIRE_SIZES = [1, 2, 511, 512, 513, 1023, 1024, 1025, 2047, 2048, 2049, 4095,
              4096, 4097, 8191, 8192, 8193, 65_536, 1 << 20, (1 << 22) - 1,
              1 << 22, (1 << 22) + 1, 3_164_928, 99_999_989, 100_000_000,
              128_994_048, 463_987_712]


@pytest.mark.parametrize("name", sorted(tcomp.CODECS))
def test_wire_bytes_for_equals_jax(name):
    """The per-leaf packed format's size, computed from its geometry,
    equals JAX's ``jax.eval_shape`` of the encode at every granule edge
    and at the full-width message sizes (the static spec for the qdq-only
    codecs)."""
    jc, tc = jcomp.codec(name), tcomp.codec(name)
    for n in WIRE_SIZES:
        want, got = jc.wire_bytes_for(n), tc.wire_bytes_for(n)
        assert got == want and type(got) is type(want), (name, n, got, want)
        assert TE.wire_size_mb(name, n) == JE.wire_size_mb(name, n)


def _eventsim_calls(mod):
    kw = dict(t_lat=1.5, t_tr=5.0)
    ring = (jmix if mod is JE else tmix).ring(6)
    calls = []
    for n in (2, 3, 8):
        calls += [
            lambda n=n: mod.single_ps_makespan(n, 1.0, **kw),
            lambda n=n: mod.single_ps_makespan(n, 2.0, compression=4.0,
                                               n_messages=3, **kw),
            lambda n=n: mod.ring_allreduce_makespan(n, 1.0, **kw),
            lambda n=n: mod.ring_allreduce_makespan(n, 1.0,
                                                    partitioned=False, **kw),
            lambda n=n: mod.csgd_ring_makespan(n, 3.0, codec="rq4", **kw),
            lambda n=n: mod.csgd_ring_makespan(n, 3.0, partitioned=False,
                                               **kw),
            lambda n=n: mod.ring_wire_mb_per_worker(n, 3.0, codec="rq2"),
            lambda n=n: mod.multi_ps_makespan(n, 1.0, **kw),
            lambda n=n: mod.decentralized_makespan(n, 1.0, **kw),
            lambda n=n: mod.decentralized_makespan(n, 1.0, codec="rq8",
                                                   **kw),
            lambda n=n: mod.ring_allreduce_msgs(n, 1.0),
            lambda n=n: mod.async_ps_timeline(
                n, t_compute=[1.0] * (n - 1) + [4.0], t_lat=0.1, t_tr=0.2,
                size=1.0, horizon=20.0),
            lambda n=n: mod.sync_ps_throughput(n, t_compute_max=4.0,
                                               t_lat=0.1, t_tr=0.2,
                                               size=1.0),
        ]
    calls += [
        lambda: mod.decentralized_makespan(6, 1.0, w=ring, **kw),
        lambda: mod.gossip_wire_mb_per_worker(2.0, w=ring, codec="rq4"),
        lambda: mod.gossip_wire_mb_per_worker(2.0, degree=4),
        lambda: mod.split_msg_records(0.5, 1, 2, 3.0, "g", 3, **kw),
        lambda: mod.simulate([mod.Msg(0.0, 0, 1, 1.0, "a"),
                              mod.Msg(0.0, 0, 2, 2.0, "b"),
                              mod.Msg(0.5, 2, 1, 1.0, "c", 2)], **kw),
        lambda: mod.simulate(mod.ring_allreduce_msgs(4, 1.0), **kw),
    ]
    return calls


def test_eventsim_equals_jax():
    """Every pattern builder, makespan, timeline and ``simulate`` result
    (SimResult, Delivery, MsgRecord) equals JAX's float for float."""
    for got_fn, want_fn in zip(_eventsim_calls(TE), _eventsim_calls(JE)):
        assert _outcome(got_fn) == _outcome(want_fn)


def test_theory_equals_jax():
    for kw in ({}, dict(L=4.0, sigma=0.25, sigma_c=2.0, varsigma=0.0,
                        f_gap=3.0, M=512, d=4096)):
        jw, tw = JT.Workload(**kw), TT.Workload(**kw)
        for eps in (1e-1, 1e-3):
            for name in ("gd_iterations", "gd_queries", "sgd_iterations",
                         "lr_gd"):
                args = (eps,) if name != "lr_gd" else ()
                assert getattr(TT, name)(tw, *args) == \
                    getattr(JT, name)(jw, *args)
            for n in (2, 16):
                for name, extra in (("mbsgd_iterations", (n,)),
                                    ("mbsgd_queries", (n,)),
                                    ("dist_sgd_iterations", (n,)),
                                    ("csgd_iterations", (n,)),
                                    ("ecsgd_iterations", (n,)),
                                    ("asgd_iterations", (n,)),
                                    ("asgd_iterations", (n, 3.0)),
                                    ("dsgd_iterations", (n, 0.7))):
                    assert getattr(TT, name)(tw, eps, *extra) == \
                        getattr(JT, name)(jw, eps, *extra)
        for t in (10, 1000):
            for name, extra in (("lr_sgd", ()), ("lr_csgd", ()),
                                ("lr_ecsgd", (8,)), ("lr_asgd", (4.0,)),
                                ("lr_dsgd", (8, 0.5))):
                assert getattr(TT, name)(tw, t, *extra) == \
                    getattr(JT, name)(jw, t, *extra)
    for n in (2, 8, 64):
        for a, b in ((0.1, 2.0), (1.0, 0.5)):
            assert TT.comm_cost_ps(n, a, b) == JT.comm_cost_ps(n, a, b)
            assert TT.comm_cost_allreduce(n, a, b) == \
                JT.comm_cost_allreduce(n, a, b)
            assert TT.comm_cost_compressed(n, a, b, 4.0) == \
                JT.comm_cost_compressed(n, a, b, 4.0)
            assert TT.comm_cost_decentralized(4, a, b) == \
                JT.comm_cost_decentralized(4, a, b)


# ---------------------------------------------------------------------------
# Scheduler traces, faults and validate: exact
# ---------------------------------------------------------------------------

FAULTS = (None, "lossy_network", "crash_restart", "churn", "corrupt_wire",
          "byzantine_workers")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", PROTOCOLS)
def test_trace_equals_jax(name, fault):
    """Every field of the Trace (events, wire ledger, per-message
    records, extras, fault ledger) equals JAX's, and so does
    ``faults.validate``'s tally (or both refuse the combination)."""
    got = _outcome(lambda: _schedule(TCL, name, fault))
    want = _outcome(lambda: _schedule(JCL, name, fault))
    assert got == want
    if got[0] == "ok":
        tr_t, tr_j = _schedule(TCL, name, fault), _schedule(JCL, name, fault)
        assert _outcome(lambda: TF.validate(tr_t)) == \
            _outcome(lambda: JF.validate(tr_j))


def test_plans_helpers_and_registry_equal_jax():
    assert sorted(TCL.PROTOCOLS) == sorted(JCL.PROTOCOLS)
    assert sorted(TA.AGGREGATORS) == sorted(JA.AGGREGATORS)
    assert TCL.__all__ == JCL.__all__
    from repro import obs as jobs
    assert tobs.__all__ == jobs.__all__
    for fault in FAULTS[1:]:
        assert plain(_plan(TCL, fault)) == plain(_plan(JCL, fault))
    for tau in (None, 1, 3):
        np.testing.assert_array_equal(
            TCL.staleness_schedule(_schedule(TCL, "async_ps"), tau=tau),
            JCL.staleness_schedule(_schedule(JCL, "async_ps"), tau=tau))
    w = tmix.ring(6)
    for alive in ((0, 1, 2, 3, 4, 5), (0, 2, 3), (1,), ()):
        np.testing.assert_array_equal(TF.live_mixing_matrix(w, alive),
                                      JF.live_mixing_matrix(w, alive))
        assert plain(TF.epoch_matrix(w, alive)) == \
            plain(JF.epoch_matrix(w, alive))
    spec_t, spec_j = _spec(TCL, jitter=0.4, seed=7), _spec(JCL, jitter=0.4,
                                                           seed=7)
    for wk in range(N):
        for step in range(4):
            assert spec_t.compute_time(wk, step) == \
                spec_j.compute_time(wk, step)
    assert spec_t.msg_mb() == spec_j.msg_mb()
    assert spec_t.partition_msg_mb() == spec_j.partition_msg_mb()


def test_validate_catches_a_forged_ledger_like_jax():
    tr_t = _schedule(TCL, "sync_ps", "corrupt_wire")
    assert tr_t.faults.n_corrupted > 0
    forged = dataclasses.replace(
        tr_t, faults=dataclasses.replace(tr_t.faults, corrupt=()))
    with pytest.raises(AssertionError):
        TF.validate(forged)


# ---------------------------------------------------------------------------
# Aggregators
# ---------------------------------------------------------------------------

MASKS = {
    "all": [1, 1, 1, 1, 1, 1, 1, 1],
    "empty": [0, 0, 0, 0, 0, 0, 0, 0],
    "quorum": [1, 0, 1, 1, 1, 0, 1, 1],
    "two": [0, 1, 0, 0, 1, 0, 0, 0],          # count <= 2f (f = 2)
    "three": [1, 0, 0, 1, 0, 0, 1, 0],
}


def _stack(seed):
    rng = np.random.default_rng(seed)
    tree = {"b": rng.normal(size=(8, 5)).astype(np.float32),
            "w": (rng.normal(size=(8, 3, 7)) * 4).astype(np.float32)}
    tree["w"][2] *= 50.0                      # one large-norm row
    return tree


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("name", sorted(JA.AGGREGATORS))
def test_aggregator_equals_jax(name, mask):
    tree = _stack(zlib.crc32(f"{name}/{mask}".encode()))
    m = np.asarray(MASKS[mask], np.float32)
    want = jax.jit(JA.aggregator(name))(
        {k: jax.numpy.asarray(v) for k, v in tree.items()},
        jax.numpy.asarray(m))
    got = TA.aggregator(name)(interop.params_from_jax(tree),
                              torch.from_numpy(m))
    for k in tree:
        if name == "coordinate_median":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **AGG_TOL)
        if mask == "empty":
            assert not got[k].any()


def test_masked_rows_sort_past_the_real_ones_like_jax():
    """A masked row holding NaN or a huge value never enters the
    statistic, and a NaN in a counted row sorts last in both packages."""
    q = np.array([[1.0, np.nan], [np.nan, 2.0], [3.0, -1.0], [1e38, 5.0]],
                 np.float32)
    m = np.array([1, 0, 1, 1], np.float32)
    for name in ("trimmed_mean", "coordinate_median"):
        want = np.asarray(JA.aggregator(name)(jax.numpy.asarray(q),
                                              jax.numpy.asarray(m)))
        got = TA.aggregator(name)(torch.from_numpy(q),
                                  torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got[~np.isnan(got)],
                                   want[~np.isnan(want)], **AGG_TOL)


# ---------------------------------------------------------------------------
# Replays
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quad():
    """JAX's quadratic workload and the port's on the same (a, b)."""
    jw = JCL.quadratic_workload(n_workers=N, seed=0)
    prob = interop.quadratic_from_jax(JP.Quadratic.make(
        jax.random.PRNGKey(0), m=1024, d=32, noise=0.1, n_workers=N))
    return jw, TEX.problem_workload(prob, batch=4)


def test_quadratic_workload_is_the_problem_workload_of_its_problem():
    tw = TCL.quadratic_workload(n_workers=N, seed=0, device="cpu")
    prob = TPAR.Quadratic.make(prng.PRNGKey(0), d=32, n_workers=N,
                               device="cpu")
    pw = TEX.problem_workload(prob)
    x = torch.linspace(-1.0, 1.0, 32)
    assert torch.equal(tw.eval_loss(x), pw.eval_loss(x))
    assert torch.equal(tw.grad_fn(x, prng.PRNGKey(5)),
                       pw.grad_fn(x, prng.PRNGKey(5)))


def _replays_agree(name, fault, jw, tw, **kw):
    jt, tt = _schedule(JCL, name, fault, **kw), _schedule(TCL, name, fault,
                                                          **kw)
    assert plain(tt) == plain(jt)
    want = JCL.replay(jt, jw, lr=0.1)
    got = TCL.replay(tt, tw, lr=0.1)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)
    np.testing.assert_array_equal(got.t_wall, want.t_wall)
    assert (got.updates_applied, got.max_staleness, got.makespan,
            got.n_wire_messages) == (want.updates_applied,
                                     want.max_staleness, want.makespan,
                                     want.n_wire_messages)
    assert np.isfinite(got.losses).all()
    return got


@pytest.mark.parametrize("name", PROTOCOLS)
def test_replay_quadratic_equals_jax(name, quad):
    kw = {"period_h": 2} if name == "local_sgd" else {}
    got = _replays_agree(name, None, *quad, **kw)
    assert got.final_loss < float(quad[1].eval_loss(quad[1].params0))


@pytest.mark.parametrize("name, fault, kw", [
    ("sync_ps", "lossy_network", {}),            # quorum rounds
    ("sync_ps", "crash_restart", {}),
    ("local_sgd", "crash_restart", {"period_h": 2}),   # the rejoin pull
    ("dsgd", "lossy_network", {}),               # dropped gossip edges
    ("dsgd", "churn", {}),                       # epochs + a rejoin
    ("dcd", "crash_restart", {}),
    ("ecd", "churn", {}),
    ("laq", "lossy_network", {}),
    ("async_ps", "crash_restart", {}),
])
def test_fault_replay_quadratic_equals_jax(name, fault, kw, quad):
    _replays_agree(name, fault, *quad, **kw)


@pytest.mark.parametrize("agg, mode", [("trimmed_mean", "sign_flip"),
                                       ("coordinate_median", "scale"),
                                       ("norm_clip", "random"),
                                       ("mean", "random")])
def test_byzantine_replay_quadratic_equals_jax(agg, mode, quad):
    """f = 1 Byzantine row under each rule; ``random`` rows draw keyed
    normals (``prng.normal``: JAX's bits through XLA's erfinv)."""
    jw, tw = quad
    traces = [mod.make_protocol("sync_ps", aggregator=agg).schedule(
        _spec(mod), rounds=3,
        plan=mod.byzantine_workers(N, f=1, mode=mode, scale=4.0))
        for mod in (JCL, TCL)]
    assert plain(traces[1]) == plain(traces[0])
    want = JCL.replay(traces[0], jw, lr=0.1)
    got = TCL.replay(traces[1], tw, lr=0.1)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)


def _reduced_lm():
    """JAX's reduced LM workload and the port's on JAX's parameters."""
    jw = JCL.lm_workload(smoke=True, batch=2, seq=16)
    tw = TCL.lm_workload(smoke=True, batch=2, seq=16, device="cpu")
    tw = dataclasses.replace(tw, params0=interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jw.params0)))
    assert tw.name == jw.name
    return jw, tw


def _lm_trace(mod, name):
    if name == "async_ps":
        return mod.make_protocol(name).schedule(_spec(mod), horizon=4.0)
    return mod.make_protocol(name).schedule(_spec(mod), rounds=2)


@pytest.mark.parametrize("name", ["sync_ps", "async_ps"])
def test_replay_reduced_lm_equals_jax(name):
    """The reduced repro-100m LM (2 layers, d 128, vocab 256) with JAX's
    parameters carried across: the same synthetic batches (prng.randint)
    and the same trace give losses within 1e-5 on the fp32 wire."""
    jw, tw = _reduced_lm()
    np.testing.assert_allclose(float(tw.eval_loss(tw.params0)),
                               float(jw.eval_loss(jw.params0)), rtol=RTOL)
    want = JCL.replay(_lm_trace(JCL, name), jw, codec="none", lr=0.2)
    got = TCL.replay(_lm_trace(TCL, name), tw, codec="none", lr=0.2)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)
    assert np.isfinite(got.losses).all()


def test_replay_reduced_lm_rq4_differs_from_jax_only_by_code_flips():
    """On the rq4 wire the LM's gradients (which differ from XLA's by
    ~1e-6 relative: another summation order) meet stochastic rounding:
    an element whose uniform lies within that difference of its rounding
    threshold takes the next level. Given JAX's OWN gradient the port's
    codes are JAX's bit for bit; on the port's gradient all but a few
    elements of the 560k keep JAX's level, each flip moving one
    coordinate by one level ((hi - lo) / 15), so the replay's losses are
    held at 1e-3 here, and at 1e-5 on the fp32 wire above."""
    jw, tw = _reduced_lm()
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 1),
                             0)
    tkey = prng.fold_in(prng.fold_in(prng.PRNGKey(0), 1), 0)
    g_j = jw.grad_fn(jw.params0, key)
    q_j = jcomp.codec("rq4").tree_qdq_flat(g_j, jax.random.fold_in(key, 7))
    codec = tcomp.codec("rq4")
    q_same = codec.tree_qdq_flat(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, g_j)), prng.fold_in(tkey, 7))
    q_own = codec.tree_qdq_flat(tw.grad_fn(tw.params0, tkey),
                                prng.fold_in(tkey, 7))
    flat = tcomp.FlatLayout.from_tree(q_same)
    want = np.asarray(jcomp.FlatLayout.from_tree(q_j).flatten(q_j))
    np.testing.assert_array_equal(flat.flatten(q_same).numpy(), want)
    step = float(np.max(np.abs(np.diff(np.unique(want)))))
    far = np.abs(flat.flatten(q_own).numpy() - want) > step / 2
    assert far.sum() <= 10 and far.mean() < 1e-4
    got = TCL.replay(_lm_trace(TCL, "sync_ps"), tw, lr=0.2)
    ref = JCL.replay(_lm_trace(JCL, "sync_ps"), jw, lr=0.2)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-3)


def test_replay_codec_calls_follow_the_trace(monkeypatch, quad):
    """Each codec'd gradient is ONE fused flat-codec call, and a replay
    makes only the calls its trace charges: every update of sync / async
    / LAQ, H a round for each present local-SGD row, plus one
    compressed-checkpoint pull per rejoin."""
    calls = []
    flat_qdq = tcomp.QuantCodec.flat_qdq

    def counting(self, flat, key, **kw):
        calls.append(int(flat.numel()))
        return flat_qdq(self, flat, key, **kw)

    monkeypatch.setattr(tcomp.QuantCodec, "flat_qdq", counting)
    tw = quad[1]
    for name, fault, kw in (("sync_ps", None, {}), ("async_ps", None, {}),
                            ("laq", "lossy_network", {}),
                            ("local_sgd", "crash_restart", {"period_h": 2}),
                            ("dcd", None, {})):
        tr = _schedule(TCL, name, fault, **kw)
        calls.clear()
        TCL.replay(tr, tw)
        if name == "local_sgd":
            want = sum(len(p) for p in tr.extra("present")) * 2 + sum(
                len(r) for r in tr.extra("rejoiners"))
            assert sum(len(r) for r in tr.extra("rejoiners")) >= 1
        elif name in ("sync_ps", "dcd"):
            want = tr.extra("rounds") * N
        else:
            want = tr.n_updates
        assert len(calls) == want, (name, len(calls), want)
        assert set(calls) == {32}


def test_replay_rejects_an_unknown_protocol(quad):
    tr = dataclasses.replace(_schedule(TCL, "sync_ps"), protocol="nope")
    with pytest.raises(KeyError):
        TCL.replay(tr, quad[1])


# ---------------------------------------------------------------------------
# Timeline, export, checked_decode, flight recorder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, fault", [("sync_ps", "crash_restart"),
                                         ("async_ps", "lossy_network"),
                                         ("dsgd", "churn"),
                                         ("sync_ps", "corrupt_wire")])
def test_timeline_counts_equal_jax(name, fault):
    tr_t, tr_j = _schedule(TCL, name, fault), _schedule(JCL, name, fault)
    got = ttrace.timeline_from_trace(tr_t).events()
    want = jtrace.timeline_from_trace(tr_j).events()
    assert texport.timeline_counts(got) == jexport.timeline_counts(want)
    assert texport.expected_counts(tr_t) == jexport.expected_counts(tr_j)
    assert [(e["ph"], e["cat"], e["pid"], e["tid"]) for e in got] == \
        [(e["ph"], e["cat"], e["pid"], e["tid"]) for e in want]
    counts = texport.verify_timeline(tr_t, ttrace.timeline_from_trace(tr_t))
    assert sum(counts["wire_by_status"].values()) == len(tr_t.comm)


def test_export_cli_writes_a_verified_timeline(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    out = tmp_path / "timeline.json"
    try:
        assert texport.main(["trace", "--n", "4", "--rounds", "3",
                             "--quorum", "3", "--out", str(out)]) == 0
    finally:
        tobs.disable()
    doc = json.loads(out.read_text())
    counts = doc["metadata"]["counts"]
    tr = texport.build_trace(n=4, rounds=3, quorum=3)
    assert counts == texport.expected_counts(tr)
    assert counts == jexport.expected_counts(jexport.build_trace(
        n=4, rounds=3, quorum=3))


def test_checked_decode_is_the_decode_and_refuses_a_flipped_bit():
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(300, 17)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(5,)).astype(
            np.float32))}
    cdc = tcomp.codec("rq4")
    packed = cdc.tree_encode_flat(tree, prng.PRNGKey(3), bucket_elems=2048)
    _, crc = tcomp.frame(packed)
    got = tcomp.checked_decode(cdc, packed, crc)
    assert torch.equal(got.view(torch.int32),
                       cdc.flat_decode(packed).view(torch.int32))
    for bit in (0, 8 * packed.payload.numel() + 3):
        with pytest.raises(tcomp.WireCorruptionError):
            tcomp.checked_decode(cdc, tcomp.flip_bit(packed, bit), crc)
    poisoned = dataclasses.replace(packed, params=packed.params.clone())
    poisoned.params[0, 1] = float("nan")
    with pytest.raises(tcomp.WireCorruptionError, match="NaN/Inf"):
        tcomp.checked_decode(cdc, poisoned, tcomp.wire_crc32(poisoned))


def test_flight_guarded_dumps_and_reraises(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    tobs.enable(trace=False, metrics=False, flight=True)
    tflight.reset()
    try:
        tflight.record("probe", x=1)

        @tflight.guarded("scheduler.test")
        def boom():
            raise ValueError("bad trace")

        with pytest.raises(ValueError, match="bad trace"):
            boom()
        dump = json.loads((tmp_path / "flight_scheduler_test.json"
                           ).read_text())
        assert dump["reason"] == "ValueError: bad trace"
        assert [e["kind"] for e in dump["events"]] == ["probe"]
    finally:
        tobs.disable()
        tflight.reset()
    assert tflight.recorder().snapshot() == []


def test_kernel_scope_is_free_when_off_and_a_profiler_range_when_on():
    tobs.disable()
    assert type(tflight.kernel_scope("quant.qdq_flat")).__name__ == \
        "nullcontext"
    tobs.enable(trace=True, metrics=False, flight=False)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            with tflight.kernel_scope("quant.qdq_flat"):
                torch.ones(4).sum()
    finally:
        tobs.disable()
    assert "quant.qdq_flat" in {e.key for e in prof.key_averages()}


def test_scheduler_fills_the_metrics_registry_like_jax():
    from repro import obs as jobs

    def snapshot(mod, obs_mod):
        obs_mod.enable(trace=False, metrics=True, flight=False)
        obs_mod.metrics_registry().reset()
        try:
            _schedule(mod, "sync_ps", "lossy_network")
            return obs_mod.metrics_registry().snapshot()
        finally:
            obs_mod.metrics_registry().reset()
            obs_mod.disable()

    got, want = snapshot(TCL, tobs), snapshot(JCL, jobs)
    assert got == want and got
