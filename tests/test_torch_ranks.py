"""The paper's exchanges on a real worker axis: one worker a gloo rank
(``axis_name=`` a ``RankAxis``), against JAX's exchanges under
``jax.shard_map`` over a ('workers',) mesh of host devices, and against
the port's stacked form.

Every process starts at once in a module fixture, each running this
file: JAX's side, two subprocesses for each mesh of 2 and of 4 devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``; one runs the
jitted exchanges, the other the op-by-op steps), runs each exchange 3
steps, threading its state, on seeded numpy gradient trees with odd
leaf sizes, each worker seeing its own shard; the port's side,
2 and 4 gloo rank processes, runs the same exchanges on each rank's own
row of the same trees, counting the bytes each rank sends. The JAX
subprocess for 4 devices op by op also runs JAX's ``run_quadratic``
(vmap), held
against ``run_distributed`` on the 4 ranks:

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/test_torch_ranks.py jax SPEC.pkl N jit|eager OUT.pkl
    PYTHONPATH=src python tests/test_torch_ranks.py rank SPEC.pkl RANK

Where only ``ppermute`` moves data (the ring's three forms, DCD and ECD
on rq4, Delayed over the ring) the ranks equal JAX's and the stacked
form bit for bit; where a ``pmean`` sums (MbSGD, the PS form, ECSGD,
gossip) they are held at rtol = atol = 1e-6, as in
tests/test_torch_parallel.py: JAX's pmean multiplies by 1/N, the port's
divides, and the all-reduce sums in its own order. JAX's exchanges run
jitted; DCD and ECD also run op by op (``EAGER_STEPS``), which is what
they are held to bit for bit, their jitted steps at 1e-6.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import communicators as JC
from repro.core import parallel as JP
from repro_torch.core import communicators as TC
from repro_torch.core import parallel as TP
from repro_torch.core import prng, pytree
from repro_torch.launch import ranks as ranks_cli

ROOT = Path(__file__).resolve().parents[1]
AXIS = "workers"
TOL = dict(rtol=1e-6, atol=1e-6)
STEPS = 3
WORLDS = (2, 4)
QUAD = dict(n_workers=4, steps=30, lr=0.1, seed=2)
# steps of DCD/ECD that JAX also runs op by op under shard_map: jitted,
# XLA contracts the mix of the replicas (c * x + y) into fused
# multiply-adds, which JAX's own op-by-op execution, the port's stacked
# form and its ranks do not (each multiply and add rounded, as the
# exchange is written); an op-by-op step takes ~5 s
EAGER_STEPS = 2


def _w_explicit(n: int) -> list:
    """0.5 I + 0.3 (shift by one) + 0.2 (reversal): doubly stochastic,
    lowered onto two non-identity terms."""
    w = 0.5 * np.eye(n)
    for i in range(n):
        w[(i + 1) % n, i] += 0.3
        w[n - 1 - i, i] += 0.2
    return w.tolist()


RQ4_RING = ("csgd_ring", {"compressor": "rq4"})
# name: (kind, spec(n), exact); kind "grad" is exchange(g, state, key),
# "mix" GossipMix(params), "dcd" init_stacked then (params, state, key);
# exact: True bit for bit against JAX, "eager" against JAX op by op (and
# the jitted steps at TOL), "stacked" against the port's stacked form
# (and JAX at TOL), False at TOL
CASES = {
    "ring": ("grad", lambda n: RQ4_RING, True),
    "ring_mono": ("grad", lambda n: ("csgd_ring", {
        "compressor": "rq4", "partitioned": False}), True),
    "ring_leaf": ("grad", lambda n: ("csgd_ring", {
        "compressor": "rq4", "flat": False}), True),
    "ring_qdq": ("grad", lambda n: ("csgd_ring", {
        "compressor": "rand_sparse_10"}), False),
    "asgd_ring": ("grad", lambda n: ("asgd", {"inner": RQ4_RING,
                                              "tau": 2}), True),
    "asgd_sched": ("grad", lambda n: ("asgd", {
        "inner": ("csgd_ring", {"compressor": "rq4", "flat": False}),
        "tau": 2, "schedule": [[(i + t) % 3 for t in range(3)]
                               for i in range(n)]}), True),
    "mbsgd": ("grad", lambda n: ("mbsgd", {}), False),
    "ps": ("grad", lambda n: ("csgd_ps", {"compressor": "rq8"}), False),
    "ps_leaf": ("grad", lambda n: ("csgd_ps", {"compressor": "rq8",
                                               "flat": False}), False),
    "ecsgd": ("grad", lambda n: ("ecsgd", {}), False),
    "ecsgd_leaf": ("grad", lambda n: ("ecsgd", {"compressor": "rq4",
                                                "flat": False}), False),
    "gossip_ring": ("mix", lambda n: ("gossip", {}), False),
    "gossip_full": ("mix", lambda n: ("gossip", {"topology": "full"}),
                    False),
    "gossip_torus": ("mix", lambda n: ("gossip", {"topology": "torus"}),
                     False),
    "gossip_w": ("mix", lambda n: ("gossip", {"w": _w_explicit(n)}),
                 False),
    "dcd": ("dcd", lambda n: ("dcd", {"compressor": "rq4"}), "eager"),
    "ecd": ("dcd", lambda n: ("ecd", {"compressor": "rq4"}), "eager"),
    "dcd_w": ("dcd", lambda n: ("dcd", {"compressor": "rq4",
                                        "w": _w_explicit(n)}), "stacked"),
}
# the bytes a rank sends a step are the exchange's message_bytes
WIRED = ("ring", "ring_mono", "ring_leaf", "asgd_ring", "dcd", "ecd",
         "dcd_w")
RUNS = {"ring": ("csgd_ring", {"exchange_kw": {"compressor": "rq4"}}),
        "dcd": ("dcd", {"exchange_kw": {"compressor": "rq4"}})}


def _make(mod, spec):
    name, kw = spec
    kw = dict(kw)
    if "inner" in kw:
        kw["inner"] = _make(mod, kw["inner"])
    return mod.make_exchange(name, **kw)


def _tree(n: int, seed: int) -> dict:
    """n workers' trees (stacked numpy) with odd leaf sizes."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=(n,) + s) * 0.1).astype(  # noqa: E731
        np.float32)
    return {"a": f(1033), "b": {"w": f(7, 5)}, "c": [f(2000)], "s": f(1)}


def _seed(name: str, t: int) -> int:
    return 100 * list(CASES).index(name) + t


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _start(argv: list, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{("jax", n): JAX's results by case, ("jaxrun", name): JAX's
    run_quadratic, (n, rank): a rank's results, "quad": the problem}."""
    tmp = tmp_path_factory.mktemp("ranks")
    prob = JP.Quadratic.make(jax.random.PRNGKey(QUAD["seed"]), d=32,
                             n_workers=QUAD["n_workers"])
    quad = {"a": np.array(prob.a), "b": np.array(prob.b)}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = []
    for n in WORLDS:
        spec = tmp / f"world{n}.pkl"
        with open(spec, "wb") as fh:
            pickle.dump({"world": n, "rdv": str(tmp / f"rdv{n}"),
                         "out": str(tmp), "quad": quad}, fh)
        procs += [_start(
            [__file__, "jax", str(spec), str(n), part,
             str(tmp / f"jax{n}{part}.pkl")],
            dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
            for part in ("jit", "eager")]
        procs += [_start([__file__, "rank", str(spec), str(r)],
                         dict(env, OMP_NUM_THREADS="1")) for r in range(n)]
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    res = {"quad": quad}
    for n in WORLDS:
        res["jax", n] = {name: {} for name in CASES}
        for part in ("jit", "eager"):
            with open(tmp / f"jax{n}{part}.pkl", "rb") as fh:
                got = pickle.load(fh)
            for name, r in got["cases"].items():
                res["jax", n][name][part] = r
            for name, r in got.get("runs", {}).items():
                res["jaxrun", name] = r
        for r in range(n):
            res[n, r] = torch.load(tmp / f"ranks{n}_r{r}.pt",
                                   weights_only=False)
    return res


def _check(got_leaves, want_leaves, exact: bool) -> None:
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert tuple(np.shape(a)) == tuple(np.shape(b))
        if exact:
            np.testing.assert_array_equal(_u32(a), _u32(b))
        else:
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32), **TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_jax_under_shard_map(runs, name, n):
    """Each rank's update and state, every step, against JAX's worker
    (the rank's shard of the shard_map outputs): bit for bit where only
    ppermute moves data (DCD and ECD against JAX op by op), else at
    TOL."""
    _, _, exact = CASES[name]
    for key, steps, bits in (("jit", STEPS, exact is True),
                             ("eager", EAGER_STEPS, True)):
        want = runs["jax", n][name].get(key)
        if want is None:
            continue
        for r in range(n):
            got = runs[n, r]["cases"][name]
            for t in range(steps):
                _check([a.numpy() for a in got["out"][t]],
                       [a[r] for a in want["out"][t]], bits)
                if want["state"]:       # the gossip mix has no state
                    _check([np.asarray(a.numpy(), np.float32)
                            for a in got["state"][t]],
                           [np.asarray(a[r], np.float32)
                            for a in want["state"][t]], bits)


def _stacked_case(name: str, n: int):
    """The port's stacked form of a case on the same inputs: its outputs
    and states, step by step."""
    kind, spec, _ = CASES[name]
    ex = _make(TC, spec(n))
    outs, states = [], []
    tree = lambda t: pytree.tree_map(  # noqa: E731
        torch.from_numpy, _tree(n, _seed(name, t)))
    if kind == "dcd":
        state = ex.init_stacked(pytree.tree_map(torch.from_numpy,
                                                _tree(n, _seed(name, 99))))
    elif kind == "grad":
        state = ex.init(tree(0))
    for t in range(STEPS):
        if kind == "mix":
            out = ex(tree(t))
        else:
            out, state = ex(tree(t), state, prng.PRNGKey(t))
            states.append([s.clone() for s in pytree.tree_leaves(state)])
        outs.append([o.clone() for o in pytree.tree_leaves(out)])
    return outs, states


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", [c for c, (_, _, e) in CASES.items() if e]
                         + ["gossip_ring", "gossip_w"])
def test_ranks_equal_the_stacked_form_where_only_ppermute_moves_data(
        runs, name, n):
    """Rank r's update and state == row r of the port's stacked exchange
    on the same inputs, bit for bit (the ring, Delayed over it, DCD, ECD,
    and the ring and explicit-W gossip, whose terms are ppermutes)."""
    outs, states = _stacked_case(name, n)
    for r in range(n):
        got = runs[n, r]["cases"][name]
        for t in range(STEPS):
            _check([a.numpy() for a in got["out"][t]],
                   [a[r].numpy() for a in outs[t]], True)
            if states:      # the stacked state holds worker r as row r
                assert len(got["state"][t]) == len(states[t])
                for a, b in zip(got["state"][t], states[t]):
                    assert torch.equal(_bits(a), _bits(b[r]))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", WIRED)
def test_bytes_a_rank_sends_equal_message_bytes(runs, name, n):
    """The ring's three forms (and Delayed over the ring) and DCD/ECD:
    every step each rank's RankAxis counts exactly ``message_bytes`` of
    one worker's tree sent."""
    kind, spec, _ = CASES[name]
    ex = _make(TC, spec(n))
    one = pytree.tree_map(lambda a: torch.from_numpy(a[0]), _tree(n, 0))
    want = ex.message_bytes(one, n_workers=n)
    for r in range(n):
        got = runs[n, r]["cases"][name]
        assert got["sent"] == [want] * STEPS


@pytest.mark.parametrize("n", WORLDS)
def test_partitioned_ring_replicas_are_bit_identical(runs, n):
    """The all-gather forwards finished partitions verbatim: every rank
    ends each step with the same bits."""
    for t in range(STEPS):
        first = runs[n, 0]["cases"]["ring"]["out"][t]
        for r in range(1, n):
            for a, b in zip(runs[n, r]["cases"]["ring"]["out"][t], first):
                assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("method", list(RUNS))
def test_run_distributed_on_ranks_matches_stacked_and_jax(runs, method,
                                                          monkeypatch):
    """run_quadratic on 4 gloo ranks (JAX's problem, 30 steps): each
    rank's final params == row r of the stacked run bit for bit; losses,
    grad norms and consensus within TOL of it (x̄ and the consensus are
    all-reduces); and JAX's run_quadratic at test_torch_parallel.py's
    tolerance for compressed methods."""
    name, kw = RUNS[method]
    prob = TP.Quadratic(torch.from_numpy(runs["quad"]["a"]),
                        torch.from_numpy(runs["quad"]["b"]), 4)
    monkeypatch.setattr(TP.Quadratic, "make",
                        staticmethod(lambda *a, **k: prob))
    stacked = TP.run_quadratic(name, device="cpu", **QUAD, **kw)
    want = runs["jaxrun", method]
    for r in range(4):
        got = runs[4, r]["runs"][method]
        assert torch.equal(_bits(got["params"]), _bits(stacked.params[r]))
        for key in ("losses", "grad_norms", "consensus"):
            np.testing.assert_allclose(got[key].numpy(),
                                       getattr(stacked, key).numpy(), **TOL)
        assert got["comm"] == stacked.comm_bytes_per_step == want["comm"]
        np.testing.assert_allclose(got["losses"].numpy(), want["losses"],
                                   rtol=1e-3)
        np.testing.assert_allclose(got["consensus"].numpy(),
                                   want["consensus"], rtol=1e-2, atol=1e-9)
        np.testing.assert_allclose(got["params"].numpy(),
                                   want["params"][r], rtol=1e-3, atol=1e-6)
    if method == "ring":
        assert all(float(c) == 0.0 for c in got["consensus"])


@pytest.mark.parametrize("n", WORLDS)
def test_rank_axis_collectives(runs, n):
    """RankAxis as JAX's collectives: a ppermute's non-receivers get
    zeros and a fixed point keeps its own value; a list moves in one
    batch; a non-permutation raises; pmean is the sum truly divided by
    N; ``RankAxis(group)`` runs an exchange over another group and
    counts its bytes, a raw group as ``axis_name`` raises; a bad
    run_distributed worker count raises."""
    for r in range(n):
        got = runs[n, r]["axis"]
        x = float(r + 1)
        assert got["shift"] == float((r - 1) % n + 1)
        # (0 -> 1) only: rank 1 receives rank 0's value, the rest zeros
        assert got["partial"] == (1.0 if r == 1 else 0.0)
        assert got["fixed"] == x
        assert got["pair"] == [float((r - 1) % n + 1),
                               float(10 * ((r - 1) % n + 1))]
        assert got["bad_perm"] and got["bad_workers"]
        assert got["pmean"] == np.float32(sum(range(1, n + 1))) / \
            np.float32(n)
        assert got["raw_group"] and got["group_bytes"] > 0


@pytest.mark.parametrize("n", WORLDS)
def test_rank_axis_first_ppermute_may_leave_ranks_out(runs, n):
    """A fresh RankAxis whose first ppermute moves (0 -> 1) alone, then a
    pmean: every rank joins the axis in that ppermute, so each rank's
    pmean meets the others' and every rank gets the mean."""
    for r in range(n):
        got = runs[n, r]["axis"]
        assert got["partial"] == (1.0 if r == 1 else 0.0)
        assert got["first_pmean"] == np.float32(sum(range(1, n + 1))) / \
            np.float32(n)


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_cli_runs_a_method_on_the_callers_group(runs, n):
    """``launch.ranks.main`` under a group its caller made: the method's
    run_quadratic on the ranks, bit for bit the one the caller runs with
    a RankAxis, and the group kept; without a group it raises."""
    for r in range(n):
        got = runs[n, r]["cli"]
        assert got["kept_group"] and got["no_group_raises"]
        assert torch.equal(_bits(got["params"]), _bits(got["want_params"]))
        assert torch.equal(got["losses"], got["want_losses"])


# --------------------------------------------------------------------------
# The subprocesses: JAX's exchanges under shard_map, and the port's ranks
# --------------------------------------------------------------------------


def _np_leaves(tree) -> list:
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _jax_steps(name: str, n: int, wrap, steps: int) -> dict:
    """JAX's exchange under ``jax.shard_map`` over a ('workers',) mesh of
    the first n devices, ``wrap``ped (``jax.jit``, or run op by op):
    each worker's block of the stacked inputs is its own tree (its
    leading dim of one dropped), the key replicated; the outputs and
    states stacked back."""
    from jax.sharding import PartitionSpec as P

    kind, spec, _ = CASES[name]
    ex = _make(JC, spec(n))
    mesh = jax.make_mesh((n,), (AXIS,), devices=jax.devices()[:n])
    one = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)  # noqa
    add = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)  # noqa
    tree = lambda t: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, _tree(n, _seed(name, t)))
    w = P(AXIS)
    if kind == "mix":
        fn = wrap(jax.shard_map(
            lambda p: add(ex(one(p), axis_name=AXIS)), mesh=mesh,
            in_specs=(w,), out_specs=w))
    else:
        def body(g, s, k):
            out, s = ex(one(g), one(s), k, axis_name=AXIS)
            return add(out), add(s)

        fn = wrap(jax.shard_map(body, mesh=mesh,
                                in_specs=(w, w, P()), out_specs=(w, w)))
    if kind == "dcd":
        state = ex.init_stacked(tree(99))
    elif kind == "grad":
        state = jax.vmap(ex.init)(tree(0))
    out = {"out": [], "state": []}
    for t in range(steps):
        if kind == "mix":
            res = fn(tree(t))
        else:
            res, state = fn(tree(t), state, jax.random.PRNGKey(t))
            out["state"].append(_np_leaves(state))
        out["out"].append(_np_leaves(res))
    return out


def _jax_main(spec_path: str, n: str, part: str, out_path: str) -> None:
    """The jitted steps of every case ("jit"), or the op-by-op steps of
    the "eager" cases and, on 4 devices, JAX's run_quadratic."""
    n = int(n)
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    if part == "jit":
        out = {"cases": {name: _jax_steps(name, n, jax.jit, STEPS)
                         for name in CASES}}
    else:
        out = {"cases": {name: _jax_steps(name, n, lambda f: f, EAGER_STEPS)
                         for name, (_, _, e) in CASES.items()
                         if e == "eager"}}
    if part == "eager" and n == QUAD["n_workers"]:
        prob = JP.Quadratic(jnp.asarray(spec["quad"]["a"]),
                            jnp.asarray(spec["quad"]["b"]), n)
        real = JP.Quadratic.make
        JP.Quadratic.make = staticmethod(lambda *a, **k: prob)
        try:
            out["runs"] = {}
            for method, (name, kw) in RUNS.items():
                res = JP.run_quadratic(name, **QUAD, **kw)
                out["runs"][method] = {
                    "losses": np.asarray(res.losses),
                    "consensus": np.asarray(res.consensus),
                    "params": np.asarray(res.params),
                    "comm": res.comm_bytes_per_step}
        finally:
            JP.Quadratic.make = real
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


def _rank_case(name: str, axis) -> dict:
    """One case on this rank: its row of each step's inputs through the
    exchange with ``axis_name=axis``; the bytes it sent a step."""
    kind, spec, _ = CASES[name]
    n, r = axis.n, axis.index
    ex = _make(TC, spec(n))
    tree = lambda t: pytree.tree_map(  # noqa: E731
        lambda a: torch.from_numpy(a[r].copy()), _tree(n, _seed(name, t)))
    if kind == "dcd":
        state = ex.init_stacked(pytree.tree_map(
            lambda a: torch.from_numpy(a[r].copy()),
            _tree(n, _seed(name, 99))), axis_name=axis)
    elif kind == "grad":
        state = ex.init(tree(0), axis_name=axis)
    out = {"out": [], "state": [], "sent": []}
    for t in range(STEPS):
        sent = axis.sent_bytes
        if kind == "mix":
            res = ex(tree(t), axis_name=axis)
        else:
            res, state = ex(tree(t), state, prng.PRNGKey(t), axis_name=axis)
            out["state"].append([s.clone()
                                 for s in pytree.tree_leaves(state)])
        out["sent"].append(axis.sent_bytes - sent)
        out["out"].append([a.clone() for a in pytree.tree_leaves(res)])
    return out


def _rank_axis_job(axis) -> dict:
    """``axis`` is fresh: its first ppermute leaves ranks 2.. out."""
    n, r = axis.n, axis.index
    x = torch.tensor([float(r + 1)])
    out = {"partial": float(axis.ppermute(x, [(0, 1)]))}
    out["first_pmean"] = float(axis.pmean(x))
    out["shift"] = float(axis.ppermute(x, [(i, (i + 1) % n)
                                           for i in range(n)]))
    out["fixed"] = float(axis.ppermute(x, [(i, i) for i in range(n)]))
    pair = axis.ppermute([x, 10 * x], [(i, (i + 1) % n) for i in range(n)])
    out["pair"] = [float(pair[0]), float(pair[1])]
    for key, perm in (("bad_perm", [(0, 1), (1, 1)]),
                      ("bad_workers", [(0, n)])):
        try:
            axis.ppermute(x, perm)
            out[key] = False
        except ValueError:
            out[key] = True
    out["pmean"] = float(axis.pmean(x))
    group = dist.new_group(list(range(n)))
    ring = TC.CSGDRingExchange("rq4")
    sub = TC.RankAxis(group)
    ring({"a": torch.ones(3000)}, (), prng.PRNGKey(0), axis_name=sub)
    out["group_bytes"] = sub.sent_bytes
    try:
        ring({"a": torch.ones(3000)}, (), prng.PRNGKey(0), axis_name=group)
        out["raw_group"] = False
    except TypeError:
        out["raw_group"] = True
    try:
        TP.run_quadratic("mbsgd", n_workers=n + 1, steps=1, device="cpu",
                         axis_name=axis)
    except ValueError:
        pass
    else:
        raise AssertionError("run_distributed took a wrong worker count")
    return out


def _rank_run(method: str, axis, quad: dict) -> dict:
    name, kw = RUNS[method]
    prob = TP.Quadratic(torch.from_numpy(quad["a"]),
                        torch.from_numpy(quad["b"]), axis.n)
    real = TP.Quadratic.make
    TP.Quadratic.make = staticmethod(lambda *a, **k: prob)
    try:
        res = TP.run_quadratic(name, device="cpu", axis_name=axis, **QUAD,
                               **kw)
    finally:
        TP.Quadratic.make = real
    return {"params": res.params, "losses": res.losses,
            "grad_norms": res.grad_norms, "consensus": res.consensus,
            "comm": res.comm_bytes_per_step}


def _rank_main(spec_path: str, rank: str) -> None:
    """One gloo rank, one thread: every case, then (4 ranks) the
    run_quadratic runs, then the axis checks, to ``ranks<n>_r<rank>.pt``."""
    rank = int(rank)
    torch.set_num_threads(1)
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    n = spec["world"]
    dist.init_process_group("gloo", init_method=f"file://{spec['rdv']}",
                            rank=rank, world_size=n)
    axis = TC.RankAxis()
    res = {"cases": {name: _rank_case(name, axis) for name in CASES}}
    if n == QUAD["n_workers"]:
        res["runs"] = {m: _rank_run(m, TC.RankAxis(), spec["quad"])
                       for m in RUNS}
    res["axis"] = _rank_axis_job(TC.RankAxis())
    cli = ranks_cli.main(["--device", "cpu", "--method", "dcd",
                          "--compressor", "rq4", "--steps", "5",
                          "--log-every", "5"])
    want = TP.run_quadratic("dcd", n_workers=n, steps=5, device="cpu",
                            exchange_kw={"compressor": "rq4"},
                            axis_name=TC.RankAxis())
    res["cli"] = {"kept_group": dist.is_initialized(), "params": cli.params,
                  "losses": cli.losses, "want_params": want.params,
                  "want_losses": want.losses}
    dist.destroy_process_group()
    try:
        ranks_cli.main(["--device", "cpu", "--steps", "1"])
        res["cli"]["no_group_raises"] = False
    except RuntimeError:
        res["cli"]["no_group_raises"] = True
    torch.save(res, os.path.join(spec["out"], f"ranks{n}_r{rank}.pt"))


if __name__ == "__main__":
    {"jax": _jax_main, "rank": _rank_main}[sys.argv[1]](*sys.argv[2:])
