"""The port's launcher on n ranks (gloo, on the CPU) against JAX's
n-device train step, and against itself at world 1.

``repro_torch.launch.train`` on n ranks runs JAX's ('data', 'model')
mesh of (n, 1): the state replicated, each global batch split over
'data', the loss and gradient averaged over 'data' before the clip and
the codec. JAX's side (``_jax_main``, a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) is what
``repro.launch.train.main`` does, built from its pieces: the test cannot
call that ``main`` under JAX 0.9.0, where ``jax.make_mesh`` defaults to
Explicit axes and the launcher's mesh fails in the embedding gather
(``Resource axis: data of PartitionSpec('data', None, None) is not found
in mesh: ()``); the reference uses Auto axes under ``jax.set_mesh``. The
port's ranks (``_rank_main``, one process each, rendezvous by a file
under the test's temporary directory; they use neither jax nor
``repro``) start from JAX's initial state carried by
``interop.train_state_from_jax``. Every process starts at once in a
module fixture, each running this file:

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/test_torch_dp.py jax SPEC.pkl OUT.pkl
    PYTHONPATH=src python tests/test_torch_dp.py rank SPEC.pkl RANK

Tolerances are ``tests/test_torch_train.py``'s: the loss and grad norm
at TOL, parameters and gradients at GTOL. An n-rank gradient is summed
in another order than one device's, so a whole rq4 step is held at step
0 only (a gradient 1e-6 off flips stochastic roundings); its codec stage
is held bit for bit given the reduced gradient.
"""
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.core import compression as jcomp
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.dist import sharding as jsharding
from repro.models import moe as jmoe
from repro.optim import cosine_schedule as jcosine
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch import interop
from repro_torch.core import compression, prng, pytree
from repro_torch.dist import sharding
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe
from repro_torch.optim import clip_by_global_norm
from repro_torch.train import steps

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-6)

# parameters are held after SGD steps: AdamW divides each update by
# sqrt(v), so an element whose gradient is near 0 moves by ~lr whatever
# its rounding, and a few elements of n-rank and one-device runs end 1e-5
# apart
BASE = dict(arch="repro-100m", batch=4, seq=32, steps=3, lr=0.1,
            optimizer="sgd", compression="none", ef=False, seed=0)
RQ4 = dict(BASE, lr=3e-3, optimizer="adamw", compression="rq4", ef=True)
# held against JAX's n-device step; deepseek's 4 x 16 tokens are ONE MoE
# group, which spans the ranks, or (largest group 16) four, two a rank
MOE = dict(BASE, n=2, arch="deepseek-v2-lite-16b", seq=16, steps=2,
           grads=True)
CASES = {
    "none2": dict(BASE, n=2),
    "none4": dict(BASE, n=4),
    "rq4ef2": dict(RQ4, n=2, stage=True),
    "odd2": dict(BASE, n=2, batch=3, steps=2),
    "moe2": MOE,
    "moe2local": dict(MOE, max_group=16),
    "moe4": dict(MOE, n=4),
}
REPLICATED = [*CASES, "resume"]


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_state(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _jax_init(case: dict):
    cfg = jconfigs.get_config(case["arch"]).reduced()
    scfg = jsteps.TrainStepConfig(grad_compression=case["compression"],
                                  error_feedback=case["ef"])
    state = jsteps.init_train_state(
        cfg, jopt.make_optimizer(case["optimizer"], case["lr"]),
        jax.random.PRNGKey(case["seed"]), step_cfg=scfg)
    return jax.tree_util.tree_map(np.asarray, state)


def _start(argv: list, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": JAX's results by case, (job, rank): a rank's results}."""
    tmp = tmp_path_factory.mktemp("dp")
    init = {name: _jax_init(case) for name, case in CASES.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    with open(tmp / "jax.pkl", "wb") as fh:
        pickle.dump({"cases": CASES, "init": init}, fh)
    procs = [_start([__file__, "jax", str(tmp / "jax.pkl"),
                     str(tmp / "jax_out.pkl")],
                    dict(env, XLA_FLAGS="--xla_force_host_platform_device_"
                         "count=4"))]
    groups = {
        2: [{"name": n, "kind": "case", "case": c} for n, c in CASES.items()
            if c["n"] == 2] + [{"name": "resume", "kind": "resume",
                                "case": RQ4}],
        4: [{"name": n, "kind": "case", "case": c} for n, c in CASES.items()
            if c["n"] == 4],
        1: [{"name": "world1", "kind": "world1", "case": RQ4}],
    }
    ranks = []
    for world, jobs in groups.items():
        spec = tmp / f"world{world}.pkl"
        with open(spec, "wb") as fh:
            pickle.dump({"world": world, "rdv": str(tmp / f"rdv{world}"),
                         "out": str(tmp), "jobs": jobs,
                         "init": {j["name"]: init.get(j["name"])
                                  for j in jobs}}, fh)
        for r in range(world):
            procs.append(_start([__file__, "rank", str(spec), str(r)],
                                dict(env, OMP_NUM_THREADS="1")))
            ranks += [(j["name"], r) for j in jobs]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, out[-4000:]
    with open(tmp / "jax_out.pkl", "rb") as fh:
        res = {"jax": pickle.load(fh)}
    for name, r in ranks:
        res[name, r] = torch.load(tmp / f"{name}_r{r}.pt", weights_only=False)
    return res


class _RankMesh:
    """A 'data' x 'model' mesh as the batch rule reads it, seen from the
    rank at ``index`` along 'data'."""

    def __init__(self, ways: int, index: int):
        self.mesh_dim_names, self.shape = ("data", "model"), (ways, 1)
        self._coord = [index, 0]

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("rows,ways,index,want", [
    (8, 2, 1, (4, 8, True)),
    (8, 4, 3, (6, 8, True)),
    (3, 2, 1, (0, 3, False)),
])
def test_local_batch_follows_the_batch_rule(rows, ways, index, want):
    """A rank's rows of a global batch by ``batch_spec``: the chunk at
    its 'data' coordinate where the axis divides the rows, else the
    whole batch."""
    batch = {"tokens": torch.arange(rows * 5).view(rows, 5),
             "labels": torch.arange(rows * 5).view(rows, 5) + 1}
    got, split = sharding.local_batch(batch, _RankMesh(ways, index))
    lo, hi, split_want = want
    assert split == split_want
    for k in batch:
        assert torch.equal(got[k], batch[k][lo:hi])


@pytest.mark.parametrize("name", ["none2", "none4"])
def test_launcher_matches_jax_n_device_step(runs, name):
    """Uncompressed SGD, 3 steps on n ranks == JAX's n-device step:
    losses and grad norms at TOL, final parameters at GTOL."""
    want, got = runs["jax"][name], runs[name, 0]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], **TOL)
    # one all-reduce of one flat buffer a step
    assert got["split"] and got["reduces"] == CASES[name]["steps"]
    for a, b in zip(pytree.tree_leaves(got["state"]["params"]),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_allclose(a.numpy(), b, **GTOL)


def test_rq4_ef_step_zero_matches_jax_and_its_codec_stage_is_bit_exact(
        runs):
    """rq4 + EF on 2 ranks: step 0's loss and grad norm at TOL against
    JAX's 2-device step; JAX's codec stage (flatten, + residual,
    flat_qdq under fold_in(rng, 0), v - qflat) on the port's reduced and
    clipped gradient gives the port's qflat and residual bit for bit, and
    the train step leaves that residual."""
    want, got = runs["jax"]["rq4ef2"], runs["rq4ef2", 0]
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], **TOL)
    np.testing.assert_allclose(got["gnorm"][0], want["gnorm"][0], **TOL)
    assert np.isfinite(got["loss"]).all()
    jcodec = jcomp.codec("rq4")

    @jax.jit
    def jax_stage(grads, ec_err, rng, step):
        qkey = jax.random.fold_in(rng, step)
        layout = jcomp.FlatLayout.from_tree(grads)
        v = layout.flatten(grads) + ec_err
        qflat = jcodec.flat_qdq(v, qkey)
        return layout.unflatten(qflat), v - qflat

    clipped = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     got["clipped"])
    total = jcomp.FlatLayout.from_tree(clipped).total
    jq, jerr = jax_stage(clipped, jnp.zeros((total,), jnp.float32),
                         jax.random.PRNGKey(0), jnp.int32(0))
    for a, b in zip(pytree.tree_leaves(got["q"]),
                    jax.tree_util.tree_leaves(jq)):
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))
    np.testing.assert_array_equal(_u32(got["err"].numpy()), _u32(jerr))
    assert torch.equal(_bits(got["step_err"]), _bits(got["err"]))
    assert got["comm"] == got["step_comm"] == jcodec.tree_wire_bytes_flat(jq)


@pytest.mark.parametrize("name", REPLICATED)
def test_replicas_are_bit_identical(runs, name):
    """Every rank ends each run with the same state, bit for bit."""
    world = CASES[name]["n"] if name in CASES else 2
    for r in range(1, world):
        for key in ("state", "resumed"):
            if key in runs[name, 0]:
                assert _same_state(runs[name, 0][key], runs[name, r][key])
        if "loss" in runs[name, 0]:
            assert runs[name, 0]["loss"] == runs[name, r]["loss"]


@pytest.mark.parametrize("how", ["given", "torchrun"])
def test_world_one_is_the_one_card_launcher(runs, how):
    """rq4 + EF, 3 steps: a world of one (a given gloo group, or one made
    from torchrun's variables) == the launcher with no group, bit for
    bit; the launcher destroys a group it made and keeps a given one."""
    got = runs["world1", 0]
    assert _same_state(got[how], got["none"])
    assert int(got[how]["step"]) == 3
    assert got["given_kept_group"] and not got["torchrun_left_group"]


def test_undivided_batch_runs_whole_on_every_rank(runs):
    """3 rows on 2 ranks: the batch is not split and nothing is reduced
    (JAX replicates it); losses, grad norms and parameters as JAX's
    2-device step on the replicated batch."""
    want, got = runs["jax"]["odd2"], runs["odd2", 0]
    assert not got["split"] and got["reduces"] == 0
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], **TOL)
    for a, b in zip(pytree.tree_leaves(got["state"]["params"]),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_allclose(a.numpy(), b, **GTOL)


@pytest.mark.parametrize("name,gathered", [("moe2", True),
                                           ("moe2local", False),
                                           ("moe4", True)],
                         ids=["spanning", "per-rank", "spanning4"])
def test_moe_groups_of_the_global_batch_match_jax(runs, name, gathered):
    """Reduced deepseek-v2-lite-16b, 4 x 16 tokens on 2 or 4 ranks,
    grouped as JAX groups the global batch: one group spanning the ranks
    (every rank runs it on the gathered tokens), or four of 16, each of
    2 ranks dispatching its own two (nothing gathered). Step 0's reduced
    loss (with the router's aux loss) and gradient, and every step's
    loss and grad norm, as JAX's n-device step."""
    want, got = runs["jax"][name], runs[name, 0]
    assert (got["gathers"] > 0) == gathered
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"], **TOL)
    assert pytree.tree_flatten(got["grads"])[1] == pytree.tree_flatten(
        got["state"]["params"])[1]
    for a, b in zip(pytree.tree_leaves(got["grads"]),
                    jax.tree_util.tree_leaves(want["grads"])):
        np.testing.assert_allclose(a.numpy(), b, **GTOL)
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], **TOL)


def test_two_rank_resume_is_bit_exact(runs):
    """2 ranks, rq4 + EF, 3 steps with a checkpoint every 2: rank 0 wrote
    steps 2 and 3; both ranks resumed from step 2 alone end bit for bit
    where the uninterrupted run ended."""
    for r in range(2):
        got = runs["resume", r]
        assert got["files"] == ["step-00000002.npz", "step-00000003.npz"]
        assert int(got["resumed"]["step"]) == 3
        assert _same_state(got["resumed"], got["state"])


def test_launcher_under_a_group_defaults_to_the_local_rank_card(runs):
    """Under a group a rank asks for cuda:LOCAL_RANK unless --device says
    otherwise, and raises on a host without a card."""
    assert tlaunch.rank_device(None, 3) == "cuda:3"
    assert tlaunch.rank_device("cpu", 3) == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert "CUDA device requested" in runs["world1", 0]["no_device"]


# --------------------------------------------------------------------------
# The subprocesses: JAX's n-device step, and the port's ranks
# --------------------------------------------------------------------------

_JAX_MAX_GROUP = jmoe.MAX_GROUP
_MAX_GROUP = moe.MAX_GROUP


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_case(case: dict, init) -> dict:
    """What ``repro.launch.train.main`` does on an n-device host: an (n,
    1) ('data', 'model') mesh over the first n devices (Auto axes, under
    ``jax.set_mesh``), ``jit(make_train_step)`` on the replicated state
    (the spec's arrays), each global batch ``batch_at(t)`` placed by
    ``batch_shardings``; with ``grads``, also the loss and gradient of
    step 0's batch on that mesh."""
    cfg = jconfigs.get_config(case["arch"]).reduced()
    n = case["n"]
    mesh = jax.make_mesh((n, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    jsharding.set_activation_batch_axes(("data",))
    jmoe.MAX_GROUP = case.get("max_group", _JAX_MAX_GROUP)
    total = case["steps"]
    opt = jopt.make_optimizer(case["optimizer"], jcosine(
        case["lr"], warmup=min(50, total // 10 + 1), total=total))
    scfg = jsteps.TrainStepConfig(grad_compression=case["compression"],
                                 error_feedback=case["ef"])
    state = jax.tree_util.tree_map(jnp.asarray, init)
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=case["seq"] + 1,
                       batch=case["batch"], seed=case["seed"])
    out = {"loss": [], "gnorm": []}
    with jax.set_mesh(mesh):
        if case.get("grads"):
            loss_fn = jsteps.make_loss_fn(cfg, scfg)
            b = data.batch_at(0)
            b = jax.device_put(b, jsharding.batch_shardings(b, mesh))
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                state["params"], b)
            out["grad_loss"], out["grads"] = float(loss), _np(grads)
        train_step = jax.jit(jsteps.make_train_step(cfg, opt, scfg))
        for t in range(total):
            b = data.batch_at(t)
            b = jax.device_put(b, jsharding.batch_shardings(b, mesh))
            state, m = train_step(state, b)
            out["loss"].append(float(m["loss"]))
            out["gnorm"].append(float(m["grad_norm"]))
    out["params"] = _np(state["params"])
    return out


def _jax_main(spec_path: str, out_path: str) -> None:
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    out = {name: _jax_case(case, spec["init"][name])
           for name, case in spec["cases"].items()}
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


def _rank_argv(case: dict, **kw) -> list:
    argv = ["--device", "cpu", "--reduced", "--arch", case["arch"],
            "--steps", str(case["steps"]), "--batch", str(case["batch"]),
            "--seq", str(case["seq"]), "--lr", str(case["lr"]),
            "--optimizer", case["optimizer"], "--compression",
            case["compression"], "--seed", str(case["seed"]),
            "--log-every", "1000"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv + (["--error-feedback"] if case["ef"] else [])


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _case_job(case: dict, init) -> dict:
    """``launch.train.setup`` under the group, the state replaced by
    JAX's initial one, then ``run_steps``, counting the all-reduces and
    all-gathers; ``stage``: step 0's reduced and clipped gradient through
    ``compress_grads``, and a train step's residual from the same state;
    ``grads``: step 0's reduced loss and gradient; ``max_group``: the MoE
    layer's largest group."""
    moe.MAX_GROUP = case.get("max_group", _MAX_GROUP)
    args = tlaunch.parse_args(_rank_argv(case))
    run = tlaunch.setup(args)
    run["state"] = interop.train_state_from_jax(init)
    out = {}
    if case.get("stage") or case.get("grads"):
        scfg = steps.TrainStepConfig(grad_compression=case["compression"],
                                     error_feedback=case["ef"])
        loss_fn = steps.make_loss_fn(run["cfg"], scfg)
        rows, split = sharding.local_batch(run["data"].batch_at(0),
                                           run["mesh"])
        assert split
        loss, grads = steps.data_value_and_grad(
            loss_fn, run["state"]["params"], rows, run["mesh"])
        out["grad_loss"], out["grads"] = float(loss), _cpu(grads)
        if case.get("stage"):
            clipped, _ = clip_by_global_norm(grads, 1.0)
            key = prng.fold_in(run["state"]["rng"], 0)
            q, err, comm = steps.compress_grads(
                compression.codec(case["compression"]), clipped, key,
                run["state"]["ec_err"].clone())
            out["clipped"], out["q"], out["err"] = (_cpu(clipped), _cpu(q),
                                                    err.clone())
            first, m = run["train_step"](steps.state_to(run["state"], "cpu"),
                                         run["data"].batch_at(0))
            out["step_err"] = first["ec_err"].clone()
            out["comm"], out["step_comm"] = comm, float(m["comm_bytes"])
    calls = {"all_reduce": 0, "all_gather": 0}
    real = {k: getattr(dist, k) for k in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    for k in calls:
        setattr(dist, k, counted(k))
    try:
        out["loss"], out["gnorm"] = [], []
        for _, m in tlaunch.run_steps(args, run):
            out["loss"].append(float(m["loss"]))
            out["gnorm"].append(float(m["grad_norm"]))
    finally:
        for k, fn in real.items():
            setattr(dist, k, fn)
    out["reduces"], out["gathers"] = calls["all_reduce"], calls["all_gather"]
    out["split"] = sharding.local_batch(
        run["data"].batch_at(0), run["mesh"])[1]
    out["state"] = _cpu(run["state"])
    return out


def _resume_job(case: dict, tmp: str) -> dict:
    """``launch.train.main`` with checkpoints, straight, and again from
    a directory holding only rank 0's step-2 file."""
    rank = dist.get_rank()
    straight = os.path.join(tmp, "straight")
    again = os.path.join(tmp, "again")
    full = tlaunch.main(_rank_argv(case, ckpt_dir=straight, ckpt_every=2))
    if rank == 0:
        os.makedirs(again)
        shutil.copy(os.path.join(straight, "step-00000002.npz"), again)
    dist.barrier()
    resumed = tlaunch.main(_rank_argv(case, ckpt_dir=again, ckpt_every=2))
    return {"state": _cpu(full), "resumed": _cpu(resumed),
            "files": sorted(os.listdir(straight))}


def _world1_job(case: dict, rdv: str) -> dict:
    """A world of one: ``main`` with no group, under a group made from
    torchrun's variables, and under a given gloo group; and ``main``
    without ``--device`` under that group, which must raise on a host
    without a card."""
    out = {"none": _cpu(tlaunch.main(_rank_argv(case)))}
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": "0"}
    os.environ.update(env)
    try:
        out["torchrun"] = _cpu(tlaunch.main(_rank_argv(case)))
        out["torchrun_left_group"] = dist.is_initialized()
    finally:
        for k in env:
            del os.environ[k]
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    out["given"] = _cpu(tlaunch.main(_rank_argv(case)))
    out["given_kept_group"] = dist.is_initialized()
    try:
        tlaunch.main(["--reduced", "--steps", "1"])
        out["no_device"] = "ran"
    except RuntimeError as e:
        out["no_device"] = str(e)
    return out


def _rank_main(spec_path: str, rank: str) -> None:
    """One gloo rank, one thread: the spec's jobs in order, each written
    to ``<job>_r<rank>.pt`` in the spec's output directory."""
    rank = int(rank)
    torch.set_num_threads(1)
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    world = spec["world"]
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{spec['rdv']}",
                                rank=rank, world_size=world)
    for job in spec["jobs"]:
        name, kind, case = job["name"], job["kind"], job["case"]
        if kind == "case":
            res = _case_job(case, spec["init"][name])
        elif kind == "resume":
            res = _resume_job(case, os.path.join(spec["out"], name))
        else:
            res = _world1_job(case, spec["rdv"])
        torch.save(res, os.path.join(spec["out"], f"{name}_r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    {"jax": _jax_main, "rank": _rank_main}[sys.argv[1]](*sys.argv[2:4])
