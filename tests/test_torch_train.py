"""repro_torch's training path against repro's, on reduced repro-100m
(2 layers, d=256, vocab 512), with JAX's parameters carried across
(``interop``) and inputs from numpy seeds.

Tolerances: the loss at rtol = atol = 1e-5 and the gradients at
rtol = 1e-4, atol = 1e-6 — the two frameworks sum the matmuls, the
softmax and the backward's reductions in different orders; the
optimizer updates at rtol = atol = 1e-6 (float32 elementwise chains that
XLA may contract into FMAs). The codec stage of a step (error feedback
+ ``flat_qdq``) is held bit for bit given JAX's gradients; a whole rq
step is not, since gradients that agree to 1e-6 can flip a stochastic
rounding code.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import npz as jnpz
from repro.core import compression as jcomp
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models import transformer_scan as jts
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch import configs, interop
from repro_torch.checkpoint import npz as tnpz
from repro_torch.core import compression as tcomp
from repro_torch.core import prng, pytree
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models import transformer_scan as tts
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

ARCH = "repro-100m"
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-6)
UTOL = dict(rtol=1e-6, atol=1e-6)


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(mc, b=2, s=16, seed=1):
    tok = np.random.default_rng(seed).integers(
        0, mc.vocab, size=(b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.from_numpy(tok[:, :-1]),
          "labels": torch.from_numpy(tok[:, 1:])}
    return jb, tb


@pytest.fixture(scope="module")
def cfgs():
    return (jconfigs.get_config(ARCH).reduced(),
            configs.get_config(ARCH).reduced())


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "scanned"])
def model(request, cfgs):
    """(scan, JAX params, port params, JAX loss, JAX grads) on one batch."""
    jmc, _ = cfgs
    scan = request.param
    jm = jts if scan else jt
    jp = jm.init(jmc, jax.random.PRNGKey(0))
    jb, _ = _batch(jmc)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jmc, jb)))(jp)
    return scan, jp, interop.params_from_jax(_np_tree(jp)), loss, grads


def _port_loss_grads(tp, tmc, tb, scan, **kw):
    tm = tts if scan else tt
    return tsteps.value_and_grad(lambda p, b: tm.loss_fn(p, tmc, b, **kw),
                                 tp, tb)


def test_config_copy_matches_jax():
    for reduced in (False, True):
        j, t = jconfigs.get_config(ARCH), configs.get_config(ARCH)
        j, t = (j.reduced(), t.reduced()) if reduced else (j, t)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "tie_embeddings", "block_pattern",
                  "norm_eps", "rope_theta", "glu", "act", "norm"):
            assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("scan", [False, True])
def test_init_state_has_the_jax_tree(cfgs, scan):
    """Same paths, shapes and dtypes as JAX's init_train_state (adamw,
    rq4 + EF): 20 parameter leaves unrolled, 11 stacked."""
    jmc, tmc = cfgs
    kw = dict(grad_compression="rq4", error_feedback=True, scan_layers=scan)
    js = jsteps.init_train_state(jmc, jopt.adamw(1e-3), jax.random.PRNGKey(0),
                                 step_cfg=jsteps.TrainStepConfig(**kw))
    ts = tsteps.init_train_state(tmc, topt.adamw(1e-3), prng.PRNGKey(0),
                                 step_cfg=tsteps.TrainStepConfig(**kw),
                                 device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(js)
    tl = list(tnpz._with_paths(ts))
    assert [jnpz._path_str(p) for p, _ in jl] == [k for k, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype) == np.dtype(str(b.dtype).split(".")[1]) \
            or (a.dtype == jnp.uint32 and b.dtype == torch.int64)
    assert len(pytree.tree_leaves(ts["params"])) == (11 if scan else 20)
    np.testing.assert_array_equal(ts["rng"].numpy(), np.asarray(js["rng"]))


def test_loss_and_grads_allclose(model, cfgs):
    scan, _, tp, jloss, jgrads = model
    _, tb = _batch(cfgs[0])
    loss, grads = _port_loss_grads(tp, cfgs[1], tb, scan)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for g, w in zip(pytree.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GTOL)


def test_remat_leaves_loss_and_grads_unchanged(model, cfgs):
    scan, _, tp, _, _ = model
    _, tb = _batch(cfgs[0])
    loss0, g0 = _port_loss_grads(tp, cfgs[1], tb, scan)
    policies = [{"remat_policy": "full"}, {"remat_policy": "dots"}] \
        if scan else [{}]
    for kw in policies:
        loss, g = _port_loss_grads(tp, cfgs[1], tb, scan, remat=True, **kw)
        np.testing.assert_allclose(float(loss), float(loss0), rtol=0,
                                   atol=1e-7)
        for a, b in zip(pytree.tree_leaves(g), pytree.tree_leaves(g0)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-8)


def test_chunked_attention_matches_jax():
    """The q-chunked exact path (S >= 4096 in training) against JAX's,
    at a small chunk; and against the full-S^2 reference."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
               for _ in range(3))
    for causal, window, cap in ((True, 0, 0.0), (True, 5, 0.0),
                                (False, 0, 30.0)):
        want = jattn.chunked_sdpa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, softcap=cap, q_chunk=8)
        got = tattn.chunked_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window, softcap=cap, q_chunk=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        mask = tattn.make_mask(32, 32, causal=causal, window=window)[None]
        ref = tattn.sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), mask, softcap=cap)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    np.testing.assert_array_equal(
        tattn.make_mask(6, 9, causal=True, window=3, q_offset=2).numpy(),
        np.asarray(jattn.make_mask(6, 9, causal=True, window=3,
                                   q_offset=2)))


def test_use_flash_is_not_ported(model, cfgs):
    """Training on flash attention, which the reference cannot do (its
    Pallas kernel has no gradient), is the port's own: with
    ``use_flash=True`` under grad, the loss and gradients through the
    flash backward's plain version equal JAX's through its plain
    attention and the port's plain path, at the file's tolerances."""
    scan, _, tp, jloss, jgrads = model
    _, tb = _batch(cfgs[0])
    loss, grads = _port_loss_grads(tp, cfgs[1], tb, scan, use_flash=True)
    loss0, grads0 = _port_loss_grads(tp, cfgs[1], tb, scan)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(loss), float(loss0), **TOL)
    for g, g0, w in zip(pytree.tree_leaves(grads), pytree.tree_leaves(grads0),
                        jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GTOL)
        np.testing.assert_allclose(g.numpy(), g0.numpy(), **GTOL)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_flash_train_step_matches_the_plain_step(cfgs, remat):
    """Two SGD steps of reduced repro-100m (scanned, uncompressed: an
    rq4 code may flip, and Adam's normalised update may swing on an
    element whose gradient is ~0, where gradients differ by rounding)
    with ``use_flash=True`` against the same steps on the plain
    attention: losses at 1e-5, parameters after both steps at the
    gradients' tolerance."""
    tmc = cfgs[1]
    opt = topt.sgd(0.1)
    out = []
    for use_flash in (False, True):
        scfg = tsteps.TrainStepConfig(scan_layers=True, remat=remat,
                                      use_flash=use_flash)
        st = tsteps.init_train_state(tmc, opt, prng.PRNGKey(0),
                                     step_cfg=scfg, device="cpu")
        step = tsteps.make_train_step(tmc, opt, scfg)
        losses = []
        for i in range(2):
            _, tb = _batch(cfgs[0], s=32, seed=10 + i)
            st, m = step(st, tb)
            losses.append(float(m["loss"]))
        out.append((losses, st["params"]))
    (l0, p0), (l1, p1) = out
    np.testing.assert_allclose(l1, l0, **TOL)
    for a, b in zip(pytree.tree_leaves(p1), pytree.tree_leaves(p0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GTOL)


@pytest.mark.parametrize("name", ["adamw", "momentum", "sgd"])
def test_optimizer_updates_allclose(name):
    """Three updates from the same gradients, under the CLI's cosine
    schedule: updates, parameters and state allclose to JAX's."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": [(5,), (2, 2)]}
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": [rng.normal(size=s).astype(np.float32)
                    for s in shapes["b"]]}
    jo = jopt.make_optimizer(name, jopt.cosine_schedule(3e-2, warmup=2,
                                                        total=5))
    to = topt.make_optimizer(name, topt.cosine_schedule(3e-2, warmup=2,
                                                        total=5))
    jp, tp = params, interop.params_from_jax(params)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda p: np.random.default_rng(i).normal(size=p.shape).astype(
                np.float32), params)
        ju, js = jax.jit(jo.update)(g, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(interop.params_from_jax(g), ts, tp)
        for a, b in zip(pytree.tree_leaves(tu), jax.tree_util.tree_leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **UTOL)
        tp = topt.apply_updates(tp, tu)
    for a, b in zip(pytree.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **UTOL)
    for a, b in zip(pytree.tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **UTOL)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_cosine_schedule_and_clip_allclose():
    for kw in (dict(warmup=4, total=30), dict(warmup=50, total=200),
               dict(warmup=1, total=1)):
        j, t = jopt.cosine_schedule(3e-3, **kw), topt.cosine_schedule(3e-3,
                                                                      **kw)
        for s in (0, 1, 3, 4, 17, 29, 30, 250):
            np.testing.assert_allclose(
                float(t(torch.tensor(s, dtype=torch.int32))),
                float(j(jnp.int32(s))), rtol=1e-7, atol=0)
    g = {"x": np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32),
         "y": [np.full((3,), 2.0, np.float32)]}
    for max_norm in (1.0, 100.0):
        jg, jn = jopt.clip_by_global_norm(g, max_norm)
        tg, tn = topt.clip_by_global_norm(interop.params_from_jax(g),
                                          max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(pytree.tree_leaves(tg),
                        jax.tree_util.tree_leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **UTOL)


def _jax_state(jmc, scan, **kw):
    scfg = jsteps.TrainStepConfig(scan_layers=scan, **kw)
    return jsteps.init_train_state(jmc, jopt.sgd(0.1), jax.random.PRNGKey(3),
                                   step_cfg=scfg), scfg


@pytest.mark.parametrize("scan", [False, True])
def test_none_step_allclose(cfgs, scan):
    """One whole uncompressed SGD step: metrics and new parameters."""
    jmc, tmc = cfgs
    js, jscfg = _jax_state(jmc, scan)
    ts = interop.train_state_from_jax(_np_tree(js))
    jb, tb = _batch(jmc, seed=4)
    jnew, jm = jax.jit(jsteps.make_train_step(jmc, jopt.sgd(0.1), jscfg))(
        js, jb)
    tnew, tm = tsteps.make_train_step(
        tmc, topt.sgd(0.1), tsteps.TrainStepConfig(scan_layers=scan))(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert int(tm["step"]) == 0 and float(tm["comm_bytes"]) == 0.0
    assert int(tnew["step"]) == 1
    for a, b in zip(pytree.tree_leaves(tnew["params"]),
                    jax.tree_util.tree_leaves(jnew["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
def test_codec_stage_bit_exact_given_jax_grads(model, ef):
    """make_train_step's codec stage — flatten, + residual, flat_qdq
    under fold_in(rng, step), residual v - qflat — given JAX's
    gradients: qflat and ec_err equal JAX's bit for bit, for both
    trees; comm_bytes equal too."""
    _, _, _, _, jgrads = model
    jgrads, _ = jopt.clip_by_global_norm(jgrads, 1.0)
    total = jcomp.FlatLayout.from_tree(jgrads).total
    err = (np.random.default_rng(2).normal(size=total) * 1e-3).astype(
        np.float32) if ef else None
    jcodec, tcodec = jcomp.codec("rq4"), tcomp.codec("rq4")

    @jax.jit
    def jax_stage(grads, ec_err, rng, step):
        qkey = jax.random.fold_in(rng, step)
        layout = jcomp.FlatLayout.from_tree(grads)
        gflat = layout.flatten(grads)
        if ec_err is None:
            return layout.unflatten(jcodec.flat_qdq(gflat, qkey,
                                                    donate=True)), None
        v = gflat + ec_err
        qflat = jcodec.flat_qdq(v, qkey)
        return layout.unflatten(qflat), v - qflat

    jq, jerr = jax_stage(jgrads, None if err is None else jnp.asarray(err),
                         jax.random.PRNGKey(7), jnp.int32(5))
    tgrads = interop.params_from_jax(_np_tree(jgrads))
    tq, terr, comm = tsteps.compress_grads(
        tcodec, tgrads, prng.fold_in(prng.PRNGKey(7), 5),
        None if err is None else torch.from_numpy(err.copy()))
    for a, b in zip(pytree.tree_leaves(tq), jax.tree_util.tree_leaves(jq)):
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))
    if ef:
        np.testing.assert_array_equal(_u32(terr.numpy()), _u32(jerr))
    else:
        assert terr is None
    assert comm == jcodec.tree_wire_bytes_flat(jq)


def test_rq4_ef_step_metrics_match_jax(cfgs):
    """A whole rq4 + EF AdamW step from carried-over state: loss and
    grad norm allclose, comm_bytes equal, step and key advanced."""
    jmc, tmc = cfgs
    kw = dict(grad_compression="rq4", error_feedback=True)
    js = jsteps.init_train_state(jmc, jopt.adamw(1e-3), jax.random.PRNGKey(4),
                                 step_cfg=jsteps.TrainStepConfig(**kw))
    ts = interop.train_state_from_jax(_np_tree(js))
    jb, tb = _batch(jmc, seed=6)
    _, jm = jax.jit(jsteps.make_train_step(
        jmc, jopt.adamw(1e-3), jsteps.TrainStepConfig(**kw)))(js, jb)
    tnew, tm = tsteps.make_train_step(
        tmc, topt.adamw(1e-3), tsteps.TrainStepConfig(**kw))(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert float(tm["comm_bytes"]) == float(jm["comm_bytes"]) > 0
    assert int(tnew["step"]) == 1 and int(tnew["opt"]["step"]) == 1
    assert bool(tnew["ec_err"].abs().sum() > 0)


def test_none_codec_is_the_identity():
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    c = tcomp.codec("none")
    flat = torch.ones(5)
    assert c.flat_qdq(flat, None) is flat
    assert c.tree_wire_bytes_flat(tree) == jcomp.codec(
        "none").tree_wire_bytes_flat({"w": np.zeros((2, 3), np.float32)})


def _step_n(state, step_fn, data, n, start=0):
    for t in range(start, start + n):
        state, _ = step_fn(state, data.batch_at(t))
    return state


def _train_setup(cfgs, scan=False):
    from repro_torch.data.pipeline import SyntheticLM
    _, tmc = cfgs
    scfg = tsteps.TrainStepConfig(grad_compression="rq4",
                                  error_feedback=True, scan_layers=scan)
    opt = topt.adamw(topt.cosine_schedule(3e-3, warmup=2, total=4))
    return (tsteps.init_train_state(tmc, opt, prng.PRNGKey(1), step_cfg=scfg,
                                    device="cpu"),
            tsteps.make_train_step(tmc, opt, scfg),
            SyntheticLM(vocab=tmc.vocab, seq_len=17, batch=2, seed=1))


def test_resume_is_bit_exact(cfgs, tmp_path):
    """4 steps straight == 2 steps, save, load into a fresh state, 2
    more steps: every leaf of the state bit for bit."""
    s0, step_fn, data = _train_setup(cfgs)
    straight = _step_n(tsteps.state_to(s0, "cpu"), step_fn, data, 4)
    half = _step_n(s0, step_fn, data, 2)
    fname = tnpz.save_state(half, str(tmp_path), step=2)
    assert tnpz.latest_checkpoint(str(tmp_path)) == fname
    fresh, _, _ = _train_setup(cfgs)
    resumed = tnpz.load_state(fresh, fname)
    assert int(resumed["step"]) == 2
    resumed = _step_n(resumed, step_fn, data, 2, start=2)
    for a, b in zip(pytree.tree_leaves(straight), pytree.tree_leaves(resumed)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


@pytest.mark.parametrize("scan", [False, True])
def test_checkpoints_cross_load_both_ways(cfgs, tmp_path, scan):
    """A port checkpoint loads in JAX's load_state and a JAX checkpoint
    in the port's, leaf for leaf (rng as uint32[2], step as int32)."""
    jmc, tmc = cfgs
    kw = dict(grad_compression="rq4", error_feedback=True, scan_layers=scan)
    s, step_fn, data = _train_setup(cfgs, scan)
    s = _step_n(s, step_fn, data, 1)
    pfile = tnpz.save_state(s, str(tmp_path / "port"), step=1)
    js = jsteps.init_train_state(jmc, jopt.adamw(1e-3), jax.random.PRNGKey(9),
                                 step_cfg=jsteps.TrainStepConfig(**kw))
    back = jnpz.load_state(jax.eval_shape(lambda: js), pfile)
    assert back["rng"].dtype == jnp.uint32 and back["step"].dtype == jnp.int32
    for a, b in zip(jax.tree_util.tree_leaves(back), pytree.tree_leaves(s)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jfile = jnpz.save_state(js, str(tmp_path / "jax"), step=0)
    got = tnpz.load_state(s, jfile)
    want = interop.train_state_from_jax(_np_tree(js))
    assert got["rng"].dtype == torch.int64
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_flipped_stored_byte_raises(cfgs, tmp_path):
    s, _, _ = _train_setup(cfgs)
    fname = tnpz.save_state(s, str(tmp_path), step=0)
    with np.load(fname) as data:
        arrays = {k: data[k].copy() for k in data.files}
    key = "params/layers/1/mixer/q/w"
    arrays[key].view(np.uint8)[123] ^= 0x10
    bad = os.path.join(str(tmp_path), "step-00000001.npz")
    np.savez(bad, **arrays)
    with pytest.raises(tnpz.CheckpointCorruptionError, match=key):
        tnpz.load_state(s, bad)
    with open(bad, "r+b") as fh:
        fh.truncate(100)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        tnpz.load_state(s, bad)


def test_launch_train_main_runs_on_the_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--compression", "rq4", "--error-feedback",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    state = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert int(state["step"]) == 3
    assert out.count("[train] step") == 3 and "[train] done" in out
    assert tnpz.latest_checkpoint(str(tmp_path)).endswith("step-00000003.npz")
    state = tlaunch.main(argv[:4] + ["4"] + argv[5:])   # resumes at 3
    assert "resumed from" in capsys.readouterr().out
    assert int(state["step"]) == 4


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tlaunch.main(["--reduced", "--steps", "1"])


def test_init_train_state_defaults_to_cuda(cfgs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tsteps.init_train_state(cfgs[1], topt.sgd(0.1), prng.PRNGKey(0))
