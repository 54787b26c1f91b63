"""The port's dry run and its per-device cost counter.

* FLOPs against JAX: the counter's dot FLOPs (``hlo_analysis
  .analyze_step``) of reduced qwen1.5-0.5b (3 layers) equal JAX's
  ``analyze_hlo`` of the unsharded compiled step within 2 % (they agree
  exactly): the AdamW train step on 4 x 64 with remat off and on, the
  last-position prefill and a decode step; the port's scanned and
  unrolled trees count the same.
* A synthetic program on a fake (2, 2) mesh (the counterpart of JAX's
  ``test_synthetic_module_trips_and_costs``): a loop of 12 products
  whose partial sums are all-reduced, then a product all-gathered;
  every total exact in closed form.
* One dense block on a fake (2, 2) mesh: the FSDP weight gathers and the
  one row-parallel all-reduce in count and bytes, and the local FLOPs a
  quarter of the global.
* A reduced dry run (``run_one``) of each step kind on a fake mesh gives
  a whole record whose argument bytes equal the sum of the local shard
  sizes the specs give; ``main`` reports a failing combo as FAIL and
  exits 1.
* A decode step on a cache whose layer dim is sharded writes each
  updated layer back into its holder's shard.

The fake process group is global to a process: the module fixture makes
it and destroys it at teardown.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.data.pipeline import make_batch_shapes as jbatch_shapes
from repro.launch import hlo_analysis as jhlo
from repro.models import transformer_scan as jts
from repro.models.common import InputShape as JShape
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.dist import sharding
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.models import layers
from repro_torch.models import transformer as tt
from repro_torch.models.common import InputShape
from repro_torch.train import steps

SHAPES = {"train": InputShape("t", 64, 4, "train"),
          "prefill": InputShape("p", 64, 4, "prefill"),
          "decode": InputShape("d", 64, 4, "decode")}


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    yield
    sharding.set_activation_batch_axes(("data",))
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_flops():
    """JAX's analyze_hlo of the unsharded compiled steps."""
    cfg = jconfigs.get_config("qwen1.5-0.5b").reduced(n_layers=3)
    opt = jmake_optimizer("adamw", 1e-3)
    out = {}
    batch = jbatch_shapes(cfg, JShape("t", 64, 4, "train"),
                          dtype=jnp.float32)
    for remat in (False, True):
        scfg = jsteps.TrainStepConfig(remat=remat, scan_layers=True)
        state = jsteps.abstract_train_state(cfg, opt, step_cfg=scfg)
        fn = jsteps.make_train_step(cfg, opt, scfg)
        out[("train", remat)] = jhlo.analyze_hlo(
            jax.jit(fn).lower(state, batch).compile().as_text()).dot_flops
    params = jax.eval_shape(
        lambda k: jts.init(cfg, k, dtype=jnp.float32), jax.random.PRNGKey(0))
    pbatch = jbatch_shapes(cfg, JShape("p", 64, 4, "prefill"),
                           dtype=jnp.float32)
    prefill = jsteps.make_prefill_step(cfg, scan_layers=True,
                                       logits_positions="last")
    out["prefill"] = jhlo.analyze_hlo(jax.jit(prefill).lower(
        params, pbatch).compile().as_text()).dot_flops
    dstate = jax.eval_shape(
        lambda p: jts.init_decode_state(p, cfg, 4, 64, dtype=jnp.float32),
        params)
    serve = jsteps.make_serve_step(cfg, scan_layers=True)
    out["decode"] = jhlo.analyze_hlo(jax.jit(serve).lower(
        params, dstate, {"tokens": jax.ShapeDtypeStruct((4, 1), jnp.int32)}
    ).compile().as_text()).dot_flops
    return out


def _qwen3():
    return configs.get_config("qwen1.5-0.5b").reduced(n_layers=3)


def test_train_step_flops_equal_jax_scanned_and_unrolled(jax_flops):
    assert jax_flops[("train", False)] == 3_372_220_416
    for remat in (False, True):
        counts = {}
        for scan in (True, False):
            rec = dryrun.run_one(
                "qwen1.5-0.5b", "t", cfg=_qwen3(), shape=SHAPES["train"],
                mesh_shape=(1, 1), verbose=False,
                step_cfg=steps.TrainStepConfig(remat=remat,
                                               scan_layers=scan))
            counts[scan] = rec["dot_flops"]
        assert counts[True] == counts[False]
        assert counts[True] == pytest.approx(jax_flops[("train", remat)],
                                             rel=0.02)


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_serving_step_flops_equal_jax(jax_flops, kind):
    rec = dryrun.run_one("qwen1.5-0.5b", kind, cfg=_qwen3(),
                         shape=SHAPES[kind], mesh_shape=(1, 1),
                         verbose=False)
    assert rec["dot_flops"] == pytest.approx(jax_flops[kind], rel=0.02)


def _mesh22():
    return dryrun.make_mesh(mesh_shape=(2, 2))


def test_synthetic_program_totals_are_exact():
    import torch.distributed.tensor as dt
    mesh = _mesh22()
    rep, part = dt.Replicate(), dt.Partial()

    def program(x, w, w2):
        for _ in range(12):
            # a local (8, 16) @ (16, 16) product whose rows are summed
            # over 'model': 512 B all-reduced a trip
            y = dt.DTensor.from_local(x.to_local() @ w.to_local(), mesh,
                                      (dt.Shard(0), part), run_check=False)
            x = y.redistribute(mesh, (dt.Shard(0), rep))
        z = x @ w2                                  # (8, 16) @ (16, 32)
        return z.redistribute(mesh, (rep, rep))     # all-gather (16, 32)

    x, w, w2 = (sharding.distribute_leaf(
        torch.empty(shape, device="meta"), spec, mesh)
        for shape, spec in (((16, 16), ("data", None)), ((16, 16), ()),
                            ((16, 32), ())))
    costs = hlo_analysis.analyze_step(program, x, w, w2)
    assert costs.dot_flops == 2 * 8 * 16 * 16 * 12 + 2 * 8 * 32 * 16
    assert costs.collective_breakdown["all-reduce"] == 8 * 16 * 4 * 12
    assert costs.collective_breakdown["all-gather"] == 16 * 32 * 4
    assert costs.collective_bytes == 8 * 16 * 4 * 12 + 16 * 32 * 4
    assert dict(costs.collective_counts) == {"all-reduce": 12,
                                             "all-gather": 1}
    assert costs.loops == [] and costs.unknown_loops == 0
    assert tuple(costs.output.shape) == (16, 32)


def test_one_dense_block_collectives_and_local_flops():
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = _mesh22()
    cfg = configs.get_config("qwen1.5-0.5b").reduced()
    d, ff, hd, h, hkv = (cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_heads,
                         cfg.n_kv_heads)
    b, s = 8, 64
    p = tt._block_init(layers.MetaGenerator(), cfg, "attn", 0)
    p = sharding.distribute(p, mesh, lambda path, leaf: sharding.param_spec(
        ("layers", 0) + path, tuple(leaf.shape), mesh))
    x = sharding.distribute_leaf(torch.empty(b, s, d, device="meta"),
                                 ("data", None, None), mesh)
    pos = torch.arange(s, device="meta")[None].expand(b, s)
    with implicit_replication():
        costs = hlo_analysis.analyze_step(
            lambda p_, x_: tt.block_apply(sharding.unshard_tree(p_), cfg,
                                          "attn", 0, x_, pos)[0], p, x)
    # FSDP: each weight gathered over 'data' with its 'model' half kept
    gathered = (d * h * hd + 2 * d * hkv * hd + h * hd * d) // 2 \
        + 3 * d * ff // 2
    assert costs.collective_breakdown["all-gather"] == 4 * gathered
    assert costs.collective_counts["all-gather"] == 7
    # one all-reduce: the attention's row-parallel output into the batch
    # placement of the residual stream (the block's own output is pinned
    # by its caller)
    assert costs.collective_breakdown["all-reduce"] == 4 * (b // 2) * s * d
    assert costs.collective_counts["all-reduce"] == 1
    t = b * s
    glob = (2 * t * d * (h * hd + 2 * hkv * hd) + 2 * t * h * hd * d
            + 3 * 2 * t * d * ff + 2 * 2 * b * h * s * s * hd)
    assert costs.dot_flops == glob / 4


def _closed_form_argument_bytes(spec, mesh) -> int:
    """The local shard bytes of every device input, from the specs."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def local(leaf, sp):
        n = leaf.numel()
        for e in sp:
            for name in (e if isinstance(e, tuple) else (e,)):
                if name is not None:
                    n //= sizes[name]
        return n * leaf.element_size()

    total = 0
    if "state" in spec:
        for path, leaf in pytree.tree_flatten_with_path(spec["state"])[0]:
            if path[0] in ("step", "rng") or path[-1] == "step":
                continue
            total += local(leaf, dryrun._state_spec(path, leaf, mesh))
    else:
        for path, leaf in pytree.tree_flatten_with_path(spec["params"])[0]:
            total += local(leaf, sharding.param_spec(path, tuple(leaf.shape),
                                                     mesh))
        for path, leaf in pytree.tree_flatten_with_path(
                spec.get("decode_state", {}))[0]:
            if isinstance(leaf, torch.Tensor):
                total += local(leaf, sharding.cache_spec(
                    path, tuple(leaf.shape), mesh))
    for leaf in pytree.tree_leaves(spec["batch"]):
        total += local(leaf, sharding.batch_spec(tuple(leaf.shape), mesh))
    return total


RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "params",
               "active_params", "dot_flops", "collectives",
               "argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes", "lower_s",
               "compile_s", "flops_body_once",
               "generated_code_size_in_bytes"}


@pytest.mark.parametrize("arch,kind", [("qwen1.5-0.5b", k) for k in SHAPES]
                         + [("deepseek-v2-lite-16b", "decode")])
def test_reduced_dry_run_record_and_argument_bytes(arch, kind):
    cfg = configs.get_config(arch).reduced()
    rec = dryrun.run_one(arch, kind, cfg=cfg, shape=SHAPES[kind],
                         mesh_shape=(2, 2), verbose=False)
    assert RECORD_KEYS <= set(rec)
    assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
    assert rec["compile_s"] is None and rec["flops_body_once"] is None
    assert rec["dot_flops"] > 0 and rec["temp_size_in_bytes"] > 0
    assert rec["collectives"]["total"] == sum(
        rec["collectives"]["collective_breakdown"].values())
    mesh = dryrun.make_mesh(mesh_shape=(2, 2))
    spec = dryrun.input_specs(arch, kind, cfg=cfg, shape=SHAPES[kind])
    assert rec["argument_size_in_bytes"] == \
        _closed_form_argument_bytes(spec, mesh)
    if kind != "prefill":       # the state and the cache are donated
        assert 0 < rec["alias_size_in_bytes"] <= rec["output_size_in_bytes"]


def test_decode_step_writes_back_a_layer_sharded_cache():
    """On a fake (2, 2) mesh the stacked cache of reduced qwen1.5-0.5b
    (2 layers) shards its layer dim over 'data', so ``take_layer`` hands
    each block a copy; after a decode step the layers this device holds
    have their cursor moved and their slot written, in the input's own
    storage. Real CPU shards: the fake collectives move no data, so only
    what the holder writes of its own layers is checked."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer_scan as ts
    from torch.distributed.tensor.experimental import implicit_replication
    dryrun.init_fake_world(4)
    mesh = mesh_lib._mesh("cpu", (2, 2), ("data", "model"))
    cfg = configs.get_config("qwen1.5-0.5b").reduced()
    params = ts.init(cfg, torch.Generator().manual_seed(0),
                     dtype=torch.float32)
    state = dryrun.place_cache(
        ts.init_decode_state(params, cfg, 4, 16, dtype=torch.float32), mesh)
    params = dryrun.place_params(params, mesh)
    cache = state["scan"][0]
    assert tuple(cache["cursor"].placements)[0].is_shard(0)
    storages = {k: v.to_local().untyped_storage().data_ptr()
                for k, v in cache.items() if sharding.is_dtensor(v)}
    tokens = dryrun.place_batch({"tokens": torch.zeros(4, 1,
                                                       dtype=torch.long)},
                                mesh)
    with implicit_replication():
        _, out = ts.decode_step(params, cfg, tokens, state)
    got = out["scan"][0]
    assert {k: got[k].to_local().untyped_storage().data_ptr()
            for k in storages} == storages
    assert torch.equal(got["cursor"].to_local(),
                       torch.ones_like(got["cursor"].to_local()))
    spos = got["slot_pos"].to_local()
    assert (spos[:, :, 0] == 0).all() and (spos[:, :, 1:] == -1).all()


def test_placements_of_a_multi_pod_spec():
    import torch.distributed.tensor as dt
    dryrun.init_fake_world(8)
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib._mesh("cuda", (2, 2, 2), ("pod", "data", "model"))
    spec = (None, ("pod", "data"), "model")
    assert sharding.placements(spec, mesh) == (dt.Shard(1), dt.Shard(1),
                                               dt.Shard(2))
    leaf = sharding.distribute_leaf(
        torch.empty(3, 8, 6, device="meta"), spec, mesh)
    assert tuple(leaf.to_local().shape) == (3, 2, 3)
    assert sharding.local_shape((3, 8, 6), spec, mesh) == (3, 2, 3)


def test_tree_shardings_are_the_placements_the_dry_run_lays_out():
    """``_state_shardings`` / ``params_shardings`` / ``cache_shardings`` /
    ``batch_shardings`` give, leaf for leaf, the placements of the
    DTensors the dry run builds on a fake (2, 2) mesh."""
    mesh = _mesh22()
    cfg = configs.get_config("qwen1.5-0.5b").reduced()
    for kind in ("train", "decode"):
        spec = dryrun.input_specs("qwen1.5-0.5b", kind, cfg=cfg,
                                  shape=SHAPES[kind])
        if kind == "train":
            pairs = [(dryrun._state_shardings(spec["state"], mesh),
                      dryrun.place_state(spec["state"], mesh))]
        else:
            pairs = [(sharding.params_shardings(spec["params"], mesh),
                      dryrun.place_params(spec["params"], mesh)),
                     (sharding.cache_shardings(spec["decode_state"], mesh),
                      dryrun.place_cache(spec["decode_state"], mesh))]
        pairs.append((sharding.batch_shardings(spec["batch"], mesh),
                      dryrun.place_batch(spec["batch"], mesh)))
        for want, placed in pairs:
            n = 0
            for path, leaf in pytree.tree_flatten_with_path(placed)[0]:
                if not sharding.is_dtensor(leaf):
                    continue
                pl = want
                for key in path:        # a placement tuple is a leaf here
                    pl = pl[key]
                assert tuple(leaf.placements) == pl, path
                n += 1
            assert n > 0


def test_main_reports_a_failing_combo_and_exits_1(monkeypatch, capsys):
    def boom(*a, **k):
        raise ValueError("no rule")
    monkeypatch.setattr(dryrun, "run_one", boom)
    monkeypatch.setattr(dryrun, "_assert_no_jax", lambda: None)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL qwen1.5-0.5b x train_4k" in out and "0 OK, 1 failed" in out
