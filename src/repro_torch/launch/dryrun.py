"""Production-mesh dry run: what each device holds, computes and sends.

The port of ``repro.launch.dryrun``. For every (architecture x input
shape) combination it builds the real step function (``make_train_step``,
``make_prefill_step`` or ``make_serve_step``) and its inputs as ``meta``
tensors (nothing is allocated), lays them out as DTensors on the
production mesh by the sharding rules (``dist.sharding``), and runs the
step once under the per-device counter (``launch.hlo_analysis``). The
mesh lives on the ``fake`` process-group backend at world 256 or 512, so
one CPU process plays rank 0 of the whole mesh: the collectives do not
move data, and every count is rank 0's.

JAX lowers and compiles; the port traces by running. A record keeps the
JAX package's names where they mean the same thing:

  * ``argument_size_in_bytes``: the local shard bytes of every input on
    the device (the host leaves ``step`` and ``rng`` stay on the host and
    are not counted);
  * ``output_size_in_bytes``: the local bytes of the outputs;
  * ``alias_size_in_bytes``: the outputs that are the inputs' own storage
    (the donated state, updated in place);
  * ``temp_size_in_bytes``: the peak of the step's own live allocations,
    beyond the arguments;
  * ``dot_flops``, ``collectives``: per device (``hlo_analysis``);
  * ``lower_s``: the time of the counted run (the trace).

XLA-only fields (``flops_body_once``, ``compile_s``,
``generated_code_size_in_bytes``, ...) are ``null``. On a one-device
mesh (``--mesh 1x1``) every placement is the whole tensor: the inputs
stay plain ``meta`` tensors and the step runs the one-card code, which is
how the estimate is held against a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all] [--out F]
      [--combo ARCH:SHAPE[:multi-pod] ...] [--mesh 1x1] [--batch B]
      [--seq S]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Optional

import torch

from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.data.pipeline import make_batch_shapes
from repro_torch.dist import sharding
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers, transformer_scan
from repro_torch.models.common import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.optim import make_optimizer
from repro_torch.train import steps

_HOST_LEAVES = steps._HOST_LEAVES

_NULL_FIELDS = ("flops_body_once", "bytes_accessed_body_once",
                "transcendentals", "generated_code_size_in_bytes",
                "compile_s")


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------


def init_fake_world(world_size: int) -> None:
    """The default process group on the ``fake`` backend (one process is
    rank 0 of ``world_size``); a group of another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(*, multi_pod: bool = False,
              mesh_shape: Optional[tuple] = None):
    """The production mesh, or a ('data', 'model') mesh of
    ``mesh_shape``; its fake world first."""
    if mesh_shape is None:
        init_fake_world(512 if multi_pod else 256)
        return mesh_lib.make_production_mesh(multi_pod=multi_pod)
    n = 1
    for d in mesh_shape:
        n *= d
    init_fake_world(n)
    return mesh_lib._mesh("cuda", tuple(mesh_shape), ("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------


def _serve_window(cfg: ModelConfig, shape: InputShape) -> int:
    """Sliding window used for attn-block KV caches at this shape:
    long_500k needs sub-quadratic state, so the dense / moe / vlm / audio
    archs use their ``sliding_window_decode``."""
    if shape.name == "long_500k":
        return cfg.sliding_window_decode
    return 0


def default_train_cfg(cfg: ModelConfig) -> steps.TrainStepConfig:
    return steps.TrainStepConfig(remat=True, grad_clip=1.0,
                                 param_dtype=torch.bfloat16, scan_layers=True)


def default_moment_dtype(cfg: ModelConfig):
    # grok's 314B needs bf16 Adam moments to fit a device's share
    big = cfg.param_count() > 80e9
    return torch.bfloat16 if big else torch.float32


def input_specs(arch: str, shape_name: str, *, optimizer: str = "adamw",
                moment_dtype=None,
                step_cfg: Optional[steps.TrainStepConfig] = None,
                cfg: Optional[ModelConfig] = None,
                shape: Optional[InputShape] = None) -> dict[str, Any]:
    """``meta`` stand-ins for every input of the step function (``cfg``
    and ``shape`` override the registry's, for reduced runs)."""
    cfg = cfg or configs.get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    out: dict[str, Any] = {"cfg": cfg, "shape": shape}
    out["batch"] = make_batch_shapes(cfg, shape, dtype=torch.bfloat16)
    if shape.kind == "train":
        scfg = step_cfg or default_train_cfg(cfg)
        opt = make_optimizer(optimizer, 3e-4,
                             moment_dtype=moment_dtype
                             or default_moment_dtype(cfg)) \
            if optimizer != "sgd" else make_optimizer("sgd", 3e-4)
        out["state"] = steps.abstract_train_state(cfg, opt, step_cfg=scfg)
        out["step_cfg"] = scfg
        out["optimizer"] = opt
        return out
    params = transformer_scan.init(cfg, layers.MetaGenerator(),
                                   dtype=torch.bfloat16)
    out["params"] = params
    if shape.kind == "decode":
        mem = None
        if cfg.is_encdec:
            mem = torch.empty((shape.global_batch, shape.seq_len,
                               cfg.d_model), dtype=torch.bfloat16,
                              device="meta")
        out["decode_state"] = transformer_scan.init_decode_state(
            params, cfg, shape.global_batch, shape.seq_len,
            window=_serve_window(cfg, shape), dtype=torch.bfloat16,
            memory=mem)
    return out


# --------------------------------------------------------------------------
# laying the inputs out on the mesh
# --------------------------------------------------------------------------


def _state_spec(path, leaf, mesh) -> tuple:
    """Train-state rule: params / moments by the param rules; the flat
    ec_err residual FSDP-shards over the data axes; the rest
    replicated."""
    names = sharding._path_names(path)
    shape = tuple(leaf.shape)
    if names and names[0] == "ec_err":
        return (sharding._maybe(sharding._ACT_BATCH_AXES, shape[0], mesh),)
    if names and names[0] == "params":
        return sharding.param_spec(path[1:], shape, mesh)
    if names and names[0] == "opt" and len(names) > 1 \
            and names[1] in ("m", "v"):
        return sharding.param_spec(path[2:], shape, mesh)
    return ()


def _state_shardings(state, mesh):
    """The train state's placements, leaf for leaf (JAX's
    ``_state_shardings``)."""
    return pytree.tree_map_with_path(
        lambda p, leaf: sharding.placements(_state_spec(p, leaf, mesh),
                                            mesh), state)


def _place(leaf, spec: tuple, mesh):
    """A meta leaf laid out by ``spec``; a plain meta tensor on a
    one-device mesh; non-tensor leaves as they are."""
    if not isinstance(leaf, torch.Tensor) or mesh.size() == 1:
        return leaf
    return sharding.distribute_leaf(leaf, spec, mesh)


def place_state(state, mesh):
    """The train state on the mesh; ``step``, ``rng`` and the optimizer's
    ``step`` become host zeros, as the port keeps them."""
    def one(path, leaf):
        names = sharding._path_names(path)
        if names[0] in _HOST_LEAVES or names[-1] == "step":
            return torch.zeros(leaf.shape, dtype=leaf.dtype)
        return _place(leaf, _state_spec(path, leaf, mesh), mesh)
    return pytree.tree_map_with_path(one, state)


def place_params(params, mesh):
    return pytree.tree_map_with_path(
        lambda p, leaf: _place(leaf, sharding.param_spec(
            p, tuple(leaf.shape), mesh), mesh), params)


def place_cache(state, mesh):
    return pytree.tree_map_with_path(
        lambda p, leaf: _place(leaf, sharding.cache_spec(
            p, tuple(getattr(leaf, "shape", ())), mesh), mesh), state)


def place_batch(batch, mesh):
    return pytree.tree_map(
        lambda leaf: _place(leaf, sharding.batch_spec(tuple(leaf.shape),
                                                      mesh), mesh), batch)


# --------------------------------------------------------------------------
# tracing one combo
# --------------------------------------------------------------------------


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                mesh_shape: Optional[tuple] = None, optimizer: str = "adamw",
                step_cfg: Optional[steps.TrainStepConfig] = None,
                cfg: Optional[ModelConfig] = None,
                shape: Optional[InputShape] = None):
    """-> (step fn, its laid-out args, specs, mesh). JAX lowers here; the
    port builds what ``run_one`` runs."""
    spec = input_specs(arch, shape_name, optimizer=optimizer,
                       step_cfg=step_cfg, cfg=cfg, shape=shape)
    cfg, shape = spec["cfg"], spec["shape"]
    mesh = make_mesh(multi_pod=multi_pod, mesh_shape=mesh_shape)
    sharding.set_activation_batch_axes(
        ("pod", "data") if multi_pod else ("data",))
    batch = place_batch(spec["batch"], mesh)
    if shape.kind == "train":
        fn = steps.make_train_step(cfg, spec["optimizer"], spec["step_cfg"])
        args = (place_state(spec["state"], mesh), batch)
    elif shape.kind == "decode":
        fn = steps.make_serve_step(cfg, scan_layers=True)
        args = (place_params(spec["params"], mesh),
                place_cache(spec["decode_state"], mesh), batch)
    else:
        fn = steps.make_prefill_step(cfg, scan_layers=True,
                                     logits_positions="last")
        args = (place_params(spec["params"], mesh), batch)
    if multi_pod and shape.kind != "decode":
        fn = _on_folded_mesh(fn, mesh)
    return fn, args, spec, mesh


def _on_folded_mesh(fn, mesh):
    """``fn`` run on the multi-pod mesh's ('pod', 'data') axes folded into
    one 'dp' axis of 32 over the same ranks (pod-major, as the nested
    shards are). DTensor plans each re-sharding of a dim split over two
    mesh axes by a search over placements, which makes a multi-pod train
    step take most of an hour to trace; on the folded mesh it takes what
    the 16 x 16 one does. A leaf sharded alike over both axes keeps its
    shards; one sharded over 'data' only (an unstacked weight, FSDP on
    the bare 'data' axis) is first gathered over 'data', which the step's
    unshard would do anyway, and that all-gather is counted. A train
    step's new state comes back in its input's layout, as JAX's
    ``out_shardings`` put it (the leaves updated in place are the inputs
    themselves)."""
    import torch.distributed.tensor as dt
    from torch.distributed.device_mesh import DeviceMesh
    folded = DeviceMesh(mesh.device_type,
                        torch.arange(mesh.size()).reshape(-1, mesh.shape[-1]),
                        mesh_dim_names=("dp", "model"))

    def fold(leaf):
        if not sharding.is_dtensor(leaf):
            return leaf
        pod, data, model = leaf.placements
        if pod != data:
            leaf = leaf.redistribute(mesh, (pod if pod == dt.Replicate()
                                            else dt.Replicate(),
                                            dt.Replicate(), model))
            pod = data = dt.Replicate()
        return dt.DTensor.from_local(leaf.to_local(), folded, (data, model),
                                     run_check=False, shape=leaf.shape,
                                     stride=leaf.stride())

    def unfold(orig, new):
        """A new state leaf in its input's layout on the multi-pod mesh
        (the input itself where the step updated it in place)."""
        if not sharding.is_dtensor(orig):
            return new
        if new.to_local().untyped_storage() is \
                orig.to_local().untyped_storage():
            return orig
        dp, model = new.placements
        back = dt.DTensor.from_local(new.to_local(), mesh, (dp, dp, model),
                                     run_check=False, shape=new.shape,
                                     stride=new.stride())
        return back.redistribute(mesh, orig.placements)

    def run(*args):
        folded_args = pytree.tree_map(fold, args)
        axes = sharding._ACT_BATCH_AXES
        sharding.set_activation_batch_axes(("dp",))
        try:
            out = fn(*folded_args)
        finally:
            sharding.set_activation_batch_axes(axes)
        if isinstance(out, tuple) and isinstance(out[0], dict):
            out = (pytree.tree_map(unfold, args[0], out[0]),) + out[1:]
        return out

    return run


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if sharding.is_dtensor(t) else t


def _device_storages(tree) -> dict:
    """{storage id: bytes} of the device tensors of ``tree`` (a DTensor's
    local shard, a meta tensor; host tensors are not on the device)."""
    out = {}
    for leaf in pytree.tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        t = _local(leaf)
        if t.device.type == "cpu":
            continue
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def analyze(fn, args) -> dict[str, Any]:
    """Run the step once under the counter -> the record's costs and
    sizes."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_st = _device_storages(args)
    t0 = time.time()
    with implicit_replication():
        costs = hlo_analysis.analyze_step(fn, *args)
    t_run = time.time() - t0
    out_st = _device_storages(costs.output)
    rec: dict[str, Any] = {k: None for k in _NULL_FIELDS}
    rec.update({
        "argument_size_in_bytes": sum(arg_st.values()),
        "output_size_in_bytes": sum(out_st.values()),
        "alias_size_in_bytes": sum(n for k, n in out_st.items()
                                   if k in arg_st),
        "temp_size_in_bytes": costs.temp_bytes,
        "dot_flops": costs.dot_flops,
        "collectives": dict(costs.as_dict(),
                            total=costs.collective_bytes),
        "lower_s": round(t_run, 3),
    })
    return rec


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mesh_shape: Optional[tuple] = None, optimizer: str = "adamw",
            step_cfg: Optional[steps.TrainStepConfig] = None,
            cfg: Optional[ModelConfig] = None,
            shape: Optional[InputShape] = None,
            verbose: bool = True) -> dict[str, Any]:
    fn, args, spec, mesh = lower_combo(
        arch, shape_name, multi_pod=multi_pod, mesh_shape=mesh_shape,
        optimizer=optimizer, step_cfg=step_cfg, cfg=cfg, shape=shape)
    rec = analyze(fn, args)
    cfg = spec["cfg"]
    rec.update({
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "n_devices": int(mesh.size()),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    })
    if verbose:
        c = rec["collectives"]["collective_breakdown"]
        print(f"[dryrun] {arch} x {shape_name} mesh={rec['mesh']} "
              f"dot_flops={rec['dot_flops']:.4e} "
              f"coll={rec['collectives']['total']:.4e}B "
              f"(ag {c['all-gather']:.3e} ar {c['all-reduce']:.3e} "
              f"rs {c['reduce-scatter']:.3e} a2a {c['all-to-all']:.3e}) "
              f"args={rec['argument_size_in_bytes']} "
              f"temp={rec['temp_size_in_bytes']} "
              f"out={rec['output_size_in_bytes']} "
              f"alias={rec['alias_size_in_bytes']} "
              f"(trace {rec['lower_s']:.1f}s)")
        sys.stdout.flush()
    return rec


def run_on_card(arch: str, shape_name: str, *,
                shape: Optional[InputShape] = None) -> dict[str, Any]:
    """The train combo run for real on one card, measured as the
    one-device dry-run record is: the storage bytes of the state and
    batch placed on the card (the host leaves aside), their count, and
    the allocator's growth while they are placed (its allocated block
    bytes, and the bytes requested of it); the peak the step
    allocates beyond what is live when it starts (after a warm-up step);
    its dot FLOPs (the same counter, around that step); and the median
    CUDA-event time of three more steps. The weights are drawn from
    seed 0, the batch from seed 1."""
    import gc
    from repro_torch.core import prng
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.device import resolve_device
    dev = resolve_device(None)
    cfg = configs.get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    if shape.kind != "train":
        raise ValueError(f"run_on_card takes a train shape, got {shape}")
    scfg = default_train_cfg(cfg)
    opt = make_optimizer("adamw", 3e-4,
                         moment_dtype=default_moment_dtype(cfg))
    step = steps.make_train_step(cfg, opt, scfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)

    def requested() -> int:
        return torch.cuda.memory_stats(dev).get("requested_bytes.all.current",
                                                0)

    m0, r0 = torch.cuda.memory_allocated(dev), requested()
    state = steps.init_train_state(cfg, opt, prng.PRNGKey(0),
                                   step_cfg=scfg, device=dev)
    batch = synthetic_batch(cfg, shape, prng.PRNGKey(1), device=dev)
    torch.cuda.synchronize(dev)
    grown = torch.cuda.memory_allocated(dev) - m0
    asked = requested() - r0
    placed = _device_storages((state, batch))
    state, _ = step(state, batch)                 # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    costs = hlo_analysis.analyze_step(step, state, batch)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    state = costs.output[0]
    costs.output = None
    times = []
    for _ in range(3):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        state, m = step(state, batch)
        t1.record()
        torch.cuda.synchronize(dev)
        times.append(t0.elapsed_time(t1))
    ms = sorted(times)[len(times) // 2]
    if not torch.isfinite(m["loss"]).item():
        raise AssertionError(f"{arch}: non-finite loss on the card")
    return {"arch": arch, "shape": shape_name,
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "placed_bytes": sum(placed.values()), "n_tensors": len(placed),
            "allocated_growth": grown, "requested_growth": asked,
            "peak_beyond_live": peak,
            "tracked_temp": costs.temp_bytes, "dot_flops": costs.dot_flops,
            "step_ms": ms, "tflops": costs.dot_flops / (ms * 1e-3) / 1e12,
            "loss": float(m["loss"])}


def _assert_no_jax() -> None:
    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.")]
    if bad:
        raise RuntimeError(f"the dry run imported {sorted(bad)[:5]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x all shapes")
    ap.add_argument("--mesh", default=None,
                    help="a DATAxMODEL mesh instead of the production one "
                         "(1x1: the one-card estimate)")
    ap.add_argument("--combo", action="append", default=[],
                    help="ARCH:SHAPE[:multi-pod] (repeatable), instead of "
                         "--arch x --shape")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="override the shape's sequence length")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.combo:
        combos = [(c.split(":")[0], c.split(":")[1],
                   c.split(":")[2:] == ["multi-pod"]) for c in args.combo]
    else:
        archs = list(configs.ASSIGNED) if (args.all or not args.arch) \
            else [args.arch]
        shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
            else [args.shape]
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    mesh_shape = tuple(int(n) for n in args.mesh.split("x")) \
        if args.mesh else None

    records = []
    failures = []
    for a, s, mp in combos:
        try:
            shape = INPUT_SHAPES[s]
            if args.batch or args.seq:
                shape = InputShape(s, args.seq or shape.seq_len,
                                   args.batch or shape.global_batch,
                                   shape.kind)
            rec = run_one(a, s, multi_pod=mp, mesh_shape=mesh_shape,
                          shape=shape)
            rec["global_batch"], rec["seq_len"] = (shape.global_batch,
                                                   shape.seq_len)
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except Exception as e:  # noqa: BLE001 — report, keep going
            failures.append((a, s, mp, repr(e)))
            print(f"[dryrun] FAIL {a} x {s} multi_pod={mp}: {e!r}")
            sys.stdout.flush()
    _assert_no_jax()
    print(f"[dryrun] {len(records)} OK, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("  FAIL:", f_)
        sys.exit(1)


if __name__ == "__main__":
    main()
