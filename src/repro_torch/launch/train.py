"""Training launcher of the port: one card, or one rank a card.

Takes every flag of ``repro.launch.train`` and adds ``--device`` (``cuda``
unless ``--device cpu`` is given; without a card it raises):

  PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \\
      --steps 200 --batch 8 --seq 256 \\
      [--compression rq4] [--error-feedback] [--reduced] \\
      [--ckpt-dir DIR] [--scan-layers] [--remat] [--device cpu]

On several cards of a host it runs one rank a card, as JAX's launcher
runs on every device of the host:

  PYTHONPATH=src torchrun --standalone --nproc-per-node N \\
      -m repro_torch.launch.train --arch repro-100m \\
      --compression rq4 --error-feedback

It joins the caller's default process group when there is one, else
makes one from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on cards, gloo
with ``--device cpu``. Each rank runs on ``cuda:LOCAL_RANK`` (or
``--device``), over JAX's ``(n, 1)`` ``('data', 'model')`` mesh: the
state is replicated, the global batch ``batch_at(t)`` is split over
'data' by the batch rule, and the loss and gradient are averaged over
'data' before the clip and the codec (``train.steps``). With no group
and no torchrun environment it is the one-card launcher.

Rank 0 prints the JAX launcher's ``[train] ... devices=N ...`` and
``[train] step ... loss ... gnorm ... tok/s`` lines (tokens of the
global batch), and writes the JAX package's ``.npz`` checkpoints behind
a barrier; every rank resumes from them.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import latest_checkpoint, load_state, save_state
from repro_torch.core import compression, prng
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.train import steps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "momentum", "sgd"])
    ap.add_argument("--compression", default="none")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-scale variant of the arch")
    ap.add_argument("--scan-layers", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; cuda:LOCAL_RANK on a rank) "
                         "or cpu")
    return ap.parse_args(argv)


def rank_device(device, local_rank: int):
    """The device a rank asks for: ``--device`` when given, else
    ``cuda:LOCAL_RANK``."""
    return device if device is not None else f"cuda:{local_rank}"


def _join_group(args) -> tuple:
    """(device, made): join the default process group (made False), or
    make one from torchrun's environment (made True; NCCL on cards,
    gloo on the CPU); (the device, None) when there is neither. A failed
    init raises."""
    import torch.distributed as dist
    joined = dist.is_available() and dist.is_initialized()
    if not joined and not ("RANK" in os.environ
                           and "WORLD_SIZE" in os.environ):
        return resolve_device(args.device), None
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() if joined
                               else os.environ["RANK"]))
    device = resolve_device(rank_device(args.device, local))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not joined:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://")
    return device, not joined


def setup(args: argparse.Namespace) -> dict:
    """What ``main`` trains with: the model config, the train state (on
    the device, resumed from ``--ckpt-dir`` when it holds a checkpoint),
    the step function, the data, and the process group and mesh when
    ranks run (else None)."""
    device, made = _join_group(args)
    mesh = group = None
    rank, world = 0, 1
    if made is not None:
        import torch.distributed as dist
        group = dist.group.WORLD
        rank, world = dist.get_rank(), dist.get_world_size()
        want = int(os.environ.get("WORLD_SIZE", world))
        # JAX's launcher: an (n_dev, 1) ('data', 'model') mesh
        mesh = mesh_lib._mesh(device.type, (world, 1), ("data", "model"))
        sharding.set_activation_batch_axes(("data",))
        if want != world or mesh.size() != world:
            raise RuntimeError(f"rank {rank}: joined a world of {world}, "
                               f"WORLD_SIZE {want}, mesh of {mesh.size()}")
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lr = cosine_schedule(args.lr, warmup=min(50, args.steps // 10 + 1),
                         total=args.steps)
    opt = make_optimizer(args.optimizer, lr)
    scfg = steps.TrainStepConfig(
        remat=args.remat, grad_compression=args.compression,
        error_feedback=args.error_feedback, scan_layers=args.scan_layers)
    state = steps.init_train_state(cfg, opt, prng.PRNGKey(args.seed),
                                   step_cfg=scfg, device=device)
    start = 0
    if args.ckpt_dir:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            state = load_state(state, ck)
            start = int(state["step"])
            if rank == 0:
                print(f"[train] resumed from {ck} at step {start}")
    return {"cfg": cfg, "device": device, "state": state, "start": start,
            "train_step": steps.make_train_step(cfg, opt, scfg, mesh=mesh),
            "data": SyntheticLM(vocab=cfg.vocab, seq_len=args.seq + 1,
                                batch=args.batch, seed=args.seed),
            "group": group, "made_group": bool(made), "mesh": mesh,
            "rank": rank, "world": world}


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def run_steps(args: argparse.Namespace, run: dict):
    """Steps ``run["start"]`` .. ``args.steps - 1`` on the global batches
    ``batch_at(t)``: yields (t, metrics) after each, with ``run["state"]``
    the state after it; writes the ``--ckpt-every`` checkpoints."""
    state, train_step, data = run["state"], run["train_step"], run["data"]
    for t in range(run["start"], args.steps):
        state, metrics = train_step(state, to_device(data.batch_at(t),
                                                     run["device"]))
        run["state"] = state
        if args.ckpt_dir and (t + 1) % args.ckpt_every == 0:
            save_state(state, args.ckpt_dir, step=t + 1, group=run["group"])
        yield t, metrics


def main(argv=None):
    args = parse_args(argv)
    run = setup(args)
    lead = run["rank"] == 0
    try:
        cfg, device = run["cfg"], run["device"]
        n_params = compression.FlatLayout.from_tree(
            run["state"]["params"]).total
        if lead:
            print(f"[train] arch={cfg.arch_id} params~{n_params / 1e6:.1f}M "
                  f"devices={run['world']} device={device} "
                  f"batch={args.batch} seq={args.seq}")
        start = run["start"]
        t0 = time.time()
        for t, metrics in run_steps(args, run):
            if lead and (t % args.log_every == 0 or t == args.steps - 1):
                loss = float(metrics["loss"])
                dt = time.time() - t0
                tput = args.batch * args.seq * (t - start + 1) / max(dt,
                                                                     1e-9)
                print(f"[train] step {t:5d} loss {loss:7.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"tok/s {tput:9.0f}")
        if args.ckpt_dir:
            save_state(run["state"], args.ckpt_dir, step=args.steps,
                       group=run["group"])
        if lead:
            print("[train] done")
    finally:
        if run["made_group"]:
            import torch.distributed as dist
            dist.destroy_process_group()
    return run["state"]


if __name__ == "__main__":
    main()
