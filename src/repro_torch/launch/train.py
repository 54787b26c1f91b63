"""Training launcher of the port: one card, no mesh.

Takes every flag of ``repro.launch.train`` and adds ``--device`` (``cuda``
unless ``--device cpu`` is given; without a card it raises):

  PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \\
      --steps 200 --batch 8 --seq 256 \\
      [--compression rq4] [--error-feedback] [--reduced] \\
      [--ckpt-dir DIR] [--scan-layers] [--remat] [--device cpu]

It prints the JAX launcher's ``[train] step ... loss ... gnorm ... tok/s``
lines, and writes and resumes the JAX package's ``.npz`` checkpoints.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import latest_checkpoint, load_state, save_state
from repro_torch.core import compression, prng
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
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
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace) -> dict:
    """What ``main`` trains with: the model config, the train state (on
    the device, resumed from ``--ckpt-dir`` when it holds a checkpoint),
    the step function and the data."""
    device = resolve_device(args.device)
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
            print(f"[train] resumed from {ck} at step {start}")
    return {"cfg": cfg, "device": device, "state": state, "start": start,
            "train_step": steps.make_train_step(cfg, opt, scfg),
            "data": SyntheticLM(vocab=cfg.vocab, seq_len=args.seq + 1,
                                batch=args.batch, seed=args.seed)}


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def main(argv=None):
    args = parse_args(argv)
    run = setup(args)
    cfg, state, device = run["cfg"], run["state"], run["device"]
    n_params = compression.FlatLayout.from_tree(state["params"]).total
    print(f"[train] arch={cfg.arch_id} params~{n_params / 1e6:.1f}M "
          f"device={device} batch={args.batch} seq={args.seq}")
    start, train_step, data = run["start"], run["train_step"], run["data"]
    t0 = time.time()
    for t in range(start, args.steps):
        state, metrics = train_step(state, to_device(data.batch_at(t),
                                                     device))
        if t % args.log_every == 0 or t == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            tput = args.batch * args.seq * (t - start + 1) / max(dt, 1e-9)
            print(f"[train] step {t:5d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"tok/s {tput:9.0f}")
        if args.ckpt_dir and (t + 1) % args.ckpt_every == 0:
            save_state(state, args.ckpt_dir, step=t + 1)
    if args.ckpt_dir:
        save_state(state, args.ckpt_dir, step=args.steps)
    print("[train] done")
    return state


if __name__ == "__main__":
    main()
