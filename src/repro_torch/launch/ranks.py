"""The paper's algorithm tier with one worker a rank, from the command
line: ``core.parallel.run_quadratic`` of one method over the ranks of the
default process group, each rank running its own worker and the
exchanges' collectives going between the ranks.

    # four ranks on the CPU (gloo)
    PYTHONPATH=src OMP_NUM_THREADS=2 torchrun --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.ranks --device cpu \\
        --method csgd_ring --compressor rq4
    # one rank a card (NCCL)
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.ranks --method dcd --compressor rq4

The group is the caller's own when it made one, else it is made from
torchrun's variables (NCCL on cards, each rank on ``cuda:LOCAL_RANK``;
gloo with ``--device cpu``), as ``launch.train`` does; without either
it raises (the stacked form is ``core.parallel.run_quadratic`` without
``axis_name``). The worker count is the world size. Rank 0 prints the loss
at x̄ and the consensus every ``--log-every`` steps, and every rank the
bytes it sent in all (a DCD/ECD start sends each neighbour the model
once). A failed rank raises.
"""
from __future__ import annotations

import argparse

from repro_torch.core import communicators, parallel
from repro_torch.launch.train import _join_group

METHODS = ("gd", "sgd", "mbsgd", "csgd_ps", "csgd_ring", "ecsgd", "asgd",
           "dsgd", "dcd", "ecd")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="csgd_ring", choices=METHODS)
    ap.add_argument("--compressor", default=None,
                    help="the exchange's codec (rq8, rq4, rq2, sign1, ...)")
    ap.add_argument("--topology", default=None,
                    help="dsgd/dcd/ecd gossip: ring, torus or full")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; cuda:LOCAL_RANK on a rank) "
                         "or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> parallel.RunResult:
    import torch.distributed as dist

    args = parse_args(argv)
    device, made = _join_group(args)
    if made is None:
        raise RuntimeError("launch.ranks runs under a process group: start "
                           "it with torchrun, or make the group first")
    try:
        axis = communicators.RankAxis()
        kw = {"exchange_kw": {"compressor": args.compressor}} \
            if args.compressor else {}
        res = parallel.run_quadratic(
            args.method, n_workers=axis.n, steps=args.steps, lr=args.lr,
            seed=args.seed, gossip_topology=args.topology, device=device,
            axis_name=axis, **kw)
        if axis.index == 0:
            for t in range(0, args.steps, args.log_every):
                print(f"[ranks] step {t:5d} loss {float(res.losses[t]):.6f} "
                      f"consensus {float(res.consensus[t]):.3e}")
        print(f"[ranks] rank {axis.index} of {axis.n}: sent "
              f"{axis.sent_bytes} B in {args.steps} steps "
              f"(message_bytes {res.comm_bytes_per_step:.0f} a step)")
        return res
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
