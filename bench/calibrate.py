"""Readings for setting a cell's limits: the program's compared numbers
over many seeds, the control's (the reference in TF32 in the program's
place) and each planted fault's, at the cell's own sizes:

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --mode program|control|fault:<name> [--seconds S]

A program or fault run is a benchmark run (``harness.run_cell``, its
ranks started as ``run.py`` starts them) with a window of ``--seconds``,
long enough for the traffic's longest unit; the fault is planted for the
run. The control runs the reference twice in this process. One JSON line
a seed. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import faults
import harness
import run as runner    # also sets the benchmark's cache directories


def reading(cell: str, seed: int, mode: str, seconds: float, *,
            rank: int = 0, port: int = 0, argv: list = (),
            device: str = "cuda", workload=None, model=None) -> dict:
    """The compared numbers of one seed under ``mode`` (rank 0's; a
    cell of several cards starts ranks 1 .. n - 1 as ``calibrate.py
    argv --rank r --port p``)."""
    if mode == "control":
        run = harness.Run(cell, seed, 0.0, False, device, workload, model)
        return run.driver.control(run)
    wl = workload or harness.load_json("workloads", f"{cell}.json")
    chips = wl["chips"]
    procs = []
    if chips > 1 and rank == 0:
        port, procs = runner.start_ranks(__file__, list(argv), chips)
    planted = faults.planted(mode.split(":", 1)[1]) \
        if mode.startswith("fault:") else contextlib.nullcontext()
    try:
        with planted:
            r = harness.run_cell(cell, seed, seconds, False, device=device,
                                 workload=workload, model=model, rank=rank,
                                 world=chips, port=port)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        runner.stop(procs)
    return {n: c["value"] for n, c in r["checks"].items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    limits = harness.load_json("workloads",
                               f"{args.workload}.json").get("limits", {})
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rank_argv = ["--workload", args.workload, "--seeds", str(seed),
                     "--mode", args.mode, "--seconds", str(args.seconds)]
        got = reading(args.workload, seed, args.mode, args.seconds,
                      rank=args.rank, port=args.port, argv=rank_argv)
        if args.rank:
            continue
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.mode, "readings": got,
                          "limits": limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
