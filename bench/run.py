"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/``
and the program (``src/repro_torch``). It needs as many CUDA cards as
the cell asks for, and exits non-zero without a result line when they
are missing, when the program is missing, or when the JAX stack or the
JAX package was loaded. The last line of standard output is the result
(JSON); the compared numbers and their limits are also the last lines
of standard error. A cell of several cards runs one rank a card: this
process is rank 0, starts the others (``--rank``, on a free local port)
and waits for them; only rank 0 prints a result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench"
# every build and kernel cache stays at a fixed path in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import harness
    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    ranks = []
    if chips > 1 and args.rank == 0:
        # the other ranks start first: their imports overlap this one's
        args.port, ranks = start_ranks(
            __file__, ["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", str(args.trace)], chips)
    try:
        result = run_rank(args, man, chips)
    except BaseException:
        for p in ranks:
            p.kill()
        stop(ranks)
        raise
    codes = stop(ranks)
    if result is None or args.rank:
        return 2 if result is None else 0
    if any(codes):
        print(f"rank exit codes {codes}", file=sys.stderr)
        return 4
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: refused",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run_rank(args, man: dict, chips: int):
    """This process's rank of the run: its result, or None without the
    cards the cell needs."""
    import harness
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if chips > 1 and args.trace:
        record = CACHE / "ring"
        record.mkdir(parents=True, exist_ok=True)
        os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT",
                          NCCL_DEBUG_FILE=str(record /
                                              f"nccl.{args.rank}.log"))
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START, man=man,
                            rank=args.rank, world=chips, port=args.port)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(script: str, argv: list, chips: int) -> tuple:
    """Ranks 1 .. ``chips`` - 1 of a run, each ``script argv --rank r
    --port p`` on one free local port: (the port, their processes)."""
    port = free_port()
    return port, [subprocess.Popen(
        [sys.executable, script, *argv, "--rank", str(r), "--port",
         str(port)], stdout=subprocess.DEVNULL) for r in range(1, chips)]


def stop(procs: list, wait_s: float = 300.0) -> list:
    """Wait for the other ranks, then end any left: their exit codes."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=wait_s))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


if __name__ == "__main__":
    sys.exit(main())
