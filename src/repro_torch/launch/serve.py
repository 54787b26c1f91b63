"""Serving launcher — a thin argv shim over ``repro_torch.serve.run``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --slots 4 --requests 16 --prompt-len 32 --gen 64 [--window 16] \
      [--mode static] [--device cuda|cpu]

Runs on the card unless ``--device cpu``; without a card and without
``--device cpu`` it exits with an error instead of falling back.
"""
from __future__ import annotations

import argparse

from repro_torch import serve


def build_config(args) -> serve.ServeConfig:
    n_requests = args.requests if args.requests else args.slots
    return serve.ServeConfig(
        arch=args.arch, reduced=args.reduced, slots=args.slots,
        max_len=args.prompt_len + args.gen + 1, window=args.window,
        mode=args.mode, temperature=args.temperature, seed=args.seed,
        n_requests=n_requests, prompt_len=args.prompt_len,
        gen_tokens=args.gen, mixed_gen=tuple(args.mixed_gen or ()))


def main(argv=None) -> serve.ServeResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4,
                    help="decode lanes")
    ap.add_argument("--requests", type=int, default=0,
                    help="synthetic requests to serve (default: one per "
                         "slot)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--mixed-gen", type=int, nargs="*", default=None,
                    help="cycle these generation lengths across requests")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window KV cache size (0 = full)")
    ap.add_argument("--mode", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    result = serve.run(build_config(args), device=args.device)
    print(serve.format_result(result))
    return result


if __name__ == "__main__":
    main()
