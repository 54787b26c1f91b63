#!/usr/bin/env python3
"""How far apart correct bf16 prefills of command-r-35b lie, on one
NVIDIA card.

    python3 tools/bf16_prefill_probe.py       # from the repository root

Full-width command-r-35b (40 layers, d 8192, 64/8 heads of 128) with
bf16 weights, random from chip_smoke's seed, on chip_smoke's 1 x 8192
tokens. Four last-position logits of ``make_prefill_step(scan_layers=
True, logits_positions="last")``:

  * ``k6``: use_flash=True on K6 (the main path);
  * ``plain_flash``: use_flash=True on K6's plain version on the card
    (the Pallas kernel's arithmetic: bf16 products of bf16 q, k and of
    the probabilities rounded to bf16, fp32 accumulation);
  * ``no_flash``: the q-chunked exact path (an fp32 softmax and fp32
    products of the bf16 q, k, v), JAX's non-flash path;
  * ``k6_window_4096``: K6 with every layer's attention cut to the last
    4,096 keys, a deliberately wrong attention.

Prints K6 against its plain version at the layer's geometry, then, for
each pair, the max abs difference, the relative L2 difference and the
count of logits more than 0.05 apart, beside the logits' RMS: the
spread between correct paths against what a wrong attention moves.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ARCH = "command-r-35b"
PARAMS_SEED, BATCH_SEED = 58, 59      # chip_smoke's families phase


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.core import prng
    from repro_torch.data import pipeline
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models.common import InputShape
    from repro_torch.train import steps

    if not torch.cuda.is_available():
        print("bf16_prefill_probe: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc.build_many([(fk.SOURCE, fk.LIBRARY)], force=True)
    cfg, params = cs.family_params(torch, ARCH, PARAMS_SEED, "bfloat16")
    batch = pipeline.synthetic_batch(
        cfg, InputShape("prefill_8k", cs.FAMILY_SEQ, 1, "prefill"),
        prng.PRNGKey(BATCH_SEED), device="cuda")
    k6 = cs.check_flash(torch, 1, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cs.FAMILY_SEQ, True, 0, 0.0,
                        "bfloat16", cs.BF16_TOL, seed=BATCH_SEED + 1)
    print(json.dumps({"k6_vs_plain_one_layer": k6}), flush=True)

    def prefill(mc, use_flash):
        t0 = time.perf_counter()
        out = steps.make_prefill_step(
            mc, use_flash=use_flash, scan_layers=True,
            logits_positions="last")(params, batch).float()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs = {}
    runs["k6"] = prefill(cfg, True)
    runs["no_flash"] = prefill(cfg, False)
    wrong = dataclasses.replace(cfg, block_pattern=("local_attn",)
                                * cfg.n_layers, local_window=4096)
    runs["k6_window_4096"] = prefill(wrong, True)
    kernel = fk.flash_attention_bhsd
    fk.flash_attention_bhsd = fk.flash_attention_plain
    try:
        runs["plain_flash"] = prefill(cfg, True)
    finally:
        fk.flash_attention_bhsd = kernel
    for name, (lg, s) in runs.items():
        print(json.dumps({"run": name, "s": s,
                          "rms": float(lg.square().mean().sqrt()),
                          "abs_max": float(lg.abs().max())}), flush=True)
    pairs = [("k6", "plain_flash"), ("k6", "no_flash"),
             ("plain_flash", "no_flash"), ("k6_window_4096", "no_flash"),
             ("k6_window_4096", "k6")]
    for a, b in pairs:
        x, y = runs[a][0], runs[b][0]
        d = x - y
        print(json.dumps({
            "pair": f"{a} - {b}", "max_abs": float(d.abs().max()),
            "rel_l2": float(d.norm() / y.norm()),
            "beyond_0.05": int((d.abs() > 0.05).sum()),
            "not_allclose_0.05": int((~torch.isclose(
                x, y, rtol=0.05, atol=0.05)).sum())}), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
