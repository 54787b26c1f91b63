#!/usr/bin/env python3
"""Where the DeepSeek-V2-Lite prefill cell's ``logits`` gap comes from,
on one NVIDIA card.

    python3 tools/deepseek_route_probe.py SEED[,SEED...]   # repo root

For each seed, the benchmark's weights (``bench/inputs_deepseek.py``)
and two prompts of the cell (16,384 and 4,096 fresh token ids from the
seed): the program's ``make_prefill_step(use_flash=True, scan_layers=
True, logits_positions="last")`` against the plain reference
(``bench/reference/deepseek.py``), and the reference against itself at
another query block (its own rounding). In every MoE layer, the tokens
whose top-k expert set differs between the program and the reference
(each side's router run again on that side's own layer input, with
that side's arithmetic), with the reference's largest gap between the
k-th and (k+1)-th router probability at those tokens. Then the program
again with its routes forced to the reference's (the program's own
probabilities as the gates of the reference's experts): if the gap
comes from flipped choices, that run sits at the reference's own
rounding. One JSON line a prompt.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def main(seeds: list) -> None:
    import torch

    import harness
    import inputs
    import inputs_deepseek
    import port_deepseek
    from reference import deepseek as ref
    from repro_torch.models import layers, moe
    from repro_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = harness.load_json("configs", "deepseek-v2-lite.json")["model"]
    k = m["top_k"]
    prefill = steps.make_prefill_step(port_deepseek.model_config(m),
                                      use_flash=True, scan_layers=True,
                                      logits_positions="last")
    dropless, ref_moe, topk = moe._dropless, ref.moe, torch.topk
    prog_ids, ref_ids, ref_margin, forced = [], [], [], []

    def prog_spy(p, cfg, x, act):
        """The program's layer, its routes noted (its router again, as
        ``_dropless`` computes it) or, with ``forced`` set, replaced by
        the reference's of the same layer."""
        xt = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(layers.dense(p["router"], xt.float()), -1)
        if not forced:
            prog_ids.append(topk(probs, k, dim=-1).indices)
            return dropless(p, cfg, x, act)
        ids = ref_ids[len(prog_ids)]
        prog_ids.append(ids)
        torch.topk = lambda pr, kk, dim=-1: (pr.gather(-1, ids), ids)
        try:
            return dropless(p, cfg, x, act)
        finally:
            torch.topk = topk

    def ref_spy(W, m_, a, j, mm, stats=None):
        top = topk(torch.softmax(mm(a, W["router"][j]), dim=-1), k + 1,
                   dim=-1)
        ref_ids.append(top.indices[:, :k])
        ref_margin.append(top.values[:, k - 1] - top.values[:, k])
        return ref_moe(W, m_, a, j, mm, stats)

    moe._dropless, ref.moe = prog_spy, ref_spy
    for seed in seeds:
        W = inputs_deepseek.weights(m, seed, "cuda")
        tree = port_deepseek.param_tree(W)
        tokens = inputs.Tokens(seed, m["vocab"], "cuda")
        for n in (16384, 4096):
            x = tokens.draw((1, n))
            for side in (prog_ids, ref_ids, ref_margin, forced):
                side.clear()
            out = prefill(tree, {"tokens": x})
            r = ref.last_logits(W, m, x, q_block=1024)
            prog = list(prog_ids)
            prog_ids.clear()
            forced.append(True)
            out_forced = prefill(tree, {"tokens": x})
            ref.moe = ref_moe
            r512 = ref.last_logits(W, m, x, q_block=512)
            ref.moe = ref_spy
            differ, margin_at = [], []
            for a, b, g in zip(prog, ref_ids, ref_margin):
                d = (a.sort(-1).values != b.sort(-1).values).any(-1)
                differ.append(int(d.sum()))
                margin_at.append(float(g[d].max()) if d.any() else None)
            print(json.dumps({
                "seed": seed, "len": n, "prog_vs_ref": gap(out, r),
                "forced_routes_vs_ref": gap(out_forced, r),
                "ref_q_block_512_vs_1024": gap(r512, r),
                "tokens_whose_sets_differ_per_layer": differ,
                "tokens_whose_sets_differ": sum(differ),
                "choices_of_the_prompt": n * k * len(differ),
                "largest_ref_margin_where_sets_differ": max(
                    (g for g in margin_at if g is not None), default=None),
                "last_token_sets_differ_in_layers": [
                    i for i, (a, b) in enumerate(zip(prog, ref_ids))
                    if sorted(a[-1].tolist()) != sorted(b[-1].tolist())],
                "last_token_least_ref_margin": min(
                    float(g[-1]) for g in ref_margin)}), flush=True)
        del W, tree
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1].split(",")])
