"""Driver ``prefill_moe``: the ``prefill`` driver's closed loop of single
prompts (its ``lengths``, ``cycle``, ``step`` and ``sample``, loaded from
that module) for DeepSeek-V2-Lite: ``make_prefill_step(use_flash=True,
scan_layers=True, logits_positions="last")`` on the weights of
``inputs_deepseek`` handed to the program's tree (``port_deepseek``),
checked against ``reference.deepseek``.

The check compares ``logits`` as the prefill driver does: the largest
gap of a last position's logit over the largest reference logit of that
prompt, over ``check_prompts`` prompts of the window. A prompt whose last
token the reference routes within ``tie_band`` of a tie (the gap of the
k-th and (k+1)-th router probability in some MoE layer) is left out and
the next takes its place (``_compare``); the margins kept and left out
are noted on standard error.
"""
from __future__ import annotations

import random

import harness
import inputs
import inputs_deepseek
import port_deepseek
from reference import deepseek as ref_deepseek

base = harness.load_module("drivers", "prefill")
E2E = base.E2E
FAULTS = base.FAULTS
lengths, cycle, step, sample, readings = (base.lengths, base.cycle,
                                          base.step, base.sample,
                                          base.readings)


def _model(run) -> dict:
    """The run's model numbers (a smoke run's filled in once, so that the
    per-layer readers see them too)."""
    run.model = port_deepseek.model_dict(run.model)
    return run.model


def setup(run) -> None:
    import torch
    from repro_torch.train import steps
    m, t = _model(run), run.traffic
    dev = torch.device(run.device)
    cfg = port_deepseek.model_config(m)
    harness.note("prefill_moe: configuration checked")
    W = inputs_deepseek.weights(m, run.seed, dev)
    run.sync()
    harness.note("prefill_moe: weights drawn")
    st = run.state
    st.update(W=W, params=port_deepseek.param_tree(W), dev=dev, answers=[],
              queue=[], tokens=inputs.Tokens(run.seed, m["vocab"], dev),
              prefill=steps.make_prefill_step(
                  cfg, use_flash=True, scan_layers=True,
                  logits_positions="last"))
    harness.note("prefill_moe: program and weights ready")
    warm = inputs.Tokens(run.seed + 1, m["vocab"], dev)
    st["prefill"](st["params"], {"tokens": warm.draw((1, max(lengths(t))))})


def _candidates(run) -> list:
    """The prompts in the order the check takes them: the prefill
    driver's sample (the first longest completed in the window, then
    others drawn from the seed), then the rest of the window's prompts in
    an order drawn from the seed."""
    picked = sample(run)
    rest = [i for i, u in enumerate(run.units)
            if u["in_window"] and i not in picked]
    random.Random(run.seed ^ 0x7E1).shuffle(rest)
    return picked + rest


def _compare(run, side) -> dict:
    """``logits`` of ``side(i)`` (a prompt's last logits) against the fp32
    reference over ``check_prompts`` prompts. A prompt whose reference
    routes its last token within ``tie_band`` of a tie in some MoE layer
    (the gap of the k-th and (k+1)-th router probability) is left out,
    decided from the reference alone: there a rounding difference may
    flip an expert choice, and the logits then differ by far more than
    rounding; the next candidate takes its place."""
    st, m, t = run.state, _model(run), run.traffic
    outs, refs, kept, left = [], [], [], []
    for i in _candidates(run):
        stats = []
        r = ref_deepseek.last_logits(st["W"], m, st["answers"][i][0],
                                     precision="fp32",
                                     q_block=t["ref_q_block"], stats=stats)
        margin = min(g for _, g in stats)
        if margin < t["tie_band"]:
            left.append(f"{margin:.3e}")
            continue
        outs.append(side(i))
        refs.append(r)
        kept.append(f"{margin:.3e}")
        if len(refs) == t["check_prompts"]:
            break
    harness.note(f"prefill_moe: least top-k router margin of the checked "
                 f"last positions {', '.join(kept)}; left out (under "
                 f"{t['tie_band']:g}): {', '.join(left) or 'none'}")
    return readings(outs, refs) if refs else {"logits": float("nan")}


def check(run) -> list:
    st = run.state
    harness.free("prefill", "params", state=st)
    got = _compare(run, lambda i: st["answers"][i][1])
    return [(n, v, run.limits.get(n)) for n, v in got.items()]


def control(run) -> dict:
    """The readings of the control: the reference in TF32 in the
    program's place, on the prompts of one cycle as a run draws them."""
    import torch
    m, st, t = _model(run), run.state, run.traffic
    dev = torch.device(run.device)
    st.update(W=inputs_deepseek.weights(m, run.seed, dev), answers=[])
    tokens = inputs.Tokens(run.seed, m["vocab"], dev)
    for n in cycle(t):
        st["answers"].append((tokens.draw((1, n)), None))
        run.units.append({"work": n, "in_window": True})
    return _compare(run, lambda i: ref_deepseek.last_logits(
        st["W"], m, st["answers"][i][0], precision="tf32",
        q_block=t["ref_q_block"]))
