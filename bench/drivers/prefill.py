"""Driver ``prefill``: ``make_prefill_step`` to the last position's
logits, one prompt at a time, on K6 (``use_flash=True``, scanned layers,
``logits_positions="last"``).

The prompts replay a fixed set of ``n_lengths`` lengths spaced
evenly in log over [``min_len``, ``max_len``], both ends in it, rounded
to ``multiple``, in one fixed order for every seed: the longest, the
shortest, the second longest, the second shortest, and so on, so that
any prefix of a cycle mixes long and short prompts and the window ends
on the same prompts whatever the seed (an order drawn from the seed
would change which prompts a window holds, and so the rate). Every
prompt's token ids are fresh draws from the seed. The warm-up is one
prompt of the longest length.

The check takes a sample drawn from the seed of the prompts completed
in the window, the first longest one always in it, runs the plain
reference over each and compares ``logits``: the largest gap of a last
position's logit over the largest reference logit of that prompt.
"""
from __future__ import annotations

import random

import harness
import inputs
import port
from reference import model as ref_model

E2E = "prefill_tokens_per_s"
FAULTS = ("token",)                     # what a prefill can get wrong


def lengths(t: dict) -> list:
    lo, hi, n, mult = t["min_len"], t["max_len"], t["n_lengths"], \
        t["multiple"]
    return [round(lo * (hi / lo) ** (i / (n - 1)) / mult) * mult
            for i in range(n)]


def cycle(t: dict) -> list:
    ls = lengths(t)
    return [ls[-1 - i // 2] if i % 2 == 0 else ls[i // 2]
            for i in range(len(ls))]


def setup(run) -> None:
    import torch
    from repro_torch.train import steps
    m, t = run.model, run.traffic
    dev = torch.device(run.device)
    cfg = port.model_config(m)
    harness.note("prefill: configuration checked")
    W = inputs.weights(m, run.seed, dev)
    run.sync()
    harness.note("prefill: weights drawn")
    params = port.param_tree(W)
    st = run.state
    st.update(W=W, params=params, dev=dev, answers=[], queue=[],
              tokens=inputs.Tokens(run.seed, m["vocab"], dev),
              prefill=steps.make_prefill_step(
                  cfg, use_flash=True, scan_layers=True,
                  logits_positions="last"))
    harness.note("prefill: program and weights ready")
    warm = inputs.Tokens(run.seed + 1, m["vocab"], dev)
    st["prefill"](params, {"tokens": warm.draw((1, max(lengths(t))))})


def step(run) -> int:
    st = run.state
    if not st["queue"]:
        st["queue"] = cycle(run.traffic)
    n = st["queue"].pop(0)
    toks = st["tokens"].draw((1, n))
    logits = st["prefill"](st["params"], {"tokens": toks})
    run.sync()
    st["answers"].append((toks, logits))
    return n


def sample(run) -> list:
    """Indices of the checked prompts: the first longest completed in the
    window and ``check_prompts`` - 1 others drawn from the seed."""
    done = [i for i, u in enumerate(run.units) if u["in_window"]]
    lens = [run.state["answers"][i][0].shape[1] for i in done]
    first = done[lens.index(max(lens))]
    rest = [i for i in done if i != first]
    k = min(len(rest), run.traffic["check_prompts"] - 1)
    return [first] + random.Random(run.seed ^ 0x5EED).sample(rest, k)


def readings(outputs: list, refs: list) -> dict:
    err = max(float((o.double() - r.double()).abs().max()
                    / r.double().abs().max()) for o, r in zip(outputs, refs))
    return {"logits": err}


def reference(run, idx: list, precision: str) -> list:
    st = run.state
    return [ref_model.last_logits(st["W"], run.model, st["answers"][i][0],
                                  precision=precision,
                                  q_block=run.traffic["ref_q_block"])
            for i in idx]


def check(run) -> list:
    idx = sample(run)
    st = run.state
    outputs = [st["answers"][i][1] for i in idx]
    harness.free("prefill", "params", state=st)
    got = readings(outputs, reference(run, idx, "fp32"))
    return [(n, v, run.limits.get(n)) for n, v in got.items()]


def control(run) -> dict:
    """The readings of the control: the reference in TF32 in the
    program's place, on the prompts of one cycle as a run draws them."""
    import torch
    m, st = run.model, run.state
    dev = torch.device(run.device)
    st.update(W=inputs.weights(m, run.seed, dev), answers=[])
    tokens = inputs.Tokens(run.seed, m["vocab"], dev)
    for n in cycle(run.traffic):
        st["answers"].append((tokens.draw((1, n)), None))
        run.units.append({"work": n, "in_window": True})
    idx = sample(run)
    return readings(reference(run, idx, "tf32"),
                    reference(run, idx, "fp32"))

