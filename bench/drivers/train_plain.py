"""Driver ``train_plain``: the ``train`` driver (its set-up, step and
readings, loaded from that module) on a step without a codec
(``--compression none``, no error feedback), checked against
``reference.train_plain``, the same reference step without the rq4 qdq.
"""
from __future__ import annotations

import compare
import harness
import inputs
from reference import train_plain as ref_plain

base = harness.load_module("drivers", "train")
E2E = base.E2E
FAULTS = base.FAULTS
setup, step = base.setup, base.step


def reference(run, precision: str) -> dict:
    t = run.traffic
    W = inputs.weights(run.model, run.seed, run.state["dev"])
    batches = [(b[:, :-1], b[:, 1:]) for b in run.state["batches"]]
    return ref_plain.run(W, run.model, batches,
                         {"lr": t["lr"], "warmup": t["warmup"]},
                         precision=precision, rows=t["ref_rows"])


def check(run) -> list:
    side = run.state["program"]
    harness.free("step", "train_state", "tokens", state=run.state)
    got = compare.training(side, reference(run, "fp32"))
    return [(n, v, run.limits.get(n)) for n, v in got.items()]


def control(run) -> dict:
    """The readings of the control: the reference in TF32 in the
    program's place, on the rows a run would check."""
    import torch
    t = run.traffic
    dev = torch.device(run.device)
    tokens = inputs.Tokens(run.seed, run.model["vocab"], dev)
    run.state.update(dev=dev, batches=[
        tokens.draw((t["batch"], t["seq"] + 1))
        for _ in range(t["check_steps"])])
    return compare.training(reference(run, "tf32"), reference(run, "fp32"))
