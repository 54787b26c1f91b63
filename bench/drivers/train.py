"""Driver ``train``: the launcher's one-card training step.

Set-up builds the run through ``repro_torch.launch.train.setup`` with
the cell's flags (``traffic["flags"]``), copies the benchmark's weights
into its parameters, and drives that same step object through the
first ``check_steps`` steps on fresh rows of token ids from the seed,
reading from them what the check compares: each step's loss, the first
gradient as AdamW got it (its first moment over 1 - b1, a leaf at a
time) and the change of every leaf over those steps. These steps are
the warm-up. A unit of the window is one more step on a fresh batch of
``batch`` x ``seq`` tokens.

The check follows the same steps with the plain reference
(``reference.train``) from the same weights and rows, and compares:
``loss`` the largest relative gap of a step's loss; ``grad_norm`` and
``update_norm`` the largest gap of a leaf's norm over the larger of the
reference leaf's norm and the median leaf's; ``update_norm`` leaves out
the leaves whose raw reference gradient is under a thousandth of the
median leaf's (their change is Adam's round-off).
"""
from __future__ import annotations

import compare
import harness
import inputs
import port
from reference import layout
from reference import train as ref_train

E2E = "train_tokens_per_s"
B1 = 0.9          # AdamW's first-moment decay, as the flags select it
FAULTS = ("unchanged", "half_batch")    # what a training step can get wrong


def _argv(run) -> list:
    t, m = run.traffic, run.model
    argv = ["--arch", m["arch"], "--batch", str(t["batch"]),
            "--seq", str(t["seq"]), "--seed", str(run.seed % (1 << 32)),
            "--lr", str(t["lr"]), "--steps", str(t["schedule_steps"]),
            *t["flags"]]
    if run.device == "cpu":
        argv += ["--device", "cpu"]
    if m.get("smoke"):
        argv.append("--reduced")
    return argv


def _batch(tokens) -> dict:
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _norms_by_name(tree, m: dict, scale: float = 1.0) -> dict:
    import torch
    return {n: float(torch.linalg.vector_norm(
        port.get(tree, layout.PATHS[n]).double())) * scale
        for n in layout.flat_order(m)}


def setup(run) -> None:
    from repro_torch.launch import train as launcher
    args = launcher.parse_args(_argv(run))
    prog = launcher.setup(args)
    harness.note("train: launcher set up")
    m, t = run.model, run.traffic
    port.check_config(prog["cfg"], m)
    dev = prog["device"]
    W = inputs.weights(m, run.seed, dev)
    run.sync()
    harness.note("train: weights drawn")
    port.load_params(prog["state"]["params"], W)
    del W
    tokens = inputs.Tokens(run.seed, m["vocab"], dev)
    shape = (t["batch"], t["seq"] + 1)
    st = run.state
    st.update(step=prog["train_step"], train_state=prog["state"],
              tokens=tokens, shape=shape, dev=dev)
    st["batches"] = [tokens.draw(shape) for _ in range(t["check_steps"])]
    harness.note("train: weights loaded")
    side = {"loss": []}
    for i, b in enumerate(st["batches"]):
        st["train_state"], metrics = st["step"](st["train_state"],
                                                _batch(b))
        side["loss"].append(float(metrics["loss"]))
        if i == 0:
            side["grad_norm"] = _norms_by_name(
                st["train_state"]["opt"]["m"], m, 1.0 / (1.0 - B1))
    harness.note("train: checked steps run")
    W0 = inputs.weights(m, run.seed, dev)
    params = st["train_state"]["params"]
    side["update_norm"] = {}
    for n in layout.flat_order(m):
        p = port.get(params, layout.PATHS[n])
        side["update_norm"][n] = float((p - W0[n]).double().norm())
    del W0
    st["program"] = side


def step(run) -> int:
    st = run.state
    st["train_state"], _ = st["step"](st["train_state"],
                                      _batch(st["tokens"].draw(
                                          st["shape"])))
    run.sync()
    return st["shape"][0] * (st["shape"][1] - 1)


def reference(run, precision: str) -> dict:
    t = run.traffic
    W = inputs.weights(run.model, run.seed, run.state["dev"])
    batches = [(b[:, :-1], b[:, 1:]) for b in run.state["batches"]]
    return ref_train.run(W, run.model, batches, run.seed % (1 << 32),
                         {"lr": t["lr"], "warmup": t["warmup"]},
                         precision=precision, rows=t["ref_rows"])


def check(run) -> list:
    side = run.state["program"]
    harness.free("step", "train_state", "tokens", state=run.state)
    ref = reference(run, "fp32")
    got = compare.training(side, ref)
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

