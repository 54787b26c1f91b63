"""Driver ``ring``: compressed SGD on the paper's partitioned rq4 ring
AllReduce, one worker a rank (one rank a card).

Every rank joins one process group (NCCL on cards, gloo on the CPU) and
takes the per-worker step of ``core.parallel``'s ranks loop, without its
per-step diagnostics: the gradient of ``make_loss_fn(cfg,
TrainStepConfig(remat=True, scan_layers=True))`` on its own rows of a
global batch (``steps.value_and_grad``), the exchange
``CSGDRingExchange(compressor="rq4")`` over ``RankAxis()`` under the
step key ``fold_in(root, t)``, then ``p - lr u``. Every rank draws the
same global batch of ``batch`` x ``seq`` tokens from the seed and takes
rows [rank b, (rank + 1) b), b = batch / world. The first
``check_steps`` steps are the warm-up, and set-up reads from them what
the check compares: each rank's losses, the first step's update u (a
leaf at a time) and every leaf's change over those steps. Rank 0 decides
when the window closes and tells the others.

The check: ``replicas`` the ranks whose parameters differ from rank 0's
bit for bit after the window (limit 0); ``loss``, ``grad_norm`` and
``update_norm`` as the ``train`` driver reads them, against the
reference ring (``reference.ring``) run on rank 0 from the same weights
and rows.
"""
from __future__ import annotations

import hashlib

import compare
import harness
import inputs
import port
from reference import layout
from reference import ring as ref_ring

E2E = "ring_tokens_per_s"
FAULTS = ("no_exchange", "ring_half_batch", "ring_unchanged")


def _join(run):
    import torch
    import torch.distributed as dist
    if run.device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", run.rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo" if dev.type == "cpu" else "nccl",
        init_method=f"tcp://localhost:{run.port}", rank=run.rank,
        world_size=run.world)
    return dev


def _rows(run, tokens) -> dict:
    b = run.traffic["batch"] // run.world
    mine = tokens[run.rank * b:(run.rank + 1) * b]
    return {"tokens": mine[:, :-1], "labels": mine[:, 1:]}


def _step(run, tokens, timed: bool = False) -> tuple:
    """One step of this rank's worker -> (loss, update tree)."""
    import time

    from repro_torch.core import prng, pytree
    from repro_torch.train import steps
    st = run.state
    loss, g = steps.value_and_grad(st["loss_fn"], st["params"],
                                   _rows(run, tokens))
    key = prng.fold_in(st["root"], st["t"])
    if timed:
        run.sync()
        t0 = time.perf_counter()
    u, _ = st["exchange"](g, (), key, axis_name=st["axis"])
    if timed:
        run.sync()
        st["exchange_s"].append(time.perf_counter() - t0)
    del g
    lr = run.traffic["lr"]
    st["params"] = pytree.tree_map(lambda p, d: p - lr * d, st["params"], u)
    st["t"] += 1
    return loss, u


def setup(run) -> None:
    from repro_torch.core import communicators, prng
    from repro_torch.train import steps
    m, t = run.model, run.traffic
    dev = _join(run)
    cfg = port.model_config(m)
    W = inputs.weights(m, run.seed, dev)
    params = port.param_tree(W)
    st = run.state
    st.update(params=params, dev=dev, t=0, exchange_s=[],
              root=prng.PRNGKey(run.seed % (1 << 32)),
              tokens=inputs.Tokens(run.seed, m["vocab"], dev),
              axis=communicators.RankAxis(),
              exchange=communicators.CSGDRingExchange(compressor="rq4"),
              loss_fn=steps.make_loss_fn(cfg, steps.TrainStepConfig(
                  remat=True, scan_layers=True)))
    shape = (t["batch"], t["seq"] + 1)
    st["shape"] = shape
    st["batches"] = [st["tokens"].draw(shape)
                     for _ in range(t["check_steps"])]
    side = {"loss": []}
    for i, b in enumerate(st["batches"]):
        loss, u = _step(run, b)
        side["loss"].append(float(loss))
        if i == 0:
            side["grad_norm"] = {n: float(port.get(
                u, layout.PATHS[n]).double().norm())
                for n in layout.flat_order(m)}
        del u
    del W
    W0 = inputs.weights(m, run.seed, dev)
    side["update_norm"] = {n: float((port.get(
        st["params"], layout.PATHS[n]) - W0[n]).double().norm())
        for n in layout.flat_order(m)}
    del W0
    st["program"] = side
    st["sent0"] = st["axis"].sent_bytes
    harness.note(f"ring: rank {run.rank} set up")


def agree(run, inside: bool) -> bool:
    """Rank 0's word on whether the window is still open."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1 if inside else 0], dtype=torch.int32,
                        device=run.state["dev"])
    dist.broadcast(flag, 0)
    return bool(flag.item())


def step(run) -> int:
    st = run.state
    _step(run, st["tokens"].draw(st["shape"]), timed=run.trace_on)
    run.sync()
    return st["shape"][0] * (st["shape"][1] - 1)


def _digest(tree) -> str:
    from repro_torch.core import pytree
    h = hashlib.sha256()
    for leaf in pytree.tree_leaves(tree):
        h.update(leaf.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def reference(run, precision: str) -> dict:
    t, w = run.traffic, run.world
    b = t["batch"] // w
    W = inputs.weights(run.model, run.seed, run.state["dev"])
    steps_ = [[(x[r * b:(r + 1) * b, :-1], x[r * b:(r + 1) * b, 1:])
               for r in range(w)] for x in run.state["batches"]]
    return ref_ring.run(W, run.model, steps_, run.seed % (1 << 32),
                        t["lr"], precision=precision, rows=t["ref_rows"])


def _record(run) -> None:
    """The machine under a traced run, on rank 0's standard error and in
    ``build/bench/ring/`` of the checkout: the cards' topology, NCCL's
    transport between the ranks, and a profiler trace of one more step
    (every rank takes it; rank 0 traces it)."""
    import contextlib
    import subprocess

    from torch.profiler import ProfilerActivity, profile
    out = harness.ROOT / "build" / "bench" / "ring"
    lead = run.rank == 0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if lead and run.device != "cpu" else contextlib.nullcontext()
    with prof:
        step(run)
    if not lead:
        return
    try:
        topo = subprocess.run(["nvidia-smi", "topo", "-m"], text=True,
                              capture_output=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        topo = f"nvidia-smi topo -m: {e}"
    harness.note("topology\n" + topo.rstrip())
    log = out / "nccl.0.log"
    if log.exists():
        via = [ln.strip() for ln in log.read_text().splitlines()
               if " via " in ln]
        harness.note("NCCL transport\n" + "\n".join(via[:12]))
    if prof is not None and hasattr(prof, "export_chrome_trace"):
        path = out / "rank0_step.json"
        prof.export_chrome_trace(str(path))
        harness.note(f"one rank-0 step traced: {path.relative_to(harness.ROOT)}")


def check(run) -> list:
    import torch.distributed as dist
    st = run.state
    if run.trace_on:
        _record(run)
    digests = run.gather(_digest(st["params"]))
    losses = run.gather(st["program"]["loss"])
    harness.free("params", "loss_fn", "exchange", "tokens", state=st)
    dist.destroy_process_group()
    if run.rank != 0:
        return []
    side = dict(st["program"], loss=[list(x) for x in zip(*losses)])
    got = compare.training(side, reference(run, "fp32"))
    got["replicas"] = float(sum(d != digests[0] for d in digests))
    return [(n, v, run.limits.get(n)) for n, v in got.items()]


def control(run) -> dict:
    """The control's readings: the reference ring in TF32 in the
    program's place, on the rows a run would check (one process)."""
    import torch
    t = run.traffic
    run.world = run.workload["chips"]
    dev = torch.device(run.device)
    tokens = inputs.Tokens(run.seed, run.model["vocab"], dev)
    run.state.update(dev=dev, batches=[
        tokens.draw((t["batch"], t["seq"] + 1))
        for _ in range(t["check_steps"])])
    low = reference(run, "tf32")
    return compare.training(low, reference(run, "fp32"))

