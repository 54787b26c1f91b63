"""Tiny versions of the cells for CPU tests: the program's smoke-test
configurations (``smoke``) and traffic a CPU runs in seconds."""
from __future__ import annotations

import contextlib
import copy
import multiprocessing
import socket

import faults
import harness


def model(config: str) -> dict:
    from repro_torch import configs
    m = dict(harness.load_json("configs", f"{config}.json")["model"])
    c = configs.get_config(m["arch"]).reduced()
    m.update(smoke=True, n_layers=c.n_layers, d_model=c.d_model,
             n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
             head_dim=c.head_dim, d_ff=c.d_ff, vocab=c.vocab)
    return m


def workload(cell: str) -> dict:
    w = copy.deepcopy(harness.load_json("workloads", f"{cell}.json"))
    t = w["traffic"]
    if w["driver"] == "train":
        t.update(batch=2, seq=32)
    elif w["driver"] == "ring":
        t.update(batch=2 * w["chips"], seq=32)
    else:
        t.update(min_len=64, max_len=256, n_lengths=4, multiple=32,
                 ref_q_block=64)
    return w


def run(cell: str, seed: int = 7, seconds: float = None, trace=False,
        fault=None):
    """One tiny run on the CPU; a cell of several cards runs its ranks as
    processes on one gloo group. A training step takes ~0.4 s and more on
    a loaded host, so a training window is longer: at least one step has
    to end inside it. ``fault`` is planted in every rank."""
    w = workload(cell)
    seconds = seconds or (1.0 if w["driver"] == "prefill" else 3.0)
    if w["chips"] == 1:
        with _planted(fault):
            return harness.run_cell(cell, seed, seconds, trace,
                                    device="cpu", workload=w,
                                    model=model(w["config"]))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(cell, seed, seconds, trace,
                                             fault, r, w["chips"], port, q))
             for r in range(w["chips"])]
    for p in procs:
        p.start()
    try:
        out = _result(q, procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return out


def _result(q, procs, limit_s: float = 600.0):
    """Rank 0's result, or an error as soon as a rank has failed."""
    import queue
    import time
    end = time.monotonic() + limit_s
    while time.monotonic() < end:
        try:
            return q.get(timeout=2.0)
        except queue.Empty:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"a rank failed: exit codes {dead}")
    raise TimeoutError("no result from rank 0")


def _planted(fault):
    return faults.planted(fault) if fault else contextlib.nullcontext()


def _rank(cell, seed, seconds, trace, fault, rank, world, port, q):
    import torch
    torch.set_num_threads(2)
    w = workload(cell)
    with _planted(fault):
        r = harness.run_cell(cell, seed, seconds, trace, device="cpu",
                             workload=w, model=model(w["config"]),
                             rank=rank, world=world, port=port)
    if rank == 0:
        q.put(r)
