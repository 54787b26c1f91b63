"""The benchmark's harness: one cell, one seed, one process.

A cell is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its driver
(``drivers/<driver>.py``), its traffic and the limits of its check;
``BENCHMARK.json`` lists its metrics, and each per-layer metric is read
by ``metrics/<metric>.py``. Adding a cell, a configuration or a metric
adds files and entries; no file here names one.

A run sets up (``driver.setup``: the program, the inputs from the seed,
the warm-up), then measures for ``seconds``: a closed loop of
``driver.step`` calls, each ending when its work has finished on the
device. A rate is the work completed in the window over the time from
the window's start to its last completion; the unit running when the
window closes is not counted. With ``trace`` the loop runs under
``torch.profiler`` and the per-layer metrics are read from the trace.
Then the driver checks what the timed path produced against the plain
reference (``driver.check``), after the peak memory has been read.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
T0 = time.perf_counter()


def load_json(*parts) -> dict:
    with open(BENCH.joinpath(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared as whole names."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


class Run:
    """One run of one cell: its files, seed and device, the driver's
    state, and what the window measured."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str, workload: dict = None, model: dict = None, *,
                 rank: int = 0, world: int = 1, port: int = 0):
        self.cell, self.seed, self.seconds = cell, int(seed), seconds
        self.trace_on, self.device = trace, device
        self.rank, self.world, self.port = rank, world, port
        self.workload = workload or load_json("workloads", f"{cell}.json")
        self.config = self.workload["config"]
        self.model = model or load_json("configs",
                                        f"{self.config}.json")["model"]
        self.traffic = self.workload["traffic"]
        self.limits = self.workload.get("limits", {})
        self.driver = load_module("drivers", self.workload["driver"])
        self.state: dict = {}
        self.units: list = []       # one dict a unit of work, in order
        self.trace = None
        self.setup_s = self.elapsed = None
        self.peak_bytes = 0

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order (one rank: [obj])."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def measure(run: Run) -> None:
    """The window: a closed loop of ``driver.step`` for ``run.seconds``."""
    import torch
    prof = None
    if run.trace_on:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if run.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    run.sync()
    if run.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    with torch.profiler.record_function("bench.window"):
        t0 = time.perf_counter()
        t_last = t0
        while True:
            with torch.profiler.record_function("bench.step"):
                work = run.driver.step(run)
            t = time.perf_counter()
            inside = t - t0 <= run.seconds
            if run.world > 1:
                inside = run.driver.agree(run, inside)
            run.units.append({"work": work, "in_window": inside})
            if not inside:
                break
            t_last = t
    run.elapsed = t_last - t0
    if run.device != "cpu":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if prof is not None:
        prof.__exit__(None, None, None)
        run.trace = Trace.from_profiler(prof)


def window_units(run: Run) -> list:
    return [u for u in run.units if u["in_window"]]


def rate(run: Run) -> float:
    """Work completed in the window a second of it."""
    units = window_units(run)
    if not units or run.elapsed <= 0:
        raise RuntimeError("no unit of work completed inside the window")
    return sum(u["work"] for u in units) / run.elapsed


class Trace:
    """The traced window reduced: device time by kernel name, the busy
    time (the union of device activity), and the idle gaps named by the
    innermost host operation running when each began."""

    def __init__(self, host: list, dev: list, w0: int, w1: int):
        """``host`` and ``dev``: (start_ns, end_ns, name) of the host's
        operations and the device's activity; [w0, w1) the window."""
        dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev
               if e > w0 and s < w1]
        self.window_s = (w1 - w0) * 1e-9
        self.kernels: dict = {}
        for s, e, n in dev:
            tot, cnt = self.kernels.get(n, (0.0, 0))
            self.kernels[n] = (tot + (e - s) * 1e-9, cnt + 1)
        busy, gaps, cur_s, cur_e = 0, [], None, w0
        for s, e, _ in sorted(dev):
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, w1))
        self.busy_s = busy * 1e-9
        self.gaps = self._name_gaps(host, [g for g in gaps if g[1] > g[0]])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        host, dev = [], []
        w0 = w1 = None
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                if e.name() == "bench.window":
                    w0, w1 = start, end
                host.append((start, end, e.name()))
            elif not (e.is_user_annotation() or e.name().startswith("bench.")):
                # the device's own activity; the host's spans mirrored
                # on the device timeline are not
                dev.append((start, end, e.name()))
        if w0 is None:
            raise RuntimeError("the trace holds no bench.window span")
        return cls(host, dev, w0, w1)

    @staticmethod
    def _name_gaps(host: list, gaps: list, longest: int = 300) -> dict:
        """Total idle seconds by the innermost host operation covering
        each gap's start, over the ``longest`` gaps."""
        host.sort()
        starts = [h[0] for h in host]
        out: dict = {}
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
            i = bisect.bisect_right(starts, g0)
            best = None
            for j in range(i - 1, max(-1, i - 3000), -1):
                s, e, n = host[j]
                if e >= g0 and n not in ("bench.window",) and (
                        best is None or e - s < best[1] - best[0]):
                    best = (s, e, n)
            name = best[2] if best else "host, no recent operation"
            out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
        return out

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern, re.IGNORECASE)
        return sum(t for n, (t, _) in self.kernels.items() if rx.search(n))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], t] for n, (t, _) in ops],
                "idle_gaps": [[n[:200], t] for n, t in gaps]}


def per_layer(run: Run, entries: list) -> dict:
    out = {}
    for entry in entries:
        value = load_module("metrics", entry["name"]).read(run, run.trace)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def cell_metrics(cell: str, man: dict) -> tuple:
    """(end-to-end, per-layer) entries of ``BENCHMARK.json`` that this
    cell reports."""
    def mine(e):
        return cell in e.get("workloads", [cell])
    return ([e for e in man["end_to_end"] if mine(e)],
            [e for e in man["per_layer"] if mine(e)])


def judge(checks: list) -> tuple:
    """(correct, {name: {value, limit}}) of (name, value, limit)
    readings; a reading that is not a number fails."""
    ok = True
    table = {}
    for name, value, limit in checks:
        good = value == value and limit is not None and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
    return ok and bool(checks), table


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float = None, man: dict = None,
             workload: dict = None, model: dict = None, rank: int = 0,
             world: int = 1, port: int = 0) -> dict:
    """Set up, measure and check one run; the result's fields (on every
    rank of a cell that runs one rank a card; rank 0's are the run's)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = man or manifest()
    run = Run(cell, seed, seconds, trace, device, workload, model,
              rank=rank, world=world, port=port)
    note(f"imports {time.perf_counter() - t_start:.3f} s")
    run.driver.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t_start
    note(f"set-up {run.setup_s:.3f} s")
    t = time.perf_counter()
    measure(run)
    note(f"window and trace {time.perf_counter() - t:.3f} s, "
         f"{len(run.units)} units")
    e2e, layer = cell_metrics(cell, man)
    if trace:
        metrics = per_layer(run, layer)
    else:
        metrics = {}
        values = {"setup_s": run.setup_s, run.driver.E2E: rate(run)}
        for e in e2e:
            metrics[e["name"]] = {"value": values[e["name"]],
                                  "unit": e["unit"]}
    t = time.perf_counter()
    info = device_info(run)
    readings = run.driver.check(run)       # a collective on every rank
    correct, checks = judge(readings) if run.rank == 0 else (False, {})
    note(f"check {time.perf_counter() - t:.3f} s")
    out = {"correct": correct,
           "attempted": len(run.units),
           "failed": 0,
           "metrics": metrics,
           "device": info}
    if trace:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def note(msg: str) -> None:
    print(f"[bench {time.perf_counter() - T0:8.3f}] {msg}", file=sys.stderr,
          flush=True)


def device_info(run: Run) -> dict:
    """The run's device block: the peak of the fullest card; busy and
    window seconds averaged over the cards (every rank takes part)."""
    chips = run.workload.get("chips", 1)
    tr = run.trace
    ranks = run.gather((run.peak_bytes, tr and tr.busy_s, tr and tr.window_s))
    if run.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    else:
        import torch
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(max(r[0] for r in ranks))}
    if tr is not None:
        info["busy_s"] = sum(r[1] for r in ranks) / len(ranks)
        info["window_s"] = sum(r[2] for r in ranks) / len(ranks)
    return info


def free(*names, state: dict) -> None:
    """Drop the program's objects and return their memory to the card."""
    for n in names:
        state.pop(n, None)
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
