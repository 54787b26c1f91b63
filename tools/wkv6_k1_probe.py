#!/usr/bin/env python3
"""Design probes for K7 (the WKV6 two-level chunk scan) and K1 (per-bucket
min/max) on one NVIDIA card.

    python3 tools/wkv6_k1_probe.py            # from the repository root

Builds ``libwkv6.so`` and ``libquant.so`` with ``-Xptxas -v`` (registers,
shared memory and spills of every kernel), then:

  * K7 against its plain version (rtol = atol = 1e-4, out and state) at
    one chunk, at 11 chunks (not a multiple of any group size), at the
    JAX tests' shapes and at (1, 40, 8192, 64), in the JAX tests' decays
    and rwkv6-3b's, for every group size G in {4, 8, 16};
  * two K7 calls of different shapes back to back, both against plain;
  * K1 bit for bit against its plain version on buckets holding NaN,
    +Inf and -Inf, over calls of different bucket counts;
  * times (CUDA events around runs of back-to-back calls, so the host's
    launch overhead hides behind the queue): K7 at the rwkv6-3b prefill
    layer (B 1, H 40, S 32768, K 64) for each G, in turns (4, 8, 16, 16,
    8, 4), and its three passes' device times from torch.profiler; K1 on
    its grid of four waves and on one wave against ``torch.aminmax`` at
    the serve (111 buckets of 4 Mi) and train (31) shapes, four rounds in
    turns, and K1 and ``torch.aminmax`` again timed one call a sample.

Prints one JSON object per result.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-4
PREFILL = (1, 40, 32_768, 64)


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def build_verbose() -> None:
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.wkv6 import kernel as wk
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for src, lib in ((wk.SOURCE, wk.LIBRARY),
                                    (qk.SOURCE, qk.LIBRARY))]
    for p in procs:
        out, _ = p.communicate()
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "error", "warning")):
                print("[ptxas] " + line.strip(), flush=True)
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{out}")


def draw(torch, shape, regime: str, seed: int):
    b, h, s, k = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*sh):
        return torch.randn(sh, generator=g, device="cuda")

    r, kk, v = (n(b, h, s, k) * 0.5 for _ in range(3))
    if regime == "model":
        lw = -torch.exp(-6.0 + 0.3 * torch.tanh(n(b, h, s, k)))
    else:
        lw = -torch.exp(n(b, h, s, k) * 0.5 - 2.0)
    return r, kk, v, lw, n(h, k) * 0.1


def time_ms(torch, fn, reps: int, sample_ms: float = 5.0) -> float:
    """Median time of one call: each of ``reps`` samples times a run of
    back-to-back calls (about ``sample_ms`` of work) between two CUDA
    events, so the host's launch overhead hides behind the queue."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    z.record()
    z.synchronize()
    n = max(1, min(64, int(sample_ms / max(a.elapsed_time(z), 1e-3)) + 1))
    if sample_ms <= 0:
        n = 1
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z) / n)
    return sorted(times)[len(times) // 2]


def k7_checks(torch) -> None:
    from repro_torch.kernels.wkv6 import kernel as wk
    shapes = [(1, 3, 64, 32), (2, 2, 128, 64), (1, 4, 128, 32),
              (2, 1, 192, 64), (1, 2, 704, 64), (1, 40, 8192, 64)]
    for group in (4, 8, 16):
        wk.GROUP_CHUNKS = group
        for i, shape in enumerate(shapes):
            for regime in ("tests", "model"):
                x = draw(torch, shape, regime, seed=100 * group + 10 * i)
                wk.reset_launches()
                out, st = wk.wkv6_bhsk(*x)
                torch.cuda.synchronize()
                want_o, want_s = wk.wkv6_plain(*x, chunk=64)
                err = max(float((out - want_o).abs().max()),
                          float((st - want_s).abs().max()))
                ok = (torch.allclose(out, want_o, rtol=TOL, atol=TOL)
                      and torch.allclose(st, want_s, rtol=TOL, atol=TOL)
                      and wk.wkv6_bhsk.launches == 1)
                emit({"check": "k7", "group": group,
                            "shape": list(shape), "regime": regime,
                            "max_abs_err": err, "ok": ok})
                if not ok:
                    raise AssertionError(f"K7 != plain at {shape}")
    wk.GROUP_CHUNKS = 16
    # back to back, different shapes: no scratch or state leaks
    xa = draw(torch, (1, 40, 8192, 64), "model", seed=7)
    xb = draw(torch, (2, 3, 320, 32), "tests", seed=8)
    ga, gb = wk.wkv6_bhsk(*xa), wk.wkv6_bhsk(*xb)
    for x, got in ((xa, ga), (xb, gb)):
        want = wk.wkv6_plain(*x, chunk=64)
        if not all(torch.allclose(g, w, rtol=TOL, atol=TOL)
                   for g, w in zip(got, want)):
            raise AssertionError("K7 back to back != plain")
    emit({"check": "k7 back to back", "ok": True})


def k1_checks(torch) -> None:
    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.quant import ref
    g = torch.Generator(device="cuda").manual_seed(3)
    for nb, r in ((7, 64), (3, 2048), (111, 16), (1, 1), (5, 3)):
        x = torch.randn((nb, r, 512), generator=g, device="cuda")
        x[0, 0, 5] = float("nan")
        if nb > 1:
            x[1, r - 1, 511] = float("inf")
        if nb > 2:
            x[2, r // 2, 0] = float("-inf")
        qk.reset_launches()
        got = qk.minmax_bucketed(x)
        lo, hi = ref.minmax_bucketed(x)
        want = torch.stack([lo, hi], dim=1)
        nan = want.isnan()
        ok = (torch.equal(got.isnan(), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32))
            and qk.minmax_bucketed.launches == 1)
        emit({"check": "k1", "buckets": nb, "rows": r, "ok": ok})
        if not ok:
            raise AssertionError(f"K1 != plain at {(nb, r)}")


def k7_times(torch) -> None:
    from repro_torch.kernels.wkv6 import kernel as wk
    x = draw(torch, PREFILL, "model", seed=200)
    res = {}
    for group in (4, 8, 16, 16, 8, 4):
        wk.GROUP_CHUNKS = group
        ms = time_ms(torch, lambda: wk.wkv6_bhsk(*x), reps=5)
        res.setdefault(group, []).append(ms)
    for group, ms in res.items():
        emit({"time": "k7", "shape": list(PREFILL), "group": group,
                    "ms": ms, "scratch_bytes": wk.scratch_bytes(
                        *PREFILL, group=group)})
    # the three passes' device times (torch.profiler, CUPTI)
    from torch.profiler import ProfilerActivity, profile
    for group in (8, 16):
        wk.GROUP_CHUNKS = group
        wk.wkv6_bhsk(*x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                wk.wkv6_bhsk(*x)
            torch.cuda.synchronize()
        per = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if t and "wkv6" in ev.key:
                per[ev.key[:60]] = t / 3 / 1e3          # ms a call
        emit({"profile": "k7 passes", "group": group, "ms": per})
    wk.GROUP_CHUNKS = 16
    del x
    torch.cuda.empty_cache()


def k1_times(torch) -> None:
    from repro_torch.kernels.quant import kernel as qk
    lib = qk._load()
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, nb in (("serve", 111), ("train", 31)):
        x3 = torch.randn((nb, 8192, 512), generator=g, device="cuda")
        x2 = x3.view(nb, -1)
        cap = x2.shape[1]
        four = lib.quant_k1_blocks(nb, cap)
        one = max(1, four // 4)
        want = qk.minmax_bucketed(x3)
        tickets = qk._tickets(x3.device, nb)

        def k1_one_wave():
            partial = torch.empty((nb, one, 2), device="cuda")
            out = torch.empty((nb, 2), device="cuda")
            err = lib.quant_minmax_bucketed(
                x3.data_ptr(), partial.data_ptr(), tickets.data_ptr(),
                out.data_ptr(), nb, cap, one,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K1 launch failed: {err}")
            return out

        if not torch.equal(k1_one_wave(), want):
            raise AssertionError("K1 on one wave != K1 on four")
        runs = {"aminmax": lambda: torch.aminmax(x2, dim=1),
                f"k1 four waves ({four} blocks a bucket)":
                    lambda: qk.minmax_bucketed(x3),
                f"k1 one wave ({one} blocks a bucket)": k1_one_wave}
        res = {k: [] for k in runs}
        for rnd in range(4):
            order = list(runs) if rnd % 2 == 0 else list(runs)[::-1]
            for k in order:
                res[k].append(time_ms(torch, runs[k], 20))
        # one call a sample (chip_smoke's earlier timing): the host's time
        # to launch the call counts too
        single = {k: [time_ms(torch, runs[k], 20, sample_ms=0.0)
                      for _ in range(2)] for k in list(runs)[:2]}
        emit({"time": "k1", "shape": name, "buckets": nb,
                    "ms": res, "one_call_a_sample_ms": single,
                    "bound_ms": x2.numel() * 4 / 3.35e12 * 1e3})
        del x3, x2
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wkv6_k1_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_verbose()
    k7_checks(torch)
    k1_checks(torch)
    k7_times(torch)
    k1_times(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
