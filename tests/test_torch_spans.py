"""The port's spans (``repro_torch.obs.span``) in the train step, the
prefill's blocks and the partitioned ring exchange on ranks.

With tracing off and no profiler running nothing is recorded. Under
``torch.profiler`` (CPU) a tiny train step records its five phases under
one ``train.step``, a prefill one ``block.mixer`` and one ``block.ffn``
a layer under ``prefill.step``, and a 2-rank gloo ring exchange its
encode, N-1 hops (each one ``comm.sendrecv`` of the bytes the axis
counted), N-1 gathers and a decode; each span is a host range of the
profiler's own trace, starting within 5 ms of the record's start; and
the results are bit for bit those of the untraced run. The ranks run
this file in their own processes, started at once by a module fixture:

    PYTHONPATH=src python tests/test_torch_spans.py rank RDV RANK OUT

This file imports neither jax nor ``repro``; its card test runs with
``python -m pytest -q --noconftest -m cuda tests/test_torch_spans.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import communicators, prng, pytree
from repro_torch.launch import train as launcher
from repro_torch.models import transformer_scan
from repro_torch.obs import trace
from repro_torch.train import steps

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
CLOCK_NS = 5_000_000     # a record's start against its profiler range's
PHASES = ["train.forward", "train.backward", "train.clip", "train.compress",
          "train.optimizer"]
TRAIN_ARGV = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
              "--batch", "2", "--seq", "32", "--steps", "4",
              "--compression", "rq4", "--error-feedback", "--remat",
              "--scan-layers"]


@pytest.fixture(autouse=True)
def _clean_tracer():
    obs.disable()
    trace.reset()
    yield
    obs.disable()
    trace.reset()


def _profiled(fn):
    """(fn(), {name: sorted start_ns of the profiler's host ranges})."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(e.start_ns())
    return out, {k: sorted(v) for k, v in ranges.items()}


def _ranges_match(spans: list, ranges: dict) -> None:
    """Every span is a profiler range of its name, starting within
    ``CLOCK_NS`` of the record's start (matched in order by name)."""
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e["t0_ns"])
    for name, starts in by_name.items():
        got = ranges.get(name, [])
        assert len(got) == len(starts), name
        for t0, r0 in zip(sorted(starts), got):
            assert abs(t0 - r0) < CLOCK_NS, (name, t0 - r0)


def _children(spans: list, parent: dict) -> list:
    return sorted((e for e in spans if e["parent"] == parent["id"]),
                  key=lambda e: e["t0_ns"])


def _train():
    prog = launcher.setup(launcher.parse_args(TRAIN_ARGV))
    tok = torch.randint(0, prog["cfg"].vocab, (2, 33),
                        generator=torch.Generator().manual_seed(5))
    return prog, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _leaves_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def train_runs():
    """The same first step untraced and under the profiler: (records
    made off, losses, states, spans, profiler ranges)."""
    obs.disable()
    trace.reset()
    prog, batch = _train()
    state, m_off = prog["train_step"](prog["state"], batch)
    n_off = trace.tracer().n_events
    prog2, _ = _train()
    (state2, m_on), ranges = _profiled(
        lambda: prog2["train_step"](prog2["state"], batch))
    spans = trace.tracer().spans()
    return {"n_off": n_off, "loss": (m_off["loss"], m_on["loss"]),
            "params": (state["params"], state2["params"]),
            "ec": (state["ec_err"], state2["ec_err"]), "spans": spans,
            "ranges": ranges}


def test_an_untraced_train_step_records_nothing(train_runs):
    assert train_runs["n_off"] == 0


def test_a_profiled_train_step_records_its_phases_in_order(train_runs):
    spans = train_runs["spans"]
    roots = [e for e in spans if e["name"] == "train.step"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    assert roots[0]["args"] == {"step": 0}
    phases = _children(spans, roots[0])
    assert [e["name"] for e in phases] == PHASES
    assert all(e["root"] == roots[0]["id"] for e in spans)
    for a, b in zip(phases, phases[1:]):
        assert a["t1_ns"] <= b["t0_ns"]
    # remat recomputes the blocks inside the backward
    back = phases[1]
    assert [e["name"] for e in _children(spans, back)].count(
        "block.mixer") == len(
        [e for e in _children(spans, phases[0]) if e["name"] == "block.mixer"])
    assert [e["name"] for e in _children(spans, phases[3])] == \
        ["quant.qdq_flat"]
    for e in spans:
        assert e["stream_ms"] == pytest.approx(
            (e["t1_ns"] - e["t0_ns"]) * 1e-6)


def test_a_profiled_train_step_is_the_profilers_ranges(train_runs):
    _ranges_match(train_runs["spans"], train_runs["ranges"])


def test_tracing_leaves_the_train_step_bit_for_bit(train_runs):
    lo, lt = train_runs["loss"]
    assert torch.equal(lo.view(torch.int32), lt.view(torch.int32))
    assert _leaves_equal(*train_runs["params"])
    assert _leaves_equal(*train_runs["ec"])


def test_span_stats_reads_the_record():
    prog, batch = _train()
    _profiled(lambda: prog["train_step"](prog["state"], batch))
    tr = trace.tracer()
    for name in PHASES:
        s = tr.span_stats(name)
        assert s.count == 1 and s.stream_s == pytest.approx(s.host_s)
    mix_all = tr.span_stats("block.mixer")
    mix_back = tr.span_stats("block.mixer", under="train.backward")
    assert mix_all.count == 2 * mix_back.count > 0
    assert tr.span_stats("block.mixer", under="train.step") == mix_all
    assert tr.span_stats("nothing") == (0, 0.0, 0.0)


def _prefill():
    from repro_torch import configs
    cfg = configs.get_config("qwen1.5-0.5b").reduced()
    params = transformer_scan.init(cfg, transformer_scan.generator(0))
    fn = steps.make_prefill_step(cfg, use_flash=True, scan_layers=True,
                                 logits_positions="last")
    tok = torch.randint(0, cfg.vocab, (1, 64),
                        generator=torch.Generator().manual_seed(2))
    return cfg, lambda: fn(params, {"tokens": tok})


def test_a_prefill_records_each_blocks_mixer_and_ffn():
    cfg, run = _prefill()
    off = run()
    assert trace.tracer().n_events == 0
    on, ranges = _profiled(run)
    assert torch.equal(off.view(torch.int32), on.view(torch.int32))
    spans = trace.tracer().spans()
    (root,) = [e for e in spans if e["name"] == "prefill.step"]
    kids = _children(spans, root)
    assert [e["name"] for e in kids] == ["block.mixer", "block.ffn"] * \
        cfg.n_layers
    assert sum(e["stream_ms"] for e in kids) <= root["stream_ms"]
    _ranges_match(spans, ranges)


def test_obs_tracing_records_without_a_profiler():
    _, run = _prefill()
    obs.enable(trace=True, metrics=False, flight=False)
    run()
    names = [e["name"] for e in trace.tracer().spans()]
    assert names.count("prefill.step") == 1 and "block.ffn" in names
    doc = trace.tracer().to_chrome_trace()
    assert any(e.get("name") == "prefill.step" and e["ph"] == "X"
               for e in doc["traceEvents"])


def test_a_span_is_a_shared_nullcontext_when_nothing_records():
    assert obs.span("a") is obs.span("b", args={"x": 1})
    assert type(obs.span("a")).__name__ == "nullcontext"
    with obs.span("a"):
        pass
    assert trace.tracer().n_events == 0


def test_a_thread_without_its_own_span_nests_under_the_newest_open():
    import threading
    obs.enable(trace=True, metrics=False, flight=False)
    with obs.span("outer"):
        t = threading.Thread(target=lambda: obs.span("inner").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join()
    spans = {e["name"]: e for e in trace.tracer().spans()}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["inner"]["root"] == spans["outer"]["id"]


# ---------------------------------------------------------------------------
# the ring exchange on 2 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    """Each rank's record of the exchange, untraced and profiled."""
    tmp = tmp_path_factory.mktemp("spans")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "rank", str(tmp / "rdv"), str(r),
         str(tmp / f"rank{r}.pt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_an_untraced_ring_exchange_records_nothing(ring_ranks):
    assert [r["n_off"] for r in ring_ranks] == [0] * WORLD


def test_a_profiled_ring_exchange_records_its_stages(ring_ranks):
    for r in ring_ranks:
        spans = r["spans"]
        (root,) = [e for e in spans if e["name"] == "ring.exchange"]
        assert root["parent"] is None and root["args"] == {"workers": WORLD}
        kids = _children(spans, root)
        assert [e["name"] for e in kids] == \
            ["ring.encode"] + ["ring.hop"] * (WORLD - 1) + \
            ["ring.gather"] * (WORLD - 1) + ["ring.decode"]
        wires = []
        for k in kids:
            sub = [e for e in _children(spans, k)
                   if e["name"] == "comm.sendrecv"]
            assert len(sub) == (k["name"] in ("ring.hop", "ring.gather"))
            wires += sub
        assert [w["args"]["sent_bytes"] for w in wires] == r["sent_by_call"]
        assert all(w["args"]["sent_bytes"] > 0 for w in wires)
        assert [w["args"]["recv_bytes"] for w in wires] == \
            [w["args"]["sent_bytes"] for w in wires]
        assert sum(r["sent_by_call"]) == r["sent"] > 0
        _ranges_match(spans, r["ranges"])


def test_tracing_leaves_the_ring_exchange_bit_for_bit(ring_ranks):
    for r in ring_ranks:
        assert _leaves_equal(r["off"], r["on"])
    assert _leaves_equal(ring_ranks[0]["on"], ring_ranks[1]["on"])


def _rank_main(rdv: str, rank: str, out: str) -> None:
    rank = int(rank)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=WORLD)
    axis = communicators.RankAxis()
    sent_by_call = []
    ppermute = axis.ppermute

    def counted(x, perm):
        before = axis.sent_bytes
        got = ppermute(x, perm)
        sent_by_call.append(axis.sent_bytes - before)
        return got

    axis.ppermute = counted
    g = torch.Generator().manual_seed(100 + rank)
    grad = {"w": torch.randn(37, 129, generator=g) * 0.01,
            "b": torch.randn(4099, generator=g) * 0.01}
    ex = communicators.CSGDRingExchange(compressor="rq4")
    key = prng.PRNGKey(9)
    off, _ = ex(grad, (), key, axis_name=axis)
    n_off = trace.tracer().n_events
    sent_by_call.clear()
    sent0 = axis.sent_bytes
    (on, _), ranges = _profiled(lambda: ex(grad, (), key, axis_name=axis))
    res = {"n_off": n_off, "off": off, "on": on,
           "spans": trace.tracer().spans(), "ranges": ranges,
           "sent": axis.sent_bytes - sent0, "sent_by_call": sent_by_call}
    dist.destroy_process_group()
    torch.save(res, out)


@pytest.mark.cuda
def test_card_spans_read_stream_time_from_cuda_events():
    """On a card a span's stream time is its CUDA events' elapsed time,
    an inner span's inside its outer span's, and the event pairs are
    read when the record is."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev)
    obs.enable(trace=True, metrics=False, flight=False)
    with obs.span("outer"):
        for _ in range(3):
            with obs.span("inner"):
                x = x @ x / 2048
    tr = trace.tracer()
    assert len(tr._pending) == 4
    outer = tr.span_stats("outer")
    inner = tr.span_stats("inner")
    assert not tr._pending
    assert inner.count == 3 and 0 < inner.stream_s <= outer.stream_s


@pytest.mark.cuda
def test_a_card_train_step_records_flash_backward_under_the_backward():
    """On the card the train step's attention takes flash attention
    under autograd: a profiled reduced step (remat, scanned) records
    ``flash_attn.forward`` twice a layer (the forward's and remat's
    recompute, the latter under ``train.backward``) and
    ``flash_attn.backward`` once a layer, all of it under
    ``train.backward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    argv = [a for a in TRAIN_ARGV if a not in ("--device", "cpu")]
    prog = launcher.setup(launcher.parse_args(argv + ["--device", "cuda"]))
    tok = torch.randint(0, prog["cfg"].vocab, (2, 33),
                        generator=torch.Generator().manual_seed(5))
    batch = {"tokens": tok[:, :-1].cuda(), "labels": tok[:, 1:].cuda()}
    _profiled(lambda: prog["train_step"](prog["state"], batch))
    tr = trace.tracer()
    layers = prog["cfg"].n_layers
    assert tr.span_stats("flash_attn.forward").count == 2 * layers
    assert tr.span_stats("flash_attn.forward",
                         under="train.backward").count == layers
    assert tr.span_stats("flash_attn.backward").count == layers
    assert tr.span_stats("flash_attn.backward",
                         under="train.backward").count == layers


if __name__ == "__main__":
    {"rank": _rank_main}[sys.argv[1]](*sys.argv[2:])
