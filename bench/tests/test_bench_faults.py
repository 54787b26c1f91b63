"""A whole run at a tiny size on the CPU (the harness's look for a card
skipped): a broken timed path and the control come out not correct
under each cell's own limits, and a sound prefill comes out correct.
(The training limits were set at the cell's size: in a 2-layer model
one stochastic-rounding flip weighs more, so a sound tiny training run
is held to the looser bounds of ``test_bench_reference``.)"""
from __future__ import annotations

import pytest

import harness
import tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _driver(cell):
    return harness.load_json("workloads", f"{cell}.json")["driver"]


def _faults(cell):
    return harness.load_module("drivers", _driver(cell)).FAULTS


PREFILL = [c for c in CELLS if _driver(c) == "prefill"]


@pytest.mark.parametrize("cell", PREFILL)
def test_a_sound_run_is_correct(cell):
    r = tiny.run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS
                                         for f in _faults(c)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = tiny.run(cell, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    w = tiny.workload(cell)
    run = harness.Run(cell, 9, 0.0, False, "cpu", w, tiny.model(w["config"]))
    got = run.driver.control(run)
    assert any(v > run.limits[n] for n, v in got.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", PREFILL)
def test_a_tiny_run_on_the_card_is_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = tiny.workload(cell)
    r = harness.run_cell(cell, 4, 0.5, True, device="cuda", workload=w,
                         model=tiny.model(w["config"]))
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0


@pytest.mark.parametrize("mode", ["program", "control", "fault:token"])
def test_calibration_reads_each_side(mode):
    import calibrate
    cell = "prefill.qwen1.5-0.5b.8k-32k"
    w = tiny.workload(cell)
    got = calibrate.reading(cell, 3, mode, 1.0, device="cpu", workload=w,
                            model=tiny.model(w["config"]))
    value = got["logits"]
    assert (value < w["limits"]["logits"]) == (mode == "program")
