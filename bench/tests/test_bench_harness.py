"""The manifest against its files, the contract's names and units, the
yardstick's counts by hand, the replay set and the trace reduction."""
from __future__ import annotations

import json
import re

import pytest

import harness
import yardstick

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
LAYER_METRICS = [m["name"] for m in MAN["per_layer"]]


def test_manifest_has_exactly_the_contract_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    wl = harness.load_json("workloads", f"{cell}.json")
    assert wl["config"] == entry["config"]
    assert wl["chips"] == entry["chips"] in (1, 4)
    cfg_entry = next(c for c in MAN["configs"]
                     if c["name"] == entry["config"])
    assert cfg_entry["file"] == f"bench/configs/{entry['config']}.json"
    drv = harness.load_module("drivers", wl["driver"])
    for fn in ("setup", "step", "check", "control"):
        assert callable(getattr(drv, fn))
    e2e, layer = harness.cell_metrics(cell, MAN)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and drv.E2E in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", LAYER_METRICS)
def test_per_layer_metric_resolves_to_its_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_names_units_and_lines_keep_to_the_contract():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads",
                                          "per_layer"):
                    v = e[key]
                    assert 1 <= len(v) <= 200 and "\n" not in v \
                        and "\t" not in v
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            if "source" in e and group != "configs":
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    by = {m["name"]: m for m in MAN["end_to_end"]}
    assert by["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in by
        assert "bound" not in m
        for cell in m.get("workloads", []):
            assert cell in CELLS
            assert cell in by[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_file_states_the_published_numbers_it_runs(config):
    f = harness.load_json("configs", f"{config}.json")
    m = f["model"]
    entry = next(c for c in MAN["configs"] if c["name"] == config)
    assert entry["reduced"] == f["reduced"]
    assert entry["source"].startswith(f["source"].split(" ")[0])
    assert (f["hidden_size"], f["intermediate_size"],
            f["num_hidden_layers"], f["num_attention_heads"],
            f["num_key_value_heads"], f["vocab_size"], f["rope_theta"],
            f["rms_norm_eps"], f["tie_word_embeddings"]) == \
        (m["d_model"], m["d_ff"], m["n_layers"], m["n_heads"],
         m["n_kv_heads"], m["vocab"], m["rope_theta"], m["norm_eps"],
         m["tie_embeddings"])
    assert m["head_dim"] * m["n_heads"] == m["d_model"]
    for width in ("hidden_size", "intermediate_size", "head_dim"):
        assert width not in f["reduced"]


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_program_runs_the_numbers_of_the_config_file(config):
    import port
    m = harness.load_json("configs", f"{config}.json")["model"]
    cfg = port.model_config(m)
    assert cfg.param_count() == yardstick.param_count(m)


TINY = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
        "head_dim": 4, "d_ff": 16, "vocab": 10, "qkv_bias": True,
        "tie_embeddings": True}


def test_counts_by_hand():
    # a layer: q 8x8, k 8x4, v 8x4, o 8x8, up/gate 8x16, down 16x8
    assert yardstick.matmul_params(TINY) == 2 * (64 + 32 + 32 + 64
                                                 + 3 * 128)
    assert yardstick.head_params(TINY) == 80
    assert yardstick.causal_pairs(3) == 6
    # 4 D flops a pair, 2 q heads, 2 layers, S = 3
    assert yardstick.attention_fwd_flops(TINY, 3) == 4 * 4 * 6 * 2 * 2
    n = 1152 + 80
    assert yardstick.train_step_flops(TINY, 2, 3) == \
        6 * n * 6 + 3 * 2 * 384
    assert yardstick.prefill_flops(TINY, 3) == 2 * 1152 * 3 + 2 * 80 + 384
    # K6 on a layer of S = 3: flops 4*4*6*2 = 192, bytes 4*3*4*(4+2) = 288
    assert yardstick.k6_bound_s(TINY, 3) == max(
        192 / yardstick.PEAK_FP32_FLOPS, 288 / yardstick.HBM_BYTES_PER_S)
    # a message of 5,000 elements: one bucket of 5,120
    assert yardstick.k4_bytes(5000) == 8 * 5000 + 8
    assert yardstick.k4_bytes((1 << 22) + 1) == 8 * ((1 << 22) + 1) + 16
    assert yardstick.PEAK_FP32_FLOPS == 165e12
    assert yardstick.param_count(TINY) == 1152 + 80 + 8 + 2 * 2 * 8 \
        + 2 * (8 + 4 + 4)


def test_replay_set_is_fixed_and_every_prefix_of_a_cycle_mixes():
    drv = harness.load_module("drivers", "prefill")
    t = harness.load_json("workloads",
                          "prefill.qwen1.5-0.5b.8k-32k.json")["traffic"]
    ls = drv.lengths(t)
    assert ls[0] == t["min_len"] and ls[-1] == t["max_len"]
    assert len(ls) == t["n_lengths"] and all(x % t["multiple"] == 0
                                             for x in ls)
    c = drv.cycle(t)
    assert sorted(c) == ls
    for i in range(0, len(c), 2):
        assert (c[i], c[i + 1]) == (ls[-1 - i // 2], ls[i // 2])


def test_trace_reduction_by_hand():
    host = [(0, 100, "bench.window"), (0, 40, "bench.step"),
            (5, 30, "aten::mm"), (40, 100, "bench.step"),
            (45, 90, "cudaDeviceSynchronize")]
    dev = [(10, 20, "gemm_a"), (15, 25, "gemm_a"), (50, 60, "qdq_kernel"),
           (95, 130, "gemm_b")]
    tr = harness.Trace(host, dev, 0, 100)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(30e-9)      # 10-25, 50-60, 95-100
    assert tr.kernel_s("gemm") == pytest.approx(25e-9)  # clipped at 100
    assert tr.kernel_s(yardstick.K4_KERNEL) == pytest.approx(10e-9)
    # gaps 0-10 under a step, 25-50 inside aten::mm, 60-95 in the sync
    assert tr.gaps == pytest.approx({"bench.step": 10e-9,
                                     "aten::mm": 25e-9,
                                     "cudaDeviceSynchronize": 35e-9})
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "gemm_a"
    assert json.dumps(bd)


def test_judge_needs_every_number_under_its_limit():
    assert harness.judge([("a", 1.0, 2.0), ("b", 0.0, 0.0)])[0]
    assert not harness.judge([("a", 3.0, 2.0)])[0]
    assert not harness.judge([("a", float("nan"), 2.0)])[0]
    assert not harness.judge([("a", 1.0, None)])[0]
    assert not harness.judge([])[0]


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_the_weights_fill_the_programs_parameter_tree(config):
    """The tree the prefill and ring drivers hand the program (checked
    here once, not in every run: the program's abstract init costs
    seconds of set-up)."""
    import torch

    import port
    from reference import layout
    from repro_torch.models import layers, transformer_scan
    m = harness.load_json("configs", f"{config}.json")["model"]
    W = {n: torch.empty(s, device="meta")
         for n, s in layout.shapes(m).items()}
    want = transformer_scan.init(port.model_config(m),
                                 layers.MetaGenerator())
    port.check_tree(port.param_tree(W), want)
