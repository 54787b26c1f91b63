"""The cells ``prefill.deepseek-v2-lite.4k-16k`` (driver ``prefill_moe``)
and ``train.qwen1.5-0.5b.none`` (driver ``train_plain``) at a tiny size
on the CPU: DeepSeek-V2-Lite as the program's smoke-test variant (the
driver fills the reference's sizes in from it), the codec-free step on
the train cell's tiny traffic. A sound run passes, each planted fault
and the control fail a limit, the traced run reads the new per-layer
metrics; and the new yardstick's counts by hand."""
from __future__ import annotations

import copy

import pytest

import faults
import harness
import tiny
import yardstick_moe

DS = "prefill.deepseek-v2-lite.4k-16k"
PLAIN = "train.qwen1.5-0.5b.none"


def _workload(cell: str) -> dict:
    w = copy.deepcopy(harness.load_json("workloads", f"{cell}.json"))
    if w["driver"] == "train_plain":
        w["traffic"].update(batch=2, seq=32)
    else:
        w["traffic"].update(min_len=64, max_len=256, n_lengths=4,
                            multiple=32, ref_q_block=64)
    return w


def _model(cell: str) -> dict:
    w = _workload(cell)
    if w["driver"] == "train_plain":
        return tiny.model(w["config"])
    m = harness.load_json("configs", f"{w['config']}.json")["model"]
    return dict(m, smoke=True)


def _run(cell: str, *, trace=False, fault=None, seed=7):
    # windows long enough that a unit completes inside one while other
    # test processes load the CPU
    seconds = 3.0 if cell == DS else 5.0
    planted = faults.planted(fault) if fault else tiny._planted(None)
    with planted:
        return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                                workload=_workload(cell),
                                model=_model(cell))


def test_a_sound_deepseek_prefill_is_correct_and_traced_reads_its_metrics():
    r = _run(DS)
    assert r["correct"], r["checks"]
    r = _run(DS, trace=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for name in ("mfu.moe_prefill", "experts_share.prefill",
                 "dispatch_share.prefill", "expert_load.prefill",
                 "mixer_share.prefill", "device_idle.prefill"):
        assert name in got, (name, got)
    assert "mla_roofline.prefill" not in got      # no K6 on the CPU
    assert got["expert_load.prefill"]["value"] >= 1.0
    assert 0 < got["experts_share.prefill"]["value"] < 100


def test_a_sound_plain_train_run_follows_the_reference():
    got = _run(PLAIN, seed=5)["checks"]
    assert got["loss"]["value"] < 1e-5
    assert got["grad_norm"]["value"] < 1e-3
    assert got["update_norm"]["value"] < 1e-3


@pytest.mark.parametrize("cell, fault", [(DS, "token"),
                                         (PLAIN, "unchanged"),
                                         (PLAIN, "half_batch")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert not r["correct"], r["checks"]


def test_the_control_fails_a_limit():
    w = _workload(PLAIN)
    run = harness.Run(PLAIN, 9, 0.0, False, "cpu", w, _model(PLAIN))
    got = run.driver.control(run)
    assert any(v > run.limits[n] for n, v in got.items()), got


def test_the_control_reads_far_above_a_sound_tiny_run():
    """DeepSeek's limit was set at the cell's size, where 27 layers and
    their routing amplify a rounding difference (the TF32 control reads
    1.5e-2-2.7e-2 there); the 2-layer smoke model's control reads ~2e-3,
    still two orders of magnitude above its sound runs (~1e-6)."""
    w = _workload(DS)
    run = harness.Run(DS, 9, 0.0, False, "cpu", w, _model(DS))
    assert run.driver.control(run)["logits"] > 100 * 1e-5
    assert _run(DS)["checks"]["logits"]["value"] < 1e-5


def test_moe_counts_by_hand():
    m = {"n_layers": 3, "d_model": 4, "n_heads": 2, "vocab": 10,
         "kv_lora_rank": 3, "qk_nope_head_dim": 2, "qk_rope_head_dim": 1,
         "v_head_dim": 2, "first_k_dense": 1, "d_ff": 5, "n_experts": 4,
         "top_k": 2, "d_ff_expert": 3, "n_shared": 1}
    # MLA a layer: q 4 x 6, kv_a 4 x 4, k_b 3 x 4, v_b 3 x 4, o 4 x 4
    mla = 24 + 16 + 12 + 12 + 16
    # dense layer 3 x 4 x 5; a MoE layer: router 4 x 4, 3 experts of 3 x 4 x 3
    assert yardstick_moe.active_params(m) == 3 * mla + 60 + 2 * (16 + 108)
    # 2 (3 + 2) flops a causal (head, query, key), 2 heads, 3 layers
    assert yardstick_moe.attention_flops(m, 3) == 10 * 6 * 2 * 3
    assert yardstick_moe.prefill_flops(m, 3) == \
        2 * yardstick_moe.active_params(m) * 3 + 2 * 40 + 360
    # one layer at S = 3: flops 10 * 6 * 2, bytes 4 * 3 * 2 * (6 + 4)
    assert yardstick_moe.mla_bound_s(m, 3) == max(
        120 / yardstick_moe.PEAK_FP32_FLOPS,
        240 / yardstick_moe.HBM_BYTES_PER_S)
