"""The frozen reference against published test vectors and, at tiny
sizes on the CPU, against the program (``repro_torch``)."""
from __future__ import annotations

import pytest
import torch

import harness
from reference import layout, model, quant, threefry
import tiny


@pytest.mark.parametrize("key, ctr, want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    """Random123's known-answer vectors for Threefry-2x32, 20 rounds."""
    assert threefry.hash2x32(*key, *ctr) == want


def test_uniform_and_fold_in_equal_the_program_bits():
    from repro_torch.core import prng
    key = threefry.fold_in(threefry.key_of_seed(2 ** 32 - 5), 7)
    pkey = prng.fold_in(prng.PRNGKey(2 ** 32 - 5), 7)
    assert key == tuple(int(w) for w in pkey.tolist())
    assert torch.equal(threefry.uniform(key, 5000, "cpu"),
                       prng.uniform(pkey, (5000,)))


@pytest.mark.parametrize("total", [5000, 1024, 3])
def test_rq4_qdq_equals_the_program_bit_for_bit(total):
    from repro_torch.core import prng
    from repro_torch.kernels.quant import ops
    g = torch.Generator().manual_seed(total)
    flat = torch.randn(total, generator=g) * 0.01
    flat[total // 2] = 0.3
    got = quant.qdq(flat, threefry.key_of_seed(11), bucket_elems=2048)
    want = ops.qdq_flat(flat.clone(), prng.PRNGKey(11), bits=4,
                        bucket_elems=2048)
    assert torch.equal(got, want)


def _tiny_weights(config: str, seed: int = 3):
    import inputs
    m = tiny.model(config)
    return m, inputs.weights(m, seed, "cpu")


@pytest.mark.parametrize("config", ["qwen1.5-0.5b", "granite-8b"])
def test_prefill_reference_agrees_with_the_program(config):
    import port
    from repro_torch.train import steps
    m, W = _tiny_weights(config)
    cfg = port.model_config(m)
    toks = torch.randint(0, m["vocab"], (2, 96),
                         generator=torch.Generator().manual_seed(1))
    prog = steps.make_prefill_step(cfg, use_flash=True, scan_layers=True,
                                   logits_positions="last")(
        port.param_tree(W), {"tokens": toks})
    ref = model.last_logits(W, m, toks, q_block=32)
    assert torch.allclose(prog, ref, rtol=0, atol=1e-5 * ref.abs().max())


def test_train_reference_follows_the_program_steps():
    cell = "train.qwen1.5-0.5b.rq4ef"
    got = tiny.run(cell, seed=5)["checks"]
    assert got["loss"]["value"] < 1e-5
    assert got["grad_norm"]["value"] < 1e-3
    assert got["update_norm"]["value"] < 1e-3


def test_the_message_lays_the_leaves_out_in_the_program_order():
    from repro_torch.core import compression
    m, W = _tiny_weights("qwen1.5-0.5b")
    import port
    leaves = compression.FlatLayout.from_tree(port.param_tree(W))
    order = layout.flat_order(m)
    assert [tuple(s) for s in leaves.shapes] == \
        [tuple(W[n].shape) for n in order]


def test_ring_allreduce_equals_the_programs_stacked_ring_bit_for_bit():
    from repro_torch.core import communicators, prng
    from reference import ring
    g = torch.Generator().manual_seed(4)
    grad = {"a": torch.randn(4, 3000, generator=g) * 0.01,
            "b": {"c": torch.randn(4, 7, 5, generator=g)}}
    key = prng.fold_in(prng.PRNGKey(2 ** 31 + 9), 2)
    upd, _ = communicators.CSGDRingExchange(compressor="rq4")(grad, (), key)
    flats = [torch.cat([grad["a"][w], grad["b"]["c"][w].reshape(-1)])
             for w in range(4)]
    want = ring.allreduce(flats, tuple(int(x) for x in key.tolist()))
    for w in range(4):
        got = torch.cat([upd["a"][w], upd["b"]["c"][w].reshape(-1)])
        assert torch.equal(got, want)
