"""The port on the card: the three CUDA codec kernels against their plain
versions, and the serving path on ``cuda``. Every test needs an NVIDIA
card (``cuda`` marker) and skips without one.

This file imports neither jax nor ``repro``, so it runs on a CUDA host
without JAX, skipping the suite's conftest (which imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import serve
from repro_torch.core import pytree
from repro_torch.kernels.quant import kernel, ops
from repro_torch.models import transformer_scan as tts
from repro_torch.core import prng

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card: "
                    "python3 chip_smoke.py)")
    return torch.device("cuda")


def _data(n, seed=0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=n)
                             * 0.05).astype(np.float32))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("n,be", [(3 * 4096 + 1234, 4096), (77, 4096),
                                  (300_001, 1 << 22)])
def test_cuda_kernels_bit_equal_to_cpu_plain(card, bits, n, be):
    """encode_flat / decode_flat through K1-K3 on the card give the CPU
    plain versions' payload, params and decoded values, bit for bit."""
    x = _data(n, seed=n)
    kernel.reset_launches()
    pay, par = ops.encode_flat(x.to(card), prng.PRNGKey(4), bits=bits,
                               bucket_elems=be)
    dec = ops.decode_flat(pay, par, total=n, bits=bits, bucket_elems=be)
    assert all(v > 0 for v in kernel.launch_counts().values())
    cpay, cpar = ops.encode_flat(x, prng.PRNGKey(4), bits=bits,
                                 bucket_elems=be)
    cdec = ops.decode_flat(cpay, cpar, total=n, bits=bits, bucket_elems=be)
    assert torch.equal(pay.cpu(), cpay)
    assert torch.equal(par.cpu().view(torch.int32), cpar.view(torch.int32))
    assert torch.equal(dec.cpu().view(torch.int32), cdec.view(torch.int32))


def test_wrappers_refuse_bad_cuda_inputs(card):
    x = torch.zeros((2, 1, 512), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.minmax_bucketed(torch.zeros((2, 2, 512), device=card)[:, :1])
    with pytest.raises(ValueError, match="expected"):
        kernel.encode_packed(x.view(2, 1, 1, 512), x.view(2, 1, 1, 512),
                             torch.zeros((2, 2)), bits=8)        # CPU params
    with pytest.raises(TypeError, match="dtype"):
        kernel.decode_packed(torch.zeros((1, 1, 512), device=card),
                             torch.zeros((1, 2), device=card), bits=8)


def test_serving_on_the_card_swaps_and_matches_a_cold_start(card):
    cfg = serve.ServeConfig(slots=2, max_len=32, prompt_len=6, n_requests=3,
                            mixed_gen=(3, 5), seed=1)
    eng = serve.Engine(cfg)                         # cuda by default
    assert eng.device.type == "cuda"
    ch = serve.CheckpointChannel()
    eng.subscribe(ch)
    for r in serve.synthetic_requests(cfg):
        eng.submit(r.tokens, r.max_new_tokens, rid=r.rid)
    eng.step()
    new = tts.init(eng.model_cfg, tts.generator(5, card))
    kernel.reset_launches()
    pub = ch.publish(new, step=1)
    eng.run()
    assert eng.counters["swaps"] == 1 and eng.counters["completed"] == 3
    assert all(v > 0 for v in kernel.launch_counts().values())
    # the card's publish equals the CPU's, byte for byte
    cpu = serve.CheckpointChannel().publish(
        pytree.tree_map(lambda a: a.cpu(), new), step=1)
    assert pub.crc == cpu.crc
    assert torch.equal(pub.packed.payload.cpu(), cpu.packed.payload)
    prompt = np.arange(6, dtype=np.int32)
    rid = eng.submit(prompt, 4)
    eng.run()
    cold = serve.Engine(cfg, params=serve.CheckpointChannel.decode(pub))
    cid = cold.submit(prompt, 4)
    cold.run()
    assert eng.result(rid).tokens == cold.result(cid).tokens
