"""repro_torch.serve against repro.serve, on the CPU (plain versions).

  * a checkpoint the JAX ``CheckpointChannel`` publishes is accepted and
    swapped in by the port's engine, and the port publishes the same
    bytes and CRC for the same params and key;
  * greedy (and temperature-1) token streams equal the JAX engine's on
    the same params and requests;
  * within the port: hot-swap with zero drops, hot == cold, corrupt
    checkpoints refused;
  * the package imports no jax and nothing of ``repro``, and its entry
    points refuse to fall back to the CPU without ``device="cpu"``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import compression as jcomp
from repro_torch import interop, serve
from repro_torch.core import compression, pytree
from repro_torch.models import transformer_scan as tts

SRC = Path(__file__).resolve().parents[1] / "src"
BASE = dict(slots=2, max_len=32, prompt_len=6, n_requests=4,
            mixed_gen=(3, 7), seed=1)


@pytest.fixture(scope="module")
def jax_engine_params():
    eng = jserve.Engine(jserve.ServeConfig(**BASE))
    return eng.params


def _port_params(jp):
    return interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab,
                                                size=n).astype(np.int32)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_streams_equal_the_jax_engine(jax_engine_params, temperature, mode):
    kw = dict(BASE, temperature=temperature, mode=mode, n_requests=5)
    jres = jserve.run(jserve.ServeConfig(**kw), params=jax_engine_params)
    tres = serve.run(serve.ServeConfig(**kw),
                     params=_port_params(jax_engine_params), device="cpu")
    assert tres.n_completed == jres.n_completed == 5
    assert tres.decode_steps == jres.decode_steps
    for rid, comp in jres.completions.items():
        assert tres.completions[rid].tokens == comp.tokens
    assert tres.counters["dropped"] == 0 and tres.device == "cpu"


def test_port_publishes_the_jax_bytes(jax_engine_params):
    jpub = jserve.CheckpointChannel().publish(jax_engine_params, step=11)
    tpub = serve.CheckpointChannel().publish(
        _port_params(jax_engine_params), step=11)
    np.testing.assert_array_equal(tpub.packed.payload.numpy(),
                                  np.asarray(jpub.packed.payload))
    np.testing.assert_array_equal(
        tpub.packed.params.numpy().view(np.uint32),
        np.asarray(jpub.packed.params).view(np.uint32))
    assert tpub.crc == jpub.crc and tpub.wire_bytes == jpub.wire_bytes
    assert tpub.packed.layout.offsets == jpub.packed.layout.offsets


def test_jax_checkpoint_is_swapped_into_the_port_engine(jax_engine_params):
    cfg = serve.ServeConfig(**BASE)
    eng = serve.Engine(cfg, params=_port_params(jax_engine_params),
                       device="cpu")
    ch = serve.CheckpointChannel()
    eng.subscribe(ch)
    trained = jts_init(jax.random.PRNGKey(42))
    jpub = jserve.CheckpointChannel().publish(trained, step=5)
    wire = interop.wire_from_jax(jpub.packed.payload, jpub.packed.params,
                                 tree=eng.params)
    ch.publish_packed(wire, jpub.crc, step=5)
    assert eng.maybe_swap() and eng.counters["swaps"] == 1
    want = jcomp.codec("rq8").tree_decode_flat(jpub.packed)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    pytree.tree_leaves(eng.params)):
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(a).view(np.uint32))
    # and serving on the swapped params equals the JAX engine on them
    prompt = _prompt(512, 6, seed=9)
    rid = eng.submit(prompt, 5)
    eng.run()
    jeng = jserve.Engine(jserve.ServeConfig(**BASE), params=want)
    jrid = jeng.submit(prompt, 5)
    jeng.run()
    assert eng.result(rid).tokens == jeng.result(jrid).tokens


def jts_init(key):
    from repro import configs as jconfigs
    from repro.models import transformer_scan as jts
    return jts.init(jconfigs.get_config("qwen1.5-0.5b").reduced(), key)


def test_hot_swap_zero_drops_and_equal_to_cold_start():
    cfg = serve.ServeConfig(**dict(BASE, max_len=48))
    eng = serve.Engine(cfg, device="cpu")
    ch = serve.CheckpointChannel()
    eng.subscribe(ch)
    eng.warmup([6])
    vocab = eng.model_cfg.vocab
    in_flight = eng.submit(_prompt(vocab, 6, 5), 16)
    for _ in range(4):
        eng.step()
    assert eng.result(in_flight) is None
    pub = ch.publish(tts.init(eng.model_cfg, tts.generator(42)), step=11)
    post = eng.submit(_prompt(vocab, 6, 6), 8)
    eng.run()
    assert eng.counters["swaps"] == 1 and eng.counters["dropped"] == 0
    assert eng.result(in_flight).n_generated == 16
    cold = serve.Engine(cfg, params=serve.CheckpointChannel.decode(pub),
                        device="cpu")
    rid = cold.submit(_prompt(vocab, 6, 6), 8)
    cold.run()
    assert eng.result(post).tokens == cold.result(rid).tokens


def test_corrupt_checkpoints_are_rejected():
    eng = serve.Engine(serve.ServeConfig(**dict(BASE, slots=1)),
                       device="cpu")
    ch = serve.CheckpointChannel()
    eng.subscribe(ch)
    before = eng.params
    good = ch.publish(tts.init(eng.model_cfg, tts.generator(3)), step=1)
    ch.publish_packed(compression.flip_bit(good.packed, 77), good.crc,
                      step=2)
    assert not eng.maybe_swap()
    assert eng.counters["swaps_rejected"] == 1 and eng.params is before
    nan = pytree.tree_map(lambda a: torch.full_like(a, float("nan")), before)
    with pytest.raises(compression.WireCorruptionError, match="NaN"):
        serve.CheckpointChannel.decode(ch.publish(nan, step=3))
    assert not eng.maybe_swap() and eng.params is before
    ch.publish(tts.init(eng.model_cfg, tts.generator(4)), step=4)
    assert eng.maybe_swap() and eng.params is not before


def test_admission_control():
    eng = serve.Engine(serve.ServeConfig(**dict(BASE, max_queue=2)),
                       device="cpu")
    with pytest.raises(serve.AdmissionError, match="cache slots"):
        eng.submit(_prompt(512, 30, 0), 10)
    eng.submit(_prompt(512, 4, 0), 2)
    eng.submit(_prompt(512, 4, 1), 2)
    with pytest.raises(serve.AdmissionError, match="queue full"):
        eng.submit(_prompt(512, 4, 2), 2)
    assert eng.counters["rejected"] == 2
    eng.run()
    assert eng.counters["completed"] == 2


def test_entry_points_default_to_cuda():
    """No card and no device="cpu": every entry point raises instead of
    running the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    cfg = serve.ServeConfig(**BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Engine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(cfg)
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--reduced", "--requests", "1"])
    out = cli.main(["--reduced", "--slots", "2", "--prompt-len", "4",
                    "--gen", "3", "--requests", "3", "--device", "cpu"])
    assert out.n_completed == 3


def test_package_imports_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib', 'repro.')) or n == 'repro')\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20
