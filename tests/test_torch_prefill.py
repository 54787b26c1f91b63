"""The port's prefill slice against the JAX package: ``make_prefill_step``
over {flash, no flash} x {unrolled, scanned} x {all, last} logits on
reduced qwen1.5-0.5b, repro-100m and granite-8b (JAX's parameters
carried across with ``interop.params_from_jax``), ``attention`` on the
flash kernel, the dry-run batches (``make_batch_shapes`` /
``synthetic_batch``) and the granite-8b config copy. Inputs are made
with numpy from a seed.

Tolerance rtol = atol = 1e-5, as the model tests: the frameworks sum
the matmuls and the softmax in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro.models import transformer_scan as jts
from repro.train import steps as jsteps
from repro_torch import configs, interop
from repro_torch.core import prng
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.train import steps as tsteps

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("qwen1.5-0.5b", "repro-100m", "granite-8b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch):
    return (jconfigs.get_config(arch).reduced(),
            configs.get_config(arch).reduced())


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def weights(arch):
    """{scan: (JAX params, port params)} for both layouts of ``arch``."""
    jmc, _ = _cfgs(arch)
    out = {}
    for scan, jm in ((False, jt), (True, jts)):
        jp = jm.init(jmc, jax.random.PRNGKey(3))
        out[scan] = (jp, interop.params_from_jax(_np(jp)))
    return out


@pytest.mark.parametrize("positions", ["all", "last"])
@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["sdpa", "flash"])
def test_prefill_step_matches_jax(arch, weights, use_flash, scan, positions):
    jmc, tmc = _cfgs(arch)
    jp, tp = weights[scan]
    tok = np.random.default_rng(5).integers(0, jmc.vocab, size=(2, 48)) \
        .astype(np.int32)
    kw = dict(use_flash=use_flash, scan_layers=scan,
              logits_positions=positions)
    want = jax.jit(jsteps.make_prefill_step(jmc, **kw))(
        jp, {"tokens": jnp.asarray(tok)})
    fk.reset_launches()
    got = tsteps.make_prefill_step(tmc, **kw)(
        tp, {"tokens": torch.from_numpy(tok)})
    assert fk.flash_attention_bhsd.launches == 0      # CPU: plain version
    assert tuple(got.shape) == (2, tmc.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_attention_on_flash_matches_jax(arch, causal, window):
    """One attention layer with use_flash=True (rotary embedding, GQA
    where the model has it, the flash kernel) against the JAX package's,
    and against the port's own non-flash path."""
    jmc, tmc = _cfgs(arch)
    jmc = dataclasses.replace(jmc, n_kv_heads=2)
    tmc = dataclasses.replace(tmc, n_kv_heads=2)
    jp = jattn.attn_init(jax.random.PRNGKey(1), jmc)
    tp = interop.params_from_jax(_np(jp))
    x = np.random.default_rng(2).normal(size=(2, 40, jmc.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    kw = dict(causal=causal, window=window)
    want = jattn.attention(jp, jmc, jnp.asarray(x), jnp.asarray(pos),
                           use_flash=True, **kw)
    got = tattn.attention(tp, tmc, torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), use_flash=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tattn.attention(tp, tmc, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k", "decode_32k"])
def test_batch_shapes_and_synthetic_batch_match_jax(shape):
    """Same names, shapes and dtypes; the same values within this
    process (the draws fold in ``hash(name)``, which Python salts per
    process)."""
    jmc, tmc = _cfgs("qwen1.5-0.5b")
    jshape, tshape = jcommon.INPUT_SHAPES[shape], tcommon.INPUT_SHAPES[shape]
    assert dataclasses.asdict(jshape) == dataclasses.asdict(tshape)
    js = jpipe.make_batch_shapes(jmc, jshape)
    ts = tpipe.make_batch_shapes(tmc, tshape)
    assert sorted(js) == sorted(ts)
    for name, sd in js.items():
        assert ts[name].device.type == "meta"
        assert tuple(ts[name].shape) == tuple(sd.shape)
        assert str(ts[name].dtype) == f"torch.{np.dtype(sd.dtype).name}"
    jb = jpipe.synthetic_batch(jmc, jshape, jax.random.PRNGKey(4))
    tb = tpipe.synthetic_batch(tmc, tshape, prng.PRNGKey(4), device="cpu")
    for name in js:
        assert tb[name].dtype == torch.int32
        np.testing.assert_array_equal(tb[name].numpy(), np.asarray(jb[name]))


def test_input_shapes_copy_matches_jax():
    assert {k: dataclasses.asdict(v) for k, v in
            tcommon.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jcommon.INPUT_SHAPES.items()}
    assert tcommon.INPUT_SHAPES["decode_32k"].is_decode
    assert not tcommon.INPUT_SHAPES["prefill_32k"].is_decode


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_granite_config_copy_matches_jax(reduced):
    j, t = jconfigs.get_config("granite-8b"), configs.get_config("granite-8b")
    j, t = (j.reduced(), t.reduced()) if reduced else (j, t)
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    # the port's own fields (none of JAX's) stay at their defaults
    assert jf.keys() <= tf.keys()
    for f in dataclasses.fields(t):
        if f.name not in jf:
            assert tf[f.name] == f.default, f.name
    for name, value in jf.items():
        assert tuple(tf[name]) == tuple(value) if isinstance(
            value, (list, tuple)) else tf[name] == value, name


def test_logits_positions_is_checked():
    _, tmc = _cfgs("repro-100m")
    with pytest.raises(ValueError, match="logits_positions"):
        tsteps.make_prefill_step(tmc, scan_layers=True,
                                 logits_positions="first")(
            {}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
