"""The hybrid and MoE families of repro_torch against repro's, for the
five configurations the models slice adds: recurrentgemma-9b (RG-LRU and
local attention), deepseek-v2-lite-16b (MLA and MoE with a dense layer
0), qwen2.5-14b (QKV bias), command-r-35b (parallel block, LayerNorm)
and grok-1-314b (MoE, GELU, softcap).

At full width: the configs field for field and the parameter counts
(``count_params``, drawn on ``meta``, against JAX's
``param_count()``). At reduced size, with JAX's parameters carried
across (``interop.params_from_jax``) and inputs made with numpy from a
seed: the stacked tree, the prefill logits (the port on its flash path,
plain on the CPU, against JAX's non-flash prefill), the unrolled
forward with its aux, a train step's loss (cross entropy plus the MoE
aux) and gradients, the decode state's dtypes, the greedy streams of the
serve engine, and the CLIs. recurrentgemma runs the pattern (rglru,
rglru, local_attn, rglru, rglru) — a unit of three and a suffix of two,
as at full depth — and deepseek three layers: the dense prefix and two
scanned MoE layers.

Tolerances: prefill logits rtol = atol = 1e-4; the loss, its aux and
the gradients 1e-5 (the frameworks sum the matmuls in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import transformer as jt
from repro.models import transformer_scan as jts
from repro.train import steps as jsteps
from repro_torch import configs, interop, serve
from repro_torch.core import pytree
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tt
from repro_torch.models import transformer_scan as tts
from repro_torch.train import steps

from _config_parity import assert_same_config

ARCHS = ("recurrentgemma-9b", "deepseek-v2-lite-16b", "qwen2.5-14b",
         "command-r-35b", "grok-1-314b")
# jax.eval_shape(transformer.init) at full width
FULL_PARAMS = {"recurrentgemma-9b": 10_664_163_328,
               "deepseek-v2-lite-16b": 15_647_895_040,
               "qwen2.5-14b": 14_770_033_664,
               "command-r-35b": 30_283_546_624,
               "grok-1-314b": 316_489_340_928}
RG_PATTERN = ("rglru", "rglru", "local_attn", "rglru", "rglru")
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reduced(cfg):
    if cfg.arch_id == "recurrentgemma-9b":
        return dataclasses.replace(cfg.reduced(n_layers=5),
                                   block_pattern=RG_PATTERN)
    if cfg.arch_id == "deepseek-v2-lite-16b":
        return cfg.reduced(n_layers=3)
    return cfg.reduced()


def _tokens(mc, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, mc.vocab, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(JAX config, port config, JAX stacked params, port params)."""
    jmc = _reduced(jconfigs.get_config(request.param))
    tmc = _reduced(configs.get_config(request.param))
    jp = jts.init(jmc, jax.random.PRNGKey(0))
    return jmc, tmc, jp, interop.params_from_jax(_np(jp))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_jax(arch):
    j, t = jconfigs.get_config(arch), configs.get_config(arch)
    for a, b in ((j, t), (j.reduced(), t.reduced()), (_reduced(j),
                                                       _reduced(t))):
        assert_same_config(b, a)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_jax(arch):
    j, t = jconfigs.get_config(arch), configs.get_config(arch)
    assert tt.count_params(t) == j.param_count() == FULL_PARAMS[arch]
    assert tt.count_params(t, active_only=True) == j.active_param_count()


def test_the_reduced_patterns_have_prefix_unit_and_suffix():
    rg = _reduced(configs.get_config("recurrentgemma-9b"))
    assert tts.pattern_segments(rg) == ((), ("rglru", "rglru", "local_attn"),
                                        1, ("rglru", "rglru"))
    ds = _reduced(configs.get_config("deepseek-v2-lite-16b"))
    assert tts.pattern_segments(ds) == (("mla",), ("mla",), 2, ())
    full = configs.get_config("recurrentgemma-9b")
    assert tts.pattern_segments(full)[2:] == (12, ("rglru", "rglru"))


def test_port_init_has_the_jax_tree(model):
    jmc, tmc, jp, _ = model
    assert tts.pattern_segments(tmc) == jts.pattern_segments(jmc)
    gp = tts.init(tmc, tts.generator(0))
    jl = jax.tree_util.tree_leaves(jp)
    tl = pytree.tree_leaves(gp)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert [np.dtype(a.dtype).name for a in jl] == \
        [str(b.dtype).removeprefix("torch.") for b in tl]


def test_prefill_logits_match_jax(model):
    """The port's flash prefill (the plain flash version on the CPU)
    against JAX's non-flash prefill, 2 x 100 tokens (past the reduced
    local window of 64)."""
    jmc, tmc, jp, tp = model
    tok = _tokens(jmc, 2, 100, seed=1)
    want = jax.jit(jsteps.make_prefill_step(jmc, scan_layers=True))(
        jp, {"tokens": jnp.asarray(tok)})
    got = steps.make_prefill_step(tmc, use_flash=True, scan_layers=True,
                                  logits_positions="last")(
        tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)


def test_unrolled_apply_and_aux_match_jax(model):
    jmc, tmc, _, _ = model
    jp = jt.init(jmc, jax.random.PRNGKey(1))
    tp = interop.params_from_jax(_np(jp))
    tok = _tokens(jmc, 2, 24, seed=2)
    want, waux = jax.jit(lambda p, t: jt.apply(p, jmc, {"tokens": t}))(
        jp, jnp.asarray(tok))
    got, gaux = tt.apply(tp, tmc, {"tokens": torch.from_numpy(tok)},
                         with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    assert (float(waux) > 0) == (jmc.moe is not None)


def test_train_step_loss_and_gradients_match_jax(model):
    """One train step's loss (cross entropy + the MoE aux) and every
    gradient leaf, scanned layout with remat, 2 x 32 tokens."""
    jmc, tmc, jp, tp = model
    tok = _tokens(jmc, 2, 33, seed=3)
    scfg = dict(scan_layers=True, remat=True)
    jloss = jsteps.make_loss_fn(jmc, jsteps.TrainStepConfig(**scfg))
    jb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:])}
    wl, wg = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    tloss = steps.make_loss_fn(tmc, steps.TrainStepConfig(**scfg))
    tb = {"tokens": torch.from_numpy(tok[:, :-1]),
          "labels": torch.from_numpy(tok[:, 1:])}
    gl, gg = steps.value_and_grad(tloss, tp, tb)
    np.testing.assert_allclose(float(gl), float(wl), **TOL)
    wleaves = jax.tree_util.tree_leaves(wg)
    gleaves = pytree.tree_leaves(gg)
    assert len(wleaves) == len(gleaves)
    for a, b in zip(gleaves, wleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_decode_state_dtypes_follow_jax(model):
    """With the default (bf16) cache: attention K/V and the MLA latent
    cache bf16 as JAX's; the RG-LRU conv window in the dtype JAX's comes
    back in after a step (fp32 for fp32 weights), h fp32."""
    jmc, tmc, jp, tp = model
    st = tts.init_decode_state(tp, tmc, 2, 8)
    prefix, unit, _, suffix = tts.pattern_segments(tmc)
    for part, kind_list in (("prefix", prefix), ("scan", unit),
                            ("suffix", suffix)):
        for kind, leaf in zip(kind_list, st[part]):
            if kind == "rglru":
                assert leaf["conv"].dtype == leaf["h"].dtype == torch.float32
            elif kind == "mla":
                assert leaf["c_kv"].dtype == leaf["k_rope"].dtype \
                    == torch.bfloat16
            else:
                assert leaf["k"].dtype == torch.bfloat16


def test_engine_greedy_streams_equal_the_jax_engine(model):
    """The serve engine (each slot its own MoE group) on the reduced
    model: greedy streams equal the JAX engine's (vmapped batch-1
    steps) on the same params and requests, 0 dropped."""
    jmc, tmc, jp, tp = model
    kw = dict(arch=jmc.arch_id, slots=2, max_len=24, prompt_len=5,
              n_requests=4, mixed_gen=(3, 6), seed=1, temperature=0.0)
    jcfg, tcfg = jserve.ServeConfig(**kw), serve.ServeConfig(**kw)
    jres = jserve.run(jcfg, engine=jserve.Engine(jcfg, params=jp,
                                                 model_cfg=jmc))
    tres = serve.run(tcfg, engine=serve.Engine(tcfg, params=tp,
                                               model_cfg=tmc, device="cpu"))
    assert tres.n_completed == jres.n_completed == 4
    assert tres.counters["dropped"] == 0
    for rid, comp in jres.completions.items():
        assert tres.completions[rid].tokens == comp.tokens


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "deepseek-v2-lite-16b"])
def test_serve_cli_runs_the_reduced_family(arch, capsys):
    res = serve_cli.main(["--device", "cpu", "--reduced", "--arch", arch,
                          "--slots", "2", "--requests", "3",
                          "--prompt-len", "4", "--gen", "3"])
    assert res.n_completed == 3 and res.counters["dropped"] == 0
    assert f"arch={arch}" in capsys.readouterr().out


def test_train_cli_trains_a_reduced_moe_model(capsys):
    train_cli.main(["--device", "cpu", "--reduced", "--arch", "grok-1-314b",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=grok-1-314b" in out and out.count("[train] step") == 2


def _out_of_place_normal(gen, shape, *, scale=1.0, dtype=torch.float32):
    """The draw before the init-memory repair: a full fp32 draw, a
    scaled copy, then the cast."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


@pytest.mark.parametrize("arch", ARCHS + ("qwen1.5-0.5b", "rwkv6-3b"))
def test_fp32_init_is_bit_identical_to_the_out_of_place_draw(arch,
                                                             monkeypatch):
    """fp32 leaves scaled in place hold the bits the out-of-place draw
    gave, leaf for leaf, in the same generator order."""
    from repro_torch.models import layers
    mc = _reduced(configs.get_config(arch))
    new = pytree.tree_leaves(tts.init(mc, tts.generator(3)))
    monkeypatch.setattr(layers, "normal", _out_of_place_normal)
    old = pytree.tree_leaves(tts.init(mc, tts.generator(3)))
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_bf16_stacked_leaves_are_drawn_a_layer_at_a_time():
    """A stacked bf16 leaf is the bf16 rounding of one fp32 draw per
    layer, written into the preallocated result; a 2-D one is one draw."""
    from repro_torch.models import layers
    got = layers.normal(torch.Generator().manual_seed(4), (3, 16, 8),
                        scale=0.5, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    want = torch.stack([torch.randn((16, 8), generator=g) * 0.5
                        for _ in range(3)]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    flat = layers.normal(torch.Generator().manual_seed(4), (16, 8),
                         scale=0.5, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    assert torch.equal(flat, (torch.randn((16, 8), generator=g) * 0.5
                              ).to(torch.bfloat16))
