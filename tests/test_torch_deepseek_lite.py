"""The published DeepSeek-V2-Lite (``deepseek-v2-lite``: dropless top-k
routing with unnormalised gates, YaRN, a 10,944-wide dense layer 0) on
the port's normal paths, at a small size on the CPU, against the
benchmark's plain reference ``bench/reference/deepseek.py`` on seeded
random weights (``bench/inputs_deepseek.py``, handed to the program by
``bench/port_deepseek.py``).

The small model keeps every kind of part: d 256, 4 heads, latent rank
64, q.k over 64 + 32 dims, v 64, layer 0 dense, 2 MoE layers of 8
experts (top 2, one shared), YaRN over 64 original positions so that
its ramp acts at the tests' lengths (up to 160 positions).
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs, obs
from repro_torch.core import pytree
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.models import layers, mla, moe, transformer as tt
from repro_torch.models import transformer_scan as tts
from repro_torch.models.common import MLAConfig, YaRNConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import steps

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import inputs_deepseek  # noqa: E402
import port_deepseek  # noqa: E402
from reference import deepseek as ref  # noqa: E402

ARCH = "deepseek-v2-lite"
PUBLISHED_PARAMS = 15_706_484_224
# fp32 on both sides, sums in other orders (batched vs per-row matmuls,
# one head's attention at a time vs a block of queries): a few ulp of
# the logits' scale, 1.1e-6 relative at 300 tokens; 1e-5 leaves room,
# and the TF32 control reads ~1e-3
TOL = 1e-5


def small_cfg(**moe_kw):
    base = configs.get_config(ARCH)
    return dataclasses.replace(
        base, n_layers=3, d_model=256, n_heads=4, n_kv_heads=4,
        head_dim=64, d_ff=512, vocab=512, block_pattern=("mla",) * 3,
        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=64,
                      qk_rope_head_dim=32, v_head_dim=64),
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=2,
                                d_ff_expert=256, n_shared=1, **moe_kw),
        rope_scaling=dataclasses.replace(
            base.rope_scaling, original_max_position_embeddings=64))


def model_dict(cfg) -> dict:
    """The reference's numbers of a configuration."""
    ys = cfg.rope_scaling
    return {"arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "kv_lora_rank": cfg.mla.kv_lora_rank,
            "qk_nope_head_dim": cfg.mla.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.mla.qk_rope_head_dim,
            "v_head_dim": cfg.mla.v_head_dim, "first_k_dense": 1,
            "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "d_ff_expert": cfg.moe.d_ff_expert, "n_shared": cfg.moe.n_shared,
            "norm_topk_prob": False,
            "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps,
            "tie_embeddings": False,
            "rope_scaling": {f.name: getattr(ys, f.name)
                             for f in dataclasses.fields(ys)}}


@pytest.fixture(scope="module")
def small():
    cfg = small_cfg()
    m = model_dict(cfg)
    W = inputs_deepseek.weights(m, 11, "cpu")
    return cfg, m, W


def _tokens(m, s, seed=1, b=1):
    return torch.randint(0, m["vocab"], (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _unrolled(tree: dict) -> dict:
    """The unrolled tree (``transformer``) over the scanned tree's
    tensors: layer 0 the prefix, then the scanned layers one by one."""
    blocks = tree["scan_blocks"][0]
    n = blocks["ln1"]["scale"].shape[0]
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "lm_head": tree["lm_head"],
            "layers": tree["prefix_layers"] + [
                pytree.tree_map(lambda t, r=r: t[r], blocks)
                for r in range(n)]}


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("scan,positions", [
    (True, "last"), (True, "all"), (False, None)],
    ids=["scanned-last", "scanned-all", "unrolled"])
def test_prefill_step_matches_the_plain_reference(small, scan, positions):
    """``make_prefill_step`` (the scanned tree with the head on the last
    position or on all, or the unrolled tree) against the reference's
    last-position logits."""
    cfg, m, W = small
    tree = port_deepseek.param_tree(W)
    if not scan:
        tree = _unrolled(tree)
    toks = _tokens(m, 160)
    kw = {"logits_positions": positions} if scan else {}
    got = steps.make_prefill_step(cfg, use_flash=True, scan_layers=scan,
                                  **kw)(tree, {"tokens": toks})
    want = ref.last_logits(W, m, toks, q_block=64)
    assert _gap(got, want) < TOL


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_all_positions_of_the_forward_match_the_reference(small, scan):
    cfg, m, W = small
    toks = _tokens(m, 128, seed=2, b=2)
    tree = port_deepseek.param_tree(W)
    got = (tts.apply(tree, cfg, {"tokens": toks}) if scan
           else tt.apply(_unrolled(tree), cfg, {"tokens": toks}))
    x = ref.hidden(W, m, toks, q_block=32)
    want = ref.rms_norm(x, W["final_norm"], m["norm_eps"]) @ W["lm_head"]
    assert _gap(got, want) < TOL


def test_yarn_at_the_published_dims():
    """low 10 and high 23 over the 64 rope dims, the softmax scale
    192^-0.5 * mscale(40, 0.707)^2 = 0.114721, cos and sin unscaled
    (mscale / mscale_all_dim = 1), frequencies as the formulas give them."""
    cfg = configs.get_config(ARCH)
    ys = cfg.rope_scaling
    assert layers.yarn_range(64, cfg.rope_theta, ys) == (10, 23)
    assert mla._scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    assert mla._scale(cfg) == pytest.approx(
        192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2, rel=1e-12)
    got = layers.yarn_freqs(64, cfg.rope_theta, ys)
    i = torch.arange(32, dtype=torch.float64)
    extra = cfg.rope_theta ** (-2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
    m = port_deepseek.model_dict(
        {"arch": ARCH, "qk_rope_head_dim": 64, "qk_nope_head_dim": 128,
         "rope_theta": cfg.rope_theta,
         "rope_scaling": {f.name: getattr(ys, f.name)
                          for f in dataclasses.fields(ys)}})
    assert torch.equal(ref.yarn_inv_freq(m, "cpu"), got)
    assert ref.softmax_scale(m) == pytest.approx(mla._scale(cfg),
                                                 rel=1e-15)
    # a model without YaRN keeps the plain frequencies bit for bit
    x = torch.randn(1, 9, 2, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(9)[None]
    plain = layers.apply_rope(x, pos, theta=1e4)
    f = layers.rope_freqs(64, 1e4)
    ang = (pos[..., None].float() * f)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    assert torch.equal(plain, torch.cat([
        x1 * torch.cos(ang) - x2 * torch.sin(ang),
        x1 * torch.sin(ang) + x2 * torch.cos(ang)], dim=-1))


def _moe_case(bias: float, seed: int = 3):
    cfg = small_cfg()
    m = model_dict(cfg)
    W = inputs_deepseek.weights(m, seed, "cpu")
    # inputs with a mean of 1 in every feature and a router column that
    # sums them: expert 0 gets ``bias`` more logit from every token
    W["router"][0][:, 0] += bias / m["d_model"]
    p = port_deepseek.param_tree(W)["scan_blocks"][0]["ffn"]
    p = pytree.tree_map(lambda t: t[0], p)
    x = torch.randn(2, 96, m["d_model"],
                    generator=torch.Generator().manual_seed(seed)) + 1.0
    return cfg, m, W, p, x


def test_no_choice_is_dropped_under_a_skewed_router():
    """A router biased so that expert 0 is every token's first choice:
    every (token, choice) is computed (the counter of dropped choices
    stays 0, and expert 0's load is every token, n_experts / top_k times
    the mean) and the layer equals the reference's loop over the
    experts. The capacity path drops most of expert 0's choices on the
    same input."""
    cfg, m, W, p, x = _moe_case(bias=20.0)
    capped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=False))
    obs.enable(trace=True, metrics=False, flight=False)
    obs_metrics.reset()
    try:
        out, _ = moe.moe_apply(p, cfg, x)
        got = obs_metrics.registry().snapshot()
        moe.moe_apply(p, capped, x)
        capped_dropped = obs_metrics.registry().snapshot()[
            "moe.dropped_choices"]["value"]
    finally:
        obs.disable()
        obs_metrics.reset()
    assert got["moe.dropped_choices"]["value"] == 0
    assert got["moe.expert_load"]["count"] == 1
    assert got["moe.expert_load"]["max"] == \
        cfg.moe.n_experts / cfg.moe.top_k
    assert capped_dropped > 0
    want = ref.moe(W, m, x.reshape(-1, m["d_model"]), 0, torch.matmul)
    assert _gap(out.reshape(-1, m["d_model"]), want) < TOL


def test_dropless_layer_has_the_gradient_of_the_reference():
    """Autograd through the dropless layer (its experts' rows gathered,
    computed and put back) gives the reference loop's gradients."""
    cfg, m, W, p, x = _moe_case(bias=0.0)
    leaves = {"w_up": p["w_up"], "router": p["router"]["w"]}
    for t in leaves.values():
        t.requires_grad_(True)
    out, _ = moe.moe_apply(p, cfg, x)
    got = torch.autograd.grad(out.square().sum(), list(leaves.values()))
    Wg = dict(W, experts_up=p["w_up"][None], router=p["router"]["w"][None])
    want_out = ref.moe(Wg, m, x.reshape(-1, m["d_model"]), 0, torch.matmul)
    want = torch.autograd.grad(want_out.square().sum(),
                               list(leaves.values()))
    for g, w in zip(got, want):
        assert _gap(g, w) < TOL


def test_gates_are_not_renormalised():
    """The routed part of the layer is sum_k p_k E_k(x) with p the
    router's probabilities, far from the same sum over p_k / sum_k p_k
    (the renormalised gates of ``norm_topk_prob``)."""
    cfg, m, W, p, x = _moe_case(bias=0.0)
    xt = x.reshape(-1, m["d_model"])
    out, _ = moe.moe_apply(p, cfg, x)
    shared = layers.mlp(p["shared_0"], xt, act="silu", glu=True)
    probs = torch.softmax(xt @ p["router"]["w"], dim=-1)
    gates, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    experts = torch.stack([
        torch.stack([ref.swiglu(xt[t:t + 1], p["w_gate"][e], p["w_up"][e],
                                p["w_down"][e], torch.matmul)[0]
                     for e in ids[t].tolist()]) for t in range(len(xt))])
    want = (experts * gates[..., None]).sum(1) + shared
    assert _gap(out.reshape(-1, m["d_model"]), want) < TOL
    assert float(gates.sum(-1).mean()) < 0.9
    renorm = (experts * (gates / gates.sum(-1, keepdim=True))[..., None]
              ).sum(1) + shared
    assert _gap(out.reshape(-1, m["d_model"]), renorm) > 100 * TOL


def test_the_jax_copys_routing_fails_the_comparison(small):
    """The capacity routing with renormalised gates (the JAX package's,
    ``deepseek-v2-lite-16b``'s) planted in the published configuration:
    its prefill is far outside the tolerance of the reference."""
    cfg, m, W = small
    toks = _tokens(m, 160)
    want = ref.last_logits(W, m, toks, q_block=64)
    jax_routing = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=False))
    tree = port_deepseek.param_tree(W)
    got = steps.make_prefill_step(jax_routing, scan_layers=True,
                                  logits_positions="last")(
        tree, {"tokens": toks})
    assert _gap(got, want) > 100 * TOL
    sound = steps.make_prefill_step(cfg, scan_layers=True,
                                    logits_positions="last")(
        tree, {"tokens": toks})
    assert _gap(sound, want) < TOL


def test_prefill_then_decode_through_the_latent_cache(small):
    """The prompt's cache filled a token at a time, then 24 decode steps:
    each step's logits equal the full forward pass at its position (the
    absorbed latent attention under the same YaRN scale); the cache is
    fp32, so only the sums' order differs."""
    cfg, m, W = small
    tree = port_deepseek.param_tree(W)
    toks = _tokens(m, 104, seed=4)
    full = tts.apply(tree, cfg, {"tokens": toks})
    state = tts.init_decode_state(tree, cfg, 1, 104, dtype=torch.float32)
    last, state = steps.make_bulk_prefill(cfg, scan_layers=True)(
        tree, state, toks[:, :80])
    assert _gap(last, full[:, 79]) < TOL
    serve = steps.make_serve_step(cfg, scan_layers=True)
    for t in range(80, 104):
        logits, state = serve(tree, state, {"tokens": toks[:, t:t + 1]})
        assert _gap(logits.reshape(1, -1), full[:, t]) < TOL, t


def test_count_params_is_the_published_count():
    cfg = configs.get_config(ARCH)
    assert tt.count_params(cfg) == PUBLISHED_PARAMS
    assert cfg.param_count() == PUBLISHED_PARAMS
    assert ARCH not in configs.all_configs() and ARCH not in configs.ASSIGNED


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_at_mla_head_dims(causal):
    """The flash kernel's plain version with v narrower than q and k and
    the YaRN scale (K6's (192, 128) function on the CPU) against plain
    softmax attention."""
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn(1, 3, 128, 48, generator=g) for _ in range(2))
    v = torch.randn(1, 3, 128, 32, generator=g)
    scale = 0.3
    got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=0,
                                  softcap=0.0, block_q=64, block_k=32,
                                  s_valid=120, scale=scale)
    logits = (q @ k.transpose(-1, -2)) * scale
    mask = torch.arange(128)[None, :] < 120
    if causal:
        mask = mask & (torch.arange(128)[None, :]
                       <= torch.arange(128)[:, None])
    want = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1) @ v
    assert got.shape == v.shape[:2] + (128, 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_mla_flash_route_stays_plain_on_the_cpu(small):
    """``use_flash`` on the CPU keeps the plain MLA path (K6 is the
    card's): the two forwards are the same numbers."""
    cfg, m, W = small
    tree = port_deepseek.param_tree(W)
    toks = _tokens(m, 64, seed=6)
    a = tts.apply(tree, cfg, {"tokens": toks}, use_flash=True)
    b = tts.apply(tree, cfg, {"tokens": toks}, use_flash=False)
    assert torch.equal(a, b)
