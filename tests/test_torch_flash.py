"""repro_torch's flash-attention module against repro's: the skip-grid
table, the plain version (the path of CPU tensors) against the Pallas
kernel in interpret mode and both oracles, and the backward the port
adds (the Pallas kernel has none): its plain version against autograd
through the reference attention, and K6b's 3xTF32 arithmetic emulated.
Inputs are made with numpy from a seed and fed to both.

Tolerances: rtol = atol = 2e-5 in fp32 (the JAX package's own kernel
test: the tile's matmuls and sums run in another order than XLA's),
0.05 in bf16 (its bf16 test). ``skip=True`` against ``skip=False`` is
exact: a fully masked tile adds nothing. Gradients of unit-normal
inputs reach ~6, so the backward is held at rtol = atol = 2e-5 too
(recomputed probabilities and other summation orders: ~1e-6 apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import kernel as jfk
from repro.kernels.flash_attn import ops as jfo
from repro.kernels.flash_attn import ref as jfr
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.kernels.flash_attn import ops as fo
from repro_torch.kernels.flash_attn import ref as fr

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, s, hq, hkv, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(dtype)
            for h in (hq, hkv, hkv)]


def _both(arrs, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrs],
            [torch.from_numpy(np.asarray(a, np.float32)).to(tdtype)
             for a in arrs])


@pytest.mark.parametrize("s_pad,bq,bk,causal,window,s_valid", [
    (1024, 128, 128, False, 0, 1024),      # test_kernels' four tables
    (1024, 128, 128, True, 0, 1024),
    (1024, 128, 128, True, 128, 1024),
    (1024, 128, 128, False, 0, 300),
    (384, 128, 128, True, 0, 300),         # skip-vs-full cases' tables
    (384, 128, 128, True, 64, 300),
    (256, 128, 128, False, 0, 200),
    (1024, 128, 128, True, 256, 1024),
    (8192, 256, 128, True, 0, 8192),       # the prefill default blocks
    (8192, 256, 128, True, 2048, 8191),
    (512, 64, 32, True, 100, 500),
    (96, 32, 32, False, 7, 90),
])
def test_skip_grid_equals_jax(s_pad, bq, bk, causal, window, s_valid):
    kw = dict(causal=causal, window=window, s_valid=s_valid)
    want = jfk.skip_grid(s_pad, bq, bk, **kw)
    got = fk.skip_grid(s_pad, bq, bk, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "b,s,hq,hkv,d,causal,window,cap",
    [(2, 256, 4, 2, 64, True, 0, 0.0),
     (1, 128, 8, 1, 128, True, 0, 0.0),
     (2, 200, 4, 4, 64, True, 64, 0.0),       # window + pad
     (1, 256, 4, 2, 64, True, 0, 30.0),       # softcap (grok)
     (1, 192, 4, 2, 64, False, 0, 0.0),       # non-causal (encoder)
     (2, 96, 2, 2, 32, True, 0, 0.0)])
def test_flash_matches_jax_kernel_and_oracles(b, s, hq, hkv, d, causal,
                                              window, cap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, hq, hkv, d, seed=s * hq))
    kw = dict(causal=causal, window=window, softcap=cap)
    fk.reset_launches()
    got = fo.flash_attention(tq, tk, tv, **kw)
    assert fk.flash_attention_bhsd.launches == 0      # CPU: plain version
    want = np.asarray(jfo.flash_attention(jq, jk, jv, **kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jfr.attention(jq, jk, jv, **kw)), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               fr.attention(tq, tk, tv, **kw).numpy(), **TOL)


def test_flash_bf16_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 128, 4, 2, 64, seed=7),
                                       jnp.bfloat16, torch.bfloat16)
    got = fo.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    for want in (jfo.flash_attention(jq, jk, jv, causal=True),
                 jfr.attention(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0.05, atol=0.05)


@pytest.mark.parametrize("s,causal,window", [(300, True, 0),
                                             (300, True, 64),
                                             (200, False, 0),
                                             (1024, True, 256)])
def test_skip_is_bit_identical_to_full_grid(s, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, s, 4, 2, 64, seed=s + window))
    kw = dict(causal=causal, window=window, block_q=128, block_k=128)
    skip = fo.flash_attention(tq, tk, tv, skip=True, **kw)
    full = fo.flash_attention(tq, tk, tv, skip=False, **kw)
    assert torch.equal(skip, full)
    np.testing.assert_allclose(skip.numpy(), np.asarray(
        jfo.flash_attention(jq, jk, jv, skip=True, **kw)), **TOL)
    np.testing.assert_allclose(skip.numpy(), fr.attention(
        tq, tk, tv, causal=causal, window=window).numpy(), **TOL)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` and K6's split of the
    big part: add half of the 13 dropped bits to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """fp32 with its 13 low bits dropped: what the tensor core reads of a
    TF32 operand that was not rounded (K6's small part)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _product(a, b, mode):
    """a @ b as the tensor cores compute it in each mode, fp32
    accumulation: "3xtf32" is K6's split (big rounded, small truncated,
    the small cross terms first), "tf32" a single TF32 product."""
    if mode == "fp32":
        return a @ b
    ab, bb = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ab @ bb
    as_, bs = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _k6_emulated(q, k, v, *, causal, softcap, mode, block_k=64):
    """K6's fp32 arithmetic over 64-key tiles (q scaled before the dot,
    softcap, mask to NEG_INF, online softmax, acc * alpha + P.v) with
    both products computed in ``mode``. q (B, Hq, S, D), k, v (B, Hkv,
    S, D) with the heads repeated to the group."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    qs = q * (1.0 / np.sqrt(d))
    m = torch.full((b, hq, s, 1), fk.NEG_INF)
    l_ = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    qp = torch.arange(s)[:, None]
    for k0 in range(0, s, block_k):
        kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        logits = _product(qs, kt.transpose(-1, -2), mode)
        if softcap > 0:
            logits = softcap * torch.tanh(logits * (1.0 / softcap))
        mask = (k0 + torch.arange(kt.shape[2]))[None] <= qp if causal \
            else torch.ones((s, kt.shape[2]), dtype=torch.bool)
        logits = torch.where(mask, logits, fk.NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(logits - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_ = alpha * l_ + p.sum(-1, keepdim=True)
        acc = acc * alpha + _product(p, vt, mode)
        m = m_new
    return acc / torch.clamp_min(l_, 1e-30)


@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_3xtf32_products_keep_fp32_parity_and_one_tf32_pass_does_not(
        d, softcap):
    """The tolerance argument for K6's fp32 route, emulated on the CPU:
    3xTF32 in both products (S = (q*scale).k and O += P.v) stays within
    2e-5 of the plain version, at K6's tile; a single TF32 pass does
    not, which is why the operands are split. Unit normals as in the
    card's checks, S = 128, causal, two q-heads on one KV head."""
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.transpose(
        0, 2, 1, 3))) for a in _qkv(1, 128, 2, 1, d, seed=d + int(softcap)))
    want = fk.flash_attention_plain(tq, tk, tv, causal=True, window=0,
                                    softcap=softcap, block_q=64,
                                    block_k=64, s_valid=128)
    kw = dict(causal=True, softcap=softcap)
    torch.testing.assert_close(_k6_emulated(tq, tk, tv, mode="fp32", **kw),
                               want, **TOL)
    torch.testing.assert_close(_k6_emulated(tq, tk, tv, mode="3xtf32",
                                            **kw), want, **TOL)
    one = _k6_emulated(tq, tk, tv, mode="tf32", **kw)
    assert not torch.allclose(one, want, **TOL)
    assert float((one - want).abs().max()) > 1e-4


def test_backward_raises_like_jax():
    """The port's backward stops where it does not reach: a gradient
    through a softcapped call raises NotImplementedError naming flash
    attention, as a gradient through the Pallas kernel fails for every
    call; without softcap the port's call has a gradient (no silent
    missing one: every input gets it)."""
    _, (tq, tk, tv) = _both(_qkv(1, 64, 2, 1, 32, seed=1))
    tq.requires_grad_(True)
    out = fo.flash_attention(tq, tk, tv, softcap=30.0)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="flash attention"):
        out.sum().backward()
    tk.requires_grad_(True)
    tv.requires_grad_(True)
    dq, dk, dv = torch.autograd.grad(fo.flash_attention(tq, tk, tv).sum(),
                                     (tq, tk, tv))
    for g, t in ((dq, tq), (dk, tk), (dv, tv)):
        assert g.shape == t.shape and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0


def _grads(fn, q, k, v, dout):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    return (out,) + torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)],
                         ids=["group1", "group2", "group4"])
@pytest.mark.parametrize("causal,window,s", [(True, 0, 64),
                                             (False, 0, 64),
                                             (True, 24, 96),
                                             (True, 0, 100),
                                             (False, 16, 75)],
                         ids=["causal", "full", "window", "causal-pad",
                              "window-pad"])
def test_plain_backward_matches_autograd_through_the_reference(
        d, hq, hkv, causal, window, s):
    """The gradient of ``ops.flash_attention`` on the CPU (the plain
    backward, recomputing P from the forward's lse) against autograd
    through ``sdpa_reference``: GQA groups 1, 2 and 4, head dims 32, 64
    and 128, causal, non-causal and windowed, and lengths the wrapper
    pads to its block (keys past ``s_valid`` masked, padded rows
    dropped)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, s, hq, hkv, d,
                                                  seed=d + s + hq + hkv))
    dout = torch.from_numpy(np.random.default_rng(s).normal(
        size=q.shape).astype(np.float32))
    kw = dict(causal=causal, window=window)
    fk.reset_launches()
    got = _grads(lambda a, b, c: fo.flash_attention(a, b, c, **kw),
                 q, k, v, dout)
    assert fk.flash_attention_bwd_bhsd.launches == 0  # CPU: plain version
    want = _grads(lambda a, b, c: fr.attention(a, b, c, **kw), q, k, v,
                  dout)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


def test_lse_is_the_logsumexp_of_the_masked_scaled_logits():
    """``with_lse``: the row log-sum-exp of the plain forward, on the
    logits as scaled and masked (a window past the padded tail leaves
    rows that attend nothing: -inf there), against torch.logsumexp; the
    output is the same with or without it."""
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.transpose(
        0, 2, 1, 3))) for a in _qkv(2, 128, 4, 2, 64, seed=5))
    kw = dict(causal=True, window=8, softcap=0.0, block_q=64, block_k=64,
              s_valid=100)
    out, lse = fk.flash_attention_bhsd(tq, tk, tv, with_lse=True, **kw)
    assert lse.shape == (2, 4, 128) and lse.dtype == torch.float32
    assert torch.equal(out, fk.flash_attention_bhsd(tq, tk, tv, **kw))
    mask = fr.make_mask(128, 128, causal=True, window=8) & (
        torch.arange(128) < 100)[None]
    logits = torch.matmul(tq.double(), tk.double().repeat_interleave(
        2, dim=1).transpose(-1, -2)) / 8.0
    want = torch.logsumexp(logits.masked_fill(~mask, -np.inf), -1).float()
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert bool(torch.isinf(want[..., 107:]).all())
    fin = torch.isfinite(want)
    torch.testing.assert_close(lse[fin], want[fin], **TOL)


def test_a_call_autograd_does_not_record_saves_nothing():
    """No grad mode, or no input that requires grad: the output has no
    gradient function and nothing is kept for a backward (the
    prefill's call); a recorded call has one, with the same output."""
    _, (tq, tk, tv) = _both(_qkv(1, 64, 2, 1, 64, seed=2))
    assert fo.flash_attention(tq, tk, tv).grad_fn is None
    tq.requires_grad_(True)
    with torch.no_grad():
        plain = fo.flash_attention(tq, tk, tv)
    assert plain.grad_fn is None
    out = fo.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None
    node = out.grad_fn.next_functions[0][0]          # under the transpose
    assert len(node.saved_tensors) == 5              # q, k, v, out, lse
    assert torch.equal(out.detach(), plain)


def _k6b_emulated(q, k, v, out, dout, lse, *, mode):
    """K6b's fp32 arithmetic, causal, every product computed in
    ``mode``: P = exp((q * scale) . k - lse) where attended, dV = P^T .
    dout, dP = dout . v^T, dS = P * (dP - rowsum(dout * out)), dK = dS^T
    . (q * scale), dQ = scale * dS . k; the group summed into dk, dv."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    scale = 1.0 / np.sqrt(d)
    qs = q * scale
    mask = torch.arange(s)[None] <= torch.arange(s)[:, None]
    p = torch.where(mask, torch.exp(_product(qs, k.transpose(-1, -2), mode)
                                    - lse[..., None]), 0.0)
    dv = _product(p.transpose(-1, -2), dout, mode)
    ds = p * (_product(dout, v.transpose(-1, -2), mode)
              - (dout * out).sum(-1, keepdim=True))
    dk = _product(ds.transpose(-1, -2), qs, mode)
    dq = _product(ds, k, mode) * scale
    return (dq, dk.view(b, -1, g, s, d).sum(2),
            dv.view(b, -1, g, s, d).sum(2))


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_backward_keeps_fp32_parity_and_one_tf32_pass_does_not(d):
    """The tolerance argument for K6b, emulated on the CPU: 3xTF32 in
    all five products stays within 2e-5 of the plain backward (itself
    held to autograd above); a single TF32 pass misses by ~2e-3, which
    is why every operand is split. S = 128, causal, two q-heads on one
    KV head, unit normals."""
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.transpose(
        0, 2, 1, 3))) for a in _qkv(1, 128, 2, 1, d, seed=d + 1))
    dout = torch.from_numpy(np.random.default_rng(d).normal(
        size=tq.shape).astype(np.float32))
    out, lse = fk.flash_attention_plain(tq, tk, tv, causal=True, window=0,
                                        softcap=0.0, block_q=64,
                                        block_k=64, s_valid=128,
                                        with_lse=True)
    want = fk.flash_attention_backward_plain(tq, tk, tv, out, dout, lse,
                                             causal=True, window=0,
                                             s_valid=128)
    for mode in ("fp32", "3xtf32"):
        for a, w in zip(_k6b_emulated(tq, tk, tv, out, dout, lse,
                                      mode=mode), want):
            torch.testing.assert_close(a, w, **TOL)
    one = _k6b_emulated(tq, tk, tv, out, dout, lse, mode="tf32")
    for a, w in zip(one, want):
        assert not torch.allclose(a, w, **TOL)
        assert float((a - w).abs().max()) > 5e-4


def test_plain_rejects_unpadded_lengths_and_bad_heads():
    q = torch.zeros((1, 4, 100, 32))
    kv = torch.zeros((1, 2, 100, 32))
    with pytest.raises(ValueError, match="multiple of the blocks"):
        fk.flash_attention_bhsd(q, kv, kv, causal=True, window=0,
                                softcap=0.0, block_q=64, block_k=64,
                                s_valid=100)
    with pytest.raises(ValueError, match="not a multiple of Hkv"):
        fk.flash_attention_bhsd(q[:, :3], kv, kv, causal=True, window=0,
                                softcap=0.0, block_q=50, block_k=50,
                                s_valid=100)


@pytest.mark.cuda
def test_cuda_tensor_with_unsupported_head_dim_or_dtype_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K6 runs only there)")
    kw = dict(causal=True, window=0, softcap=0.0, block_q=8, block_k=8,
              s_valid=8)
    q = torch.zeros((1, 2, 8, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_bhsd(q, q, q, **kw)
    q = torch.zeros((1, 2, 8, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention_bhsd(q, q, q, **kw)
