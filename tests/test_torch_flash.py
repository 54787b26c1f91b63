"""repro_torch's flash-attention module against repro's: the skip-grid
table, the plain version (the path of CPU tensors) against the Pallas
kernel in interpret mode and both oracles, and the forward-only
contract. Inputs are made with numpy from a seed and fed to both.

Tolerances: rtol = atol = 2e-5 in fp32 (the JAX package's own kernel
test: the tile's matmuls and sums run in another order than XLA's),
0.05 in bf16 (its bf16 test). ``skip=True`` against ``skip=False`` is
exact: a fully masked tile adds nothing.
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
    """The kernel is forward-only: jax.grad raises, and so does a
    backward through the port's call (no silent gradient)."""
    _, (tq, tk, tv) = _both(_qkv(1, 64, 2, 1, 32, seed=1))
    tq.requires_grad_(True)
    out = fo.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="flash attention"):
        out.sum().backward()


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
