"""repro_torch.kernels.quant against repro.kernels.quant.

The plain versions of K1 (minmax_bucketed), K2 (encode_packed) and K3
(decode_packed) — what the kernel wrappers run on a CPU tensor — are
bit-equal to the JAX package's jnp reference and its Pallas kernels
(interpret mode) for bits 8/4/2 over single-bucket, multi-bucket and
unaligned totals, given the same key (K2 and K4 take the key and draw
JAX's uniforms themselves). The CUDA kernels themselves are
held against the same plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant import ops as jops
from repro.kernels.quant import ref as jref
from repro_torch.core import prng
from repro_torch.kernels.quant import kernel, ops, ref


def _data(n, seed=0):
    return (np.random.default_rng(seed).normal(size=n) * 0.05).astype(
        np.float32)


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _jax_encode(x, key, bits, be, backend):
    pay, par = jops.encode_flat(jnp.asarray(x), key, bits=bits,
                                bucket_elems=be, backend=backend)
    return np.array(pay), np.array(par)      # writable copies


CASES = [(n, bits, be) for n in (77, 4099, 300000) for bits in (8, 4, 2)
         for be in (4096, 1 << 22)]


@pytest.mark.parametrize("n,bits,be", CASES)
def test_encode_decode_flat_bit_equal_to_jnp(n, bits, be):
    """payload, params and decoded values == JAX's jnp backend."""
    x = _data(n, seed=n + bits)
    pay, par = _jax_encode(x, jax.random.PRNGKey(n), bits, be, "jnp")
    tpay, tpar = ops.encode_flat(torch.from_numpy(x), prng.PRNGKey(n),
                                 bits=bits, bucket_elems=be)
    np.testing.assert_array_equal(tpay.numpy(), pay)
    np.testing.assert_array_equal(_u32(tpar.numpy()), _u32(par))
    dec = jops.decode_flat(jnp.asarray(pay), jnp.asarray(par), total=n,
                           bits=bits, bucket_elems=be, backend="jnp")
    tdec = ops.decode_flat(torch.from_numpy(pay), torch.from_numpy(par),
                           total=n, bits=bits, bucket_elems=be)
    np.testing.assert_array_equal(_u32(tdec.numpy()), _u32(dec))


@pytest.mark.parametrize("n,bits", [(77, 8), (4099, 4), (4099, 2),
                                    (9000, 8)])
def test_bit_equal_to_pallas_interpret(n, bits):
    """The same against the Pallas kernels (interpret mode), multi-bucket
    at bucket_elems=4096."""
    x = _data(n, seed=7)
    pay, par = _jax_encode(x, jax.random.PRNGKey(1), bits, 4096, "pallas")
    tpay, tpar = ops.encode_flat(torch.from_numpy(x), prng.PRNGKey(1),
                                 bits=bits, bucket_elems=4096)
    np.testing.assert_array_equal(tpay.numpy(), pay)
    np.testing.assert_array_equal(_u32(tpar.numpy()), _u32(par))
    dec = jops.decode_flat(jnp.asarray(pay), jnp.asarray(par), total=n,
                           bits=bits, bucket_elems=4096, backend="pallas")
    tdec = ops.decode_flat(tpay, tpar, total=n, bits=bits, bucket_elems=4096)
    np.testing.assert_array_equal(_u32(tdec.numpy()), _u32(dec))


@pytest.mark.parametrize("nb,rows", [(1, 3), (4, 2), (3, 16)])
def test_minmax_plain_equals_jax(nb, rows):
    x = _data(nb * rows * 512, seed=nb).reshape(nb, rows, 512)
    x[0, 0, 5] = -3.0                      # an extreme in every position
    x[-1, -1, -1] = 4.0
    lo, hi = jref.minmax_bucketed(jnp.asarray(x).reshape(nb, -1))
    mm = kernel.minmax_bucketed(torch.from_numpy(x))
    np.testing.assert_array_equal(mm[:, 0].numpy(), np.asarray(lo))
    np.testing.assert_array_equal(mm[:, 1].numpy(), np.asarray(hi))


def _jax_bucket_uniforms(seed, first, shape):
    """JAX's draws of buckets first .. first + shape[0] - 1 under
    PRNGKey(seed): jax.random.uniform(fold_in(key, b), shape[1:])."""
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, first + b), shape[1:], jnp.float32))
        for b in range(shape[0])])


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_packed_kernels_plain_equal_jax_ref(bits):
    """K2/K3 wrappers on CPU tensors == ref.encode/decode_packed_bucketed
    of the JAX package, given identical x and params and K2's key: bucket
    b rounds against JAX's jax.random.uniform(fold_in(key, first + b))."""
    pack = 8 // bits
    rng = np.random.default_rng(bits)
    x4 = rng.normal(size=(3, pack, 4, 512)).astype(np.float32)
    u4 = _jax_bucket_uniforms(bits, 5, x4.shape)
    lo = x4.reshape(3, -1).min(1)
    scale = np.asarray(jref.quant_params(jnp.asarray(x4[0]), bits)[1])
    scale = np.full(3, scale, np.float32)
    params = np.stack([lo, scale], 1).astype(np.float32)
    want = np.asarray(jax.jit(jref.encode_packed_bucketed,
                              static_argnames="bits")(
        x4, u4, lo, scale, bits=bits))
    got = kernel.encode_packed(torch.from_numpy(x4), prng.PRNGKey(bits),
                               torch.from_numpy(params), bits=bits,
                               first_bucket=5)
    np.testing.assert_array_equal(got.numpy(), want)
    dwant = np.asarray(jax.jit(jref.decode_packed_bucketed,
                               static_argnames="bits")(
        want, lo, scale, bits=bits))
    dgot = kernel.decode_packed(got, torch.from_numpy(params), bits=bits)
    np.testing.assert_array_equal(_u32(dgot.numpy()), _u32(dwant))


def test_scale_is_the_jitted_reciprocal_multiply():
    """Fault 1: XLA compiles (hi - lo) / levels as a multiply by the fp32
    reciprocal. The port's scale equals JAX's params in every case, and
    a true division would not."""
    naive_misses = 0
    for n in (77, 1000, 4099, 300000):
        for bits in (8, 4, 2):
            x = _data(n, seed=n * bits)
            _, par = _jax_encode(x, jax.random.PRNGKey(0), bits, 1 << 22,
                                 "jnp")
            lo, hi = ref.minmax_bucketed(torch.from_numpy(x)[None])
            np.testing.assert_array_equal(
                _u32(ref.scale_of(lo, hi, bits).numpy()), _u32(par[:, 1]))
            naive = (hi - lo) / float((1 << bits) - 1)
            naive_misses += int(not np.array_equal(_u32(naive.numpy()),
                                                   _u32(par[:, 1])))
    assert naive_misses > 0


def test_decode_is_one_rounding_like_xla_fma():
    """Fault 2: XLA fuses codes * scale + lo into one FMA. The port's
    float64-then-round decode matches it bit for bit; a separate float32
    multiply and add does not."""
    unfused_misses = 0
    for bits in (8, 4):
        for n in (4099, 300000):
            x = _data(n, seed=bits + n)
            pay, par = _jax_encode(x, jax.random.PRNGKey(2), bits, 1 << 22,
                                   "jnp")
            want = np.asarray(jops.decode_flat(
                jnp.asarray(pay), jnp.asarray(par), total=n, bits=bits,
                backend="jnp"))
            codes = ref.unpack_codes(torch.from_numpy(pay)[None], bits=bits)
            lo, scale = torch.from_numpy(par[0])
            fused = ref.decode(codes, lo, scale).reshape(-1)[:n]
            unfused = (codes.float() * scale + lo).reshape(-1)[:n]
            np.testing.assert_array_equal(_u32(fused.numpy()), _u32(want))
            unfused_misses += int(not np.array_equal(_u32(unfused.numpy()),
                                                     _u32(want)))
    assert unfused_misses > 0


def test_geometry_and_edge_pad_match_jax():
    for total in (1, 77, 4096, 4097, 300000, 463_987_712):
        for bits in (8, 4, 2):
            assert ops.flat_geometry(total, bits=bits) == \
                jops.flat_geometry(total, bits=bits)
            assert ops.flat_geometry(total, bits=bits, bucket_elems=4096) \
                == jops.flat_geometry(total, bits=bits, bucket_elems=4096)
    x = _data(10)
    np.testing.assert_array_equal(
        ops.edge_pad(torch.from_numpy(x), 16).numpy(),
        np.asarray(jops.edge_pad(jnp.asarray(x), 16)))


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch; another
    device is refused (a CUDA tensor launches or raises)."""
    kernel.reset_launches()
    x = torch.zeros((2, 1, 512))
    kernel.minmax_bucketed(x)
    params = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
    pay = kernel.encode_packed(x.view(2, 1, 1, 512), prng.PRNGKey(0), params,
                               bits=8)
    kernel.decode_packed(pay, params, bits=8)
    kernel.qdq_bucketed(x.view(2, 1, 1, 512), prng.PRNGKey(0), params,
                        bits=8, first_bucket=3)
    kernel.decode_add_encode_bucketed([pay.view(2, 512)], [params],
                                      [x.view(-1)], [prng.PRNGKey(0)],
                                      bits=8, rows_b=1, rt=1)
    keys = [prng.PRNGKey(1), prng.PRNGKey(2)]
    kernel.leaf_qdq(x.view(2, 1, 1, 512), keys, params, bits=8)
    kernel.leaf_decode_packed(kernel.leaf_encode_packed(
        x.view(2, 1, 1, 512), keys, params, bits=8), params, bits=8)
    assert kernel.launch_counts() == {"minmax_bucketed": 0,
                                      "encode_packed": 0,
                                      "decode_packed": 0,
                                      "qdq_bucketed": 0,
                                      "decode_add_encode_bucketed": 0,
                                      "leaf_qdq": 0,
                                      "leaf_encode_packed": 0,
                                      "leaf_decode_packed": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.minmax_bucketed(torch.zeros((1, 1, 512), device="meta"))
    with pytest.raises(ValueError, match="bits"):
        kernel.decode_packed(pay, params, bits=3)
    with pytest.raises(ValueError, match="need"):
        kernel.minmax_bucketed(torch.zeros((2, 100)))
    with pytest.raises(ValueError, match="locals_"):
        kernel.decode_add_encode_bucketed([pay.view(2, 512)], [params],
                                          [x.view(-1)], [prng.PRNGKey(0)],
                                          bits=4, rows_b=1, rt=1)


QDQ_CASES = [(n, bits, be) for n in (77, 4099, 300000) for bits in (8, 4, 2)
             for be in (4096, 1 << 22)]


@pytest.mark.parametrize("n,bits,be", QDQ_CASES)
def test_qdq_flat_bit_equal_to_jax_and_to_decode_encode(n, bits, be):
    """qdq_flat (K1 + K4's plain versions) == JAX's qdq_flat on the jnp
    backend, and == the port's own decode_flat(encode_flat), bit for
    bit: single-bucket, multi-bucket and unaligned totals."""
    x = _data(n, seed=n * bits)
    want = jops.qdq_flat(jnp.asarray(x), jax.random.PRNGKey(n), bits=bits,
                         bucket_elems=be, backend="jnp")
    got = ops.qdq_flat(torch.from_numpy(x), prng.PRNGKey(n), bits=bits,
                       bucket_elems=be)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    pay, par = ops.encode_flat(torch.from_numpy(x), prng.PRNGKey(n),
                               bits=bits, bucket_elems=be)
    dec = ops.decode_flat(pay, par, total=n, bits=bits, bucket_elems=be)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(dec.numpy()))


@pytest.mark.parametrize("n,bits", [(77, 8), (4099, 4), (9000, 2),
                                    (12288, 8)])
def test_qdq_flat_bit_equal_to_pallas_interpret(n, bits):
    """The same against the Pallas qdq_bucketed + qdq kernels
    (interpret mode), multi-bucket at bucket_elems=4096."""
    x = _data(n, seed=3)
    want = jops.qdq_flat(jnp.asarray(x), jax.random.PRNGKey(5), bits=bits,
                         bucket_elems=4096, backend="pallas")
    got = ops.qdq_flat(torch.from_numpy(x), prng.PRNGKey(5), bits=bits,
                       bucket_elems=4096)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_qdq_plain_equals_jax_ref_and_keeps_nan(bits):
    """K4's plain version == the JAX package's jitted
    ref.qdq_bucketed given the same x and params, K4's key standing for
    JAX's jax.random.uniform(fold_in(key, b)) draws; a NaN input stays
    NaN (the reference's clip keeps it)."""
    pack = 8 // bits
    rng = np.random.default_rng(bits)
    x4 = rng.normal(size=(3, pack, 2, 512)).astype(np.float32)
    u4 = _jax_bucket_uniforms(bits + 1, 0, x4.shape)
    lo = x4.reshape(3, -1).min(1)
    scale = ((x4.reshape(3, -1).max(1) - lo) / 15).astype(np.float32)
    want = np.asarray(jax.jit(jref.qdq_bucketed, static_argnames="bits")(
        x4, u4, lo, scale, bits=bits))
    params = torch.from_numpy(np.stack([lo, scale], 1))
    got = kernel.qdq_bucketed(torch.from_numpy(x4), prng.PRNGKey(bits + 1),
                              params, bits=bits)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    x4[1, 0, 0, 3] = np.nan
    got = kernel.qdq_bucketed(torch.from_numpy(x4), prng.PRNGKey(bits + 1),
                              params, bits=bits)
    assert np.isnan(got[1, 0, 0, 3]) and np.isfinite(got[0]).all()


def test_qdq_flat_donation_writes_over_an_aligned_input():
    """donate=True lets K4 write over the caller's buffer when no pad
    is needed; without it the input is untouched. Same values."""
    x = torch.from_numpy(_data(3 * 4096, seed=1))
    keep = x.clone()
    q = ops.qdq_flat(x, prng.PRNGKey(2), bits=4, bucket_elems=4096)
    assert torch.equal(x, keep) and q.data_ptr() != x.data_ptr()
    qd = ops.qdq_flat(x, prng.PRNGKey(2), bits=4, bucket_elems=4096,
                      donate=True)
    assert qd.data_ptr() == x.data_ptr()
    assert torch.equal(qd.view(torch.int32), q.view(torch.int32))
