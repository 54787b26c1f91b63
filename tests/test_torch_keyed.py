"""K2 and K4 keyed: their plain versions against the JAX package's draws.

K2 (``encode_packed``) and K4 (``qdq_bucketed``) take a key, not a
uniform tensor, and draw JAX's ``jax.random.uniform`` bits themselves:
bucket b of a flat buffer under ``fold_in(key, b)`` (the head buckets
from bucket 0, the tail from bucket nb - 1), a leaf message under its own
key. Their plain versions (``ref.encode_packed_keyed``,
``ref.qdq_keyed``), which the wrappers run on a CPU tensor, are held bit
for bit against JAX's draws fed to the JAX package's jitted reference and
to its Pallas kernels in interpret mode, at bits 8/4/2, on Inf/NaN
buckets, and over leaf rows with distinct and with repeated keys. The
CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant import kernel as jkernel
from repro.kernels.quant import ops as jops
from repro.kernels.quant import ref as jref
from repro_torch.core import prng
from repro_torch.kernels.quant import kernel, ops, ref

LANES = 512


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same_bits(want, got) -> None:
    """Equal bits where not NaN, NaN at the same places."""
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert w.shape == g.shape
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan)
    np.testing.assert_array_equal(_u32(g[~nan]), _u32(w[~nan]))


def _buckets(b, bits, rows, seed, special):
    """(b, pack, rows, 512) fp32 buckets and their (b, 2) [lo, scale]
    (the port's K1 plain version and scale, JAX's bit for bit); with
    ``special`` bucket 0 holds an Inf and bucket b - 1 a NaN."""
    pack = 8 // bits
    x4 = (np.random.default_rng(seed).normal(size=(b, pack, rows, LANES))
          * 0.05).astype(np.float32)
    if special:
        x4[0, 0, 0, 7] = np.inf
        x4[b - 1, pack - 1, rows - 1, 9] = np.nan
    params = ops.bucket_params(torch.from_numpy(x4).reshape(b, -1),
                               bits=bits).numpy()
    return x4, params


def _jax_uniforms(seed, first, shape):
    """jax.random.uniform(fold_in(PRNGKey(seed), first + b), shape[1:])
    for each bucket b."""
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, first + b), shape[1:], jnp.float32))
        for b in range(shape[0])])


# the head buckets of a 5-bucket buffer (first 0), and its tail (B = 1 at
# first nb - 1 = 4)
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("b,first", [(4, 0), (1, 4)])
@pytest.mark.parametrize("special", [False, True])
def test_keyed_plain_versions_equal_jax_draws_and_pallas(bits, b, first,
                                                         special):
    """ref.qdq_keyed / ref.encode_packed_keyed under fold_in(key, first +
    b) == JAX's draws fed to its jitted ref and its Pallas kernels
    (interpret mode), bit for bit; so do the K2 / K4 wrappers on CPU
    tensors, which count no launch."""
    x4, params = _buckets(b, bits, 8, seed=bits * 10 + b, special=special)
    seed = 3 + bits
    u4 = _jax_uniforms(seed, first, x4.shape)
    lo, scale = params[:, 0], params[:, 1]
    keys = ref.fold_keys(prng.PRNGKey(seed), first, b)
    tx, tlo, tsc = (torch.from_numpy(a) for a in (x4, lo, scale))

    q = ref.qdq_keyed(tx, keys, tlo, tsc, bits=bits)
    pay = ref.encode_packed_keyed(tx, keys, tlo, tsc, bits=bits)
    _same_bits(jax.jit(jref.qdq_bucketed, static_argnames="bits")(
        x4, u4, lo, scale, bits=bits), q)
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jax.jit(
        jref.encode_packed_bucketed, static_argnames="bits")(
        x4, u4, lo, scale, bits=bits)))
    _same_bits(jkernel.qdq_bucketed(x4, u4, params, bits=bits, block_r=8,
                                    interpret=True), q)
    np.testing.assert_array_equal(pay.numpy(), np.asarray(
        jkernel.encode_packed_bucketed(x4, u4, params, bits=bits,
                                       block_r=8, interpret=True)))

    kernel.reset_launches()
    tp = torch.from_numpy(params)
    _same_bits(q, kernel.qdq_bucketed(tx, prng.PRNGKey(seed), tp, bits=bits,
                                      first_bucket=first))
    assert torch.equal(pay, kernel.encode_packed(
        tx, prng.PRNGKey(seed), tp, bits=bits, first_bucket=first))
    assert not any(kernel.launch_counts().values())


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("repeat", [False, True])
def test_leaf_rows_keyed_equal_jax_per_leaf(bits, repeat):
    """The per-leaf forms over 3 workers' odd-sized leaves, one key a
    row (the first and last the same key with ``repeat``, as a server's
    shared key gives), one holding Inf and NaN: ops.quantize_dequantize_rows
    and ops.encode_rows (K4 / K2 as leaf launches, their plain versions
    here) == JAX's per-leaf quantize_dequantize and encode of each row
    under its key, and K4 == K3(K2(x)) where finite."""
    n = 1000
    x_w = (np.random.default_rng(bits).normal(size=(3, n)) * 0.3).astype(
        np.float32)
    x_w[1, 3], x_w[1, 5] = np.inf, np.nan
    seeds = [11, 12, 11] if repeat else [11, 12, 13]
    keys = [prng.PRNGKey(s) for s in seeds]
    q = ops.quantize_dequantize_rows(torch.from_numpy(x_w), keys, bits=bits)
    pay, par = ops.encode_rows(torch.from_numpy(x_w), keys, bits=bits)
    dec = ops.decode_rows(pay, par, shape=(n,), bits=bits)
    for i, s in enumerate(seeds):
        jkey = jax.random.PRNGKey(s)
        backend = "pallas" if i == 0 else "jnp"
        _same_bits(jops.quantize_dequantize(jnp.asarray(x_w[i]), jkey,
                                            bits=bits, backend=backend), q[i])
        jpay, jpar = jops.encode(jnp.asarray(x_w[i]), jkey, bits=bits,
                                 backend=backend)
        np.testing.assert_array_equal(pay[i].numpy(), np.asarray(jpay))
        _same_bits(np.asarray(jpar)[0], par[i])
    for i in (0, 2):
        _same_bits(q[i], dec[i])
    if repeat:      # the same key draws the same uniforms
        x4, params = ops._leaf_rows(torch.from_numpy(x_w[[0, 0]]),
                                    [keys[0], keys[2]], bits=bits)
        pair = kernel.leaf_qdq(x4, [keys[0], keys[2]], params, bits=bits)
        _same_bits(pair[0], pair[1])


def test_leaf_launches_are_cut_past_the_argument_block():
    """A per-leaf launch carries ROW_MAX_KEYS keys: more rows are cut
    into launches of consecutive rows, each with its rows' key words; a
    bucketed launch is one, with the root key folded on the card."""
    rows = 2 * kernel.ROW_MAX_KEYS + 7
    keys = [prng.fold_in(prng.PRNGKey(1), i) for i in range(rows)]
    seen = []
    kernel._launch_rows(lambda r, w, fold, first: seen.append(
        (r.start, r.stop, w.tolist(), fold, first)), rows, None, 0, keys)
    assert [(a, b) for a, b, *_ in seen] == [
        (0, 256), (256, 512), (512, rows)]
    assert all(f == 0 for *_, f, _ in seen)
    assert [w for _, _, ws, _, _ in seen for w in ws] == [
        list(prng.key_words(k)) for k in keys]
    seen.clear()
    kernel._launch_rows(lambda r, w, fold, first: seen.append(
        (r.start, r.stop, w.tolist(), fold, first)), rows, prng.PRNGKey(7),
        30, None)
    assert seen == [(0, rows, [[0, 7]], 1, 30)]


def test_keyed_wrappers_refuse_counters_past_32_bits_and_wrong_keys():
    """A row of 2**32 elements, buckets past 2**32 and a key list of the
    wrong length raise, before any draw."""
    big = torch.zeros(()).expand(1, 1, 1 << 23, LANES)     # 2**32 elements
    params = torch.zeros((1, 2))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        kernel.encode_packed(big, prng.PRNGKey(0), params, bits=8)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        kernel.leaf_qdq(big, [prng.PRNGKey(0)], params, bits=8)
    x4 = torch.zeros((2, 1, 1, LANES))
    with pytest.raises(ValueError, match="32 bits"):
        kernel.qdq_bucketed(x4, prng.PRNGKey(0), torch.zeros((2, 2)),
                            bits=8, first_bucket=(1 << 32) - 1)
    with pytest.raises(ValueError, match="keys"):
        kernel.leaf_encode_packed(x4, [prng.PRNGKey(0)], torch.zeros((2, 2)),
                                  bits=8)
