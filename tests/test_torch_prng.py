"""repro_torch.core.prng against jax.random: keys, fold_in, split,
uniform and categorical draws are bit-equal (partitionable threefry)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def test_reference_draws_with_the_partitionable_layout():
    """The port implements only the partitionable layout; these tests
    are written for it and refuse the legacy one."""
    assert jax.config.jax_threefry_partitionable is True
    prng.check_layout(jax.config.jax_threefry_partitionable)
    with pytest.raises(NotImplementedError, match="partitionable"):
        prng.check_layout(False)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prngkey_fold_in_split(seed):
    k, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(k), pk.numpy())
    for data in (0, 1, 7, 0x7FFFFFFF - 3, 2**32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(k, data)),
                                      prng.fold_in(pk, data).numpy())
    np.testing.assert_array_equal(_np(jax.random.split(k, 5)),
                                  prng.split(pk, 5).numpy())
    np.testing.assert_array_equal(_np(jax.random.split(k)),
                                  prng.split(pk).numpy())


@pytest.mark.parametrize("shape", [(3,), (4, 2, 512), (1000, 513),
                                   (2, 3, 5, 7), (1, 2, 8, 512)])
def test_uniform_bit_equal(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    got = prng.uniform(prng.fold_in(prng.PRNGKey(3), 11), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_with_range_bit_equal():
    k = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.uniform(k, (4097,), jnp.float32,
                                         minval=-2.0, maxval=3.0))
    got = prng.uniform(prng.PRNGKey(9), (4097,), minval=-2.0,
                       maxval=3.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_threefry_runs_alike_on_ints_and_tensors():
    ints = prng.threefry2x32(0x12345678, 0x9ABCDEF0, 7, 0xFFFFFFFF)
    t = prng.threefry2x32(0x12345678, 0x9ABCDEF0,
                          torch.tensor([7], dtype=torch.int64),
                          torch.tensor([0xFFFFFFFF], dtype=torch.int64))
    assert ints == (int(t[0]), int(t[1]))


@pytest.mark.parametrize("shape", [(2000,), (2, 3, 512), (1, 4, 2, 512)])
def test_element_counter_is_its_flat_index(shape):
    """Element i (flat, C order) of a draw hashes the counter (0, i): the
    layout the card's Threefry (csrc/threefry.cuh) hashes per element, so
    a bucket's (pack, R, 512) draw and the tail's (1, pack, R, 512) one
    need no table. JAX's bits and uniforms, and the port's, at counters
    0 .. n - 1."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    pkey = prng.fold_in(prng.PRNGKey(3), 5)
    n = int(np.prod(shape))
    lo = torch.arange(n, dtype=torch.int64)
    y0, y1 = prng.threefry2x32(*prng.key_words(pkey), torch.zeros_like(lo),
                               lo)
    bits = (y0 ^ y1).reshape(shape)
    np.testing.assert_array_equal(
        bits.numpy().astype(np.uint32),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    assert torch.equal(prng.random_bits(pkey, shape), bits)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    np.testing.assert_array_equal(
        prng.bits_to_unit(bits).numpy().view(np.uint32),
        want.view(np.uint32))


@pytest.mark.parametrize("scale", [0.5, 3.0, 30.0])
def test_categorical_matches_jax(scale):
    """The engine's sampler: split keys, one categorical per row."""
    rng = np.random.default_rng(int(scale * 10))
    logits = (rng.normal(size=(8, 1000)) * scale).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 8)
    pkeys = prng.split(prng.PRNGKey(5), 8)
    want = [int(jax.random.categorical(keys[i], logits[i]))
            for i in range(8)]
    got = [int(prng.categorical(pkeys[i], torch.from_numpy(logits[i])))
           for i in range(8)]
    assert got == want


def test_gumbel_close_to_jax():
    """Gumbel noise agrees to the last float32 bit or so (XLA's log is
    not correctly rounded); that slack cannot move an argmax unless two
    classes tie within it."""
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (20000,)))
    got = prng.gumbel(prng.PRNGKey(1), (20000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
