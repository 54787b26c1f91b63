"""repro_torch's data path against repro's: ``prng.randint`` and
``prng.bernoulli`` draw ``jax.random``'s bits, and ``SyntheticLM``'s
successor table and ``batch_at`` give the JAX package's tokens and
labels exactly (int32, same shapes)."""
import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.core import prng
from repro_torch.data.pipeline import SyntheticLM

RANGES = [(0, 512, (8,)), (0, 8, (4, 65)), (0, 32768, (3, 257)),
          (-5, 70_000, (100,)), (-(1 << 31), (1 << 31) - 1, (50,)),
          (3, 3, (4,)), (0, 1, (6,))]


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
@pytest.mark.parametrize("lo,hi,shape", RANGES)
def test_randint_bit_equal_to_jax(seed, lo, hi, shape):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi))
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 1 << 31)


@pytest.mark.parametrize("p", [0.05, 0.5, 0.999])
@pytest.mark.parametrize("seed", [0, 11])
def test_bernoulli_bit_equal_to_jax(p, seed):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                           (7, 33)))
    got = prng.bernoulli(prng.PRNGKey(seed), p, (7, 33))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 65, 2, 0),
                                                   (32768, 257, 8, 3),
                                                   (1000, 17, 3, 9)])
def test_synthetic_lm_batches_equal_jax(vocab, seq, batch, seed):
    j = JSyntheticLM(vocab=vocab, seq_len=seq, batch=batch, seed=seed)
    t = SyntheticLM(vocab=vocab, seq_len=seq, batch=batch, seed=seed)
    np.testing.assert_array_equal(t.succ.numpy(), j.succ)
    for step in (0, 7, 1000):
        jb, tb = j.batch_at(step), t.batch_at(step)
        for k in ("tokens", "labels"):
            want = np.asarray(jb[k])
            assert tb[k].dtype == torch.int32
            assert tuple(tb[k].shape) == want.shape == (batch, seq - 1)
            np.testing.assert_array_equal(tb[k].numpy(), want)
        np.testing.assert_array_equal(tb["tokens"][:, 1:].numpy(),
                                      tb["labels"][:, :-1].numpy())


def test_synthetic_lm_explicit_key_equals_jax():
    j = JSyntheticLM(vocab=300, seq_len=20, batch=2, seed=1)
    t = SyntheticLM(vocab=300, seq_len=20, batch=2, seed=1)
    jb = j.batch_at(3, key=jax.random.PRNGKey(42))
    tb = t.batch_at(3, key=prng.PRNGKey(42))
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
