"""The port's threefry key stream against ``jax.random`` on the CPU.

Raw bits, split, fold_in, uniform, bernoulli and randint must be
bit-equal.  normal goes through erf_inv, whose float32 polynomial the port
re-states on the replay of XLA's log1p (``rng.log1p``); a few draws in
10^5 still differ, by up to 2 ulp of the drawn value.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch import rng  # noqa: E402

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]
NORMAL_ULP = 2.0


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _keys(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_bits_exact(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(rng.split(tk, num).numpy(),
                                      _u32(jax.random.split(jk, num)))
    for data in (0, 7, 2**32 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(tk, data).numpy(),
            _u32(jax.random.fold_in(jk, np.uint32(data))))
    for shape in ((), (5,), (3, 7), (2, 3, 4)):
        np.testing.assert_array_equal(rng.random_bits(tk, shape).numpy(),
                                      _u32(jax.random.bits(jk, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bernoulli_randint_exact(seed):
    jk, tk = _keys(seed)
    u = np.asarray(jax.random.uniform(jk, (513,)))
    np.testing.assert_array_equal(rng.uniform(tk, (513,)).numpy().view(
        np.int32), u.view(np.int32))
    u = np.asarray(jax.random.uniform(jk, (64,), minval=-2.0, maxval=3.0))
    np.testing.assert_array_equal(
        rng.uniform(tk, (64,), -2.0, 3.0).numpy().view(np.int32),
        u.view(np.int32))
    for p in (0.05, 0.5, 0.9):
        np.testing.assert_array_equal(
            rng.bernoulli(tk, p, (17, 9)).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, (17, 9))))
    for lo, hi in ((0, 10), (0, 858880), (3, 2**20 + 7), (0, 1), (5, 5),
                   (0, 2**31 - 1)):
        np.testing.assert_array_equal(
            rng.randint(tk, (300,), lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, (300,), lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulp(seed):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.normal(jk, (20000,)))
    got = rng.normal(tk, (20000,)).numpy()
    ulp = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))
    assert ulp.max() <= NORMAL_ULP


def test_batched_keys_match_vmap():
    """A [P, 2] batch of keys maps like ``vmap`` over keys in JAX."""
    jk, tk = _keys(5)
    jks, tks = jax.random.split(jk, 4), rng.split(tk, 4)
    np.testing.assert_array_equal(
        rng.randint(tks, (50,), 0, 1000).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (50,), 0, 1000))(
            jks)))
    np.testing.assert_array_equal(
        rng.split(tks, 3).numpy(),
        _u32(jax.vmap(lambda k: jax.random.split(k, 3))(jks)))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (16,)))(jks))
    got = rng.normal(tks, (16,)).numpy()
    assert (np.abs(got - want) / np.spacing(np.abs(want))).max() <= NORMAL_ULP


def test_chunked_draw_matches_one_pass(monkeypatch):
    """Large draws hash their counters in chunks; chunking must not change
    the stream."""
    _, tk = _keys(9)
    whole = rng.normal(tk, (3, 1000))
    monkeypatch.setattr(rng, "_CHUNK", 128)
    np.testing.assert_array_equal(rng.normal(tk, (3, 1000)).numpy(),
                                  whole.numpy())
    np.testing.assert_array_equal(
        rng.randint(tk, (777,), 0, 50).numpy(),
        np.asarray(jax.random.randint(jax.random.PRNGKey(9), (777,), 0, 50)))


def test_erfinv_matches_xla():
    x = np.linspace(-0.9999, 0.9999, 4001).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = rng.erfinv(torch.from_numpy(x)).numpy()
    ulp = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))
    assert ulp.max() <= NORMAL_ULP
    assert np.isinf(rng.erfinv(torch.tensor([1.0, -1.0]))).all()


def test_seed_range_checked():
    with pytest.raises(ValueError, match="32-bit"):
        rng.PRNGKey(2**32)
    with pytest.raises(TypeError, match="int64"):
        rng.split(torch.zeros(2, dtype=torch.int32))
