"""The port's ``jax.random`` twin (``repro_torch.random``) against
``jax.random`` in the same process, under JAX's default configuration
(threefry2x32, partitionable counters, x64 off).

Keys, ``split``, ``fold_in``, the raw bits, f32/bf16/f16 uniforms and
``categorical`` ids are bit-equal.  Normals go through XLA's ``ErfInv``
polynomial, whose ``log1p`` rounds differently in XLA and in torch: they
are held to rtol 1e-6 (about 8 f32 ulps; the largest gap seen is 3 ulps)
with at least 98% of them bit-equal at the larger shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as R

SEEDS = [0, 1, 7, 12345]
SHAPES = [(), (5,), (3, 7), (32, 158), (2, 151936)]


def _np(key):
    return np.asarray(key).astype(np.int64)


def test_jax_runs_the_configuration_the_twin_copies():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS + [2**31 - 1])
def test_key_split_fold_in_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for num in (2, 4, 21):
        np.testing.assert_array_equal(R.split(tk, num).numpy(),
                                      _np(jax.random.split(jk, num)))
    for data in (0, 3, 1_000_003, 2**32 - 1):
        np.testing.assert_array_equal(R.fold_in(tk, data).numpy(),
                                      _np(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_bit_equal(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    np.testing.assert_array_equal(R.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(jk, shape)))
    got = R.uniform(tk, shape).numpy()
    want = np.asarray(jax.random.uniform(jk, shape))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got = R.uniform(tk, shape, minval=-2.5, maxval=4.0).numpy()
    want = np.asarray(jax.random.uniform(jk, shape, minval=-2.5, maxval=4.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_tolerance(seed, shape):
    got = R.normal(R.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if want.size >= 1000:
        assert np.mean(got.view(np.int32) == want.view(np.int32)) >= 0.98


@pytest.mark.parametrize("shape", SHAPES[1:])
@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_ids_bit_equal(seed, shape):
    logits = np.random.default_rng(seed).normal(
        size=shape).astype(np.float32) * 3.0
    got = R.categorical(R.PRNGKey(seed), torch.as_tensor(logits)).numpy()
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                             jnp.asarray(logits)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_uniforms_bit_equal(dtype):
    """bf16 keeps 8 random bits (its 7 mantissa bits are fewer than 8),
    f16 keeps 16, as ``jax.random._uniform`` does."""
    for seed in SEEDS:
        got = R.uniform(R.PRNGKey(seed), (3, 50), getattr(torch, dtype))
        want = jax.random.uniform(jax.random.PRNGKey(seed), (3, 50),
                                  dtype=getattr(jnp, dtype))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_batched_forms_equal_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    tkeys = torch.as_tensor(_np(keys))
    np.testing.assert_array_equal(
        R.uniform(tkeys, (4, 3)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (4, 3)))(keys)))
    np.testing.assert_allclose(
        R.normal(tkeys, (6,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.normal(k, (6,)))(keys)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        R.fold_in(tkeys, torch.arange(5) * 7).numpy(),
        _np(jax.vmap(jax.random.fold_in)(keys, jnp.arange(5) * 7)))
    # one key against a vector of data: the column keys of colwise draws
    np.testing.assert_array_equal(
        R.fold_in(R.PRNGKey(3), torch.arange(9)).numpy(),
        _np(jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(3), i))(jnp.arange(9))))
    np.testing.assert_array_equal(
        R.split(tkeys, 3).numpy(),
        _np(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
    logits = np.random.default_rng(0).normal(size=(5, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        R.categorical(tkeys, torch.as_tensor(logits)).numpy(),
        np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                    jnp.asarray(logits))))


def test_threefry_takes_python_ints():
    """A key hashed on the host from python ints equals the tensor hash."""
    words = R.threefry2x32(0, 1_000_003, 0, 17)
    np.testing.assert_array_equal(
        np.asarray(words), R.fold_in(R.PRNGKey(1_000_003), 17).numpy())
