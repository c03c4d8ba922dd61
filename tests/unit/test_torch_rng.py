"""Port RNG (``bhr_tpu_torch/ops/random.py``) vs ``jax.random``.

Keys, splits, fold-ins and raw 32-bit draws are integer hashes and must
be bit-equal. ``uniform`` and ``randint`` must be bit-equal at every
(minval, maxval) pair the static texture generator draws with, both as
eager ``jax.random`` calls and where ``bhr_tpu`` draws inside a jitted
function (``tileable_noise``, ``periodic_pixel_noise``). ``erfinv`` is
XLA's float32 polynomial: within 2 ulps of ``jax.scipy.special.erfinv``
(XLA's ``log1p`` and its fusion of the Horner steps round differently in
the last bit; 98% of values are equal). ``beta`` (the filaments'
``delta_t``) is within 1e-5 relative; a draw that took another rejection
path would be an unrelated sample, off by O(1), so the bound also shows
that every draw took the same path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhr_tpu_torch.ops import random as trandom

SEEDS = (0, 42, 2 ** 31 - 1)
TWO_PI = 2.0 * np.pi
CPU = torch.device("cpu")
# (minval, maxval) of every jax.random.uniform call of bhr_tpu's static
# texture generator (models/disk_texture.py, ops/noise.py), and the
# normal sampler's interval.
UNIFORM_RANGES = sorted({
    (0.0, 1.0), (0.0, TWO_PI), (0.15, 0.5), (0.03, 0.08), (0.03, 0.12),
    (0.05, 0.5), (2.5, 5.0), (0.2, 0.4), (0.1, 0.3), (0.4, 0.6), (0.08, 0.20),
    (0.08, 0.15), (0.3, 2.5), (0.1, 0.7), (3.0, 6.0), (0.05, 0.95),
    (0.002, 0.008), (0.5, 1.2), (0.7, 1.0), (0.35, 0.55), (0.3, 3.0),
    (0.15, 1.0), (15.0, 30.0), (0.01, 0.15), (0.8, 1.0), (20.0, 40.0),
    (0.0, 0.03), (0.0, 0.1), (2.0, 4.0),
    (float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0),
})
RANDINT_RANGES = [(30, 60), (2, 5), (2, 4), (4, 9), (150, 301)]


def _key(seed):
    return jax.random.PRNGKey(seed), trandom.prng_key(seed)


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_threefry_layout_is_partitionable():
    # The port hashes counters in the partitionable layout; a JAX whose
    # default changed would draw other streams.
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_from_seed(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    assert tk.tolist() == [seed >> 32, seed & 0xFFFFFFFF]


@pytest.mark.parametrize("n", [2, 3, 5, 6, 7, 9, 12])
def test_split(n):
    for seed in SEEDS:
        jk, tk = _key(seed)
        np.testing.assert_array_equal(_np(jax.random.split(jk, n)),
                                      trandom.split(tk, n).numpy())


def test_split_of_a_batch_of_keys():
    # The gamma sampler splits every element's key at once, with numpy.
    jk, tk = _key(42)
    jkeys, tkeys = jax.random.split(jk, 5), trandom.split(tk, 5)
    ref = np.stack([_np(jax.random.split(k, 3)) for k in jkeys])
    np.testing.assert_array_equal(ref, trandom._split_host(tkeys.numpy(), 3))


@pytest.mark.parametrize("data", [77, 99, 100])
def test_fold_in(data):
    for seed in SEEDS:
        jk, tk = _key(seed)
        np.testing.assert_array_equal(_np(jax.random.fold_in(jk, data)),
                                      trandom.fold_in(tk, data).numpy())


@pytest.mark.parametrize("shape", [(), (300,), (32, 128)])
def test_random_bits(shape):
    for seed in SEEDS:
        jk, tk = _key(seed)
        out = trandom.random_bits(tk, shape, device=CPU)
        assert out.shape == shape
        np.testing.assert_array_equal(_np(jax.random.bits(jk, shape)), out.numpy())
        with pytest.raises(TypeError, match="device"):
            trandom.random_bits(tk, shape)  # no default device


@pytest.mark.parametrize("lo,hi", UNIFORM_RANGES)
def test_uniform_bit_equal(lo, hi):
    for seed in SEEDS:
        jk, tk = _key(seed)
        for shape in ((), (300,), (13, 17)):
            ref = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
            out = trandom.uniform(tk, shape, lo, hi, device=CPU).numpy()
            assert out.dtype == np.float32 and out.shape == shape
            np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("lo,hi", RANDINT_RANGES)
def test_randint_bit_equal(lo, hi):
    for seed in SEEDS:
        jk, tk = _key(seed)
        for shape in ((), (300,)):
            ref = np.asarray(jax.random.randint(jk, shape, lo, hi))
            out = trandom.randint(tk, shape, lo, hi, device=CPU).numpy()
            assert out.dtype == np.int32
            np.testing.assert_array_equal(out, ref)


@jax.jit
def _jitted_noise_draws(key):
    """bhr_tpu's draws as tileable_noise and periodic_pixel_noise make
    them: inside one jitted program. (tileable_noise takes the square
    root of its third draw; XLA's fused sqrt can differ from a correctly
    rounded one by an ulp, which the noise fields' tolerance covers.)"""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    return (jax.random.randint(k1, (), 30, 60),
            jax.random.uniform(k2, (60,), maxval=2.0 * jnp.pi),
            jax.random.uniform(k3, (60,)),
            jax.random.uniform(k4, (60,), minval=0.15, maxval=0.5),
            jax.random.uniform(k5, (60,), minval=0.03, maxval=0.08),
            jax.random.uniform(k6, (60,), minval=0.03, maxval=0.12),
            jax.random.uniform(key, (16, 24)) * 2.0 - 1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_inside_jit_bit_equal(seed):
    jk, tk = _key(seed)
    k = trandom.split(tk, 6)
    port = (trandom.randint(k[0], (), 30, 60, device=CPU),
            trandom.uniform(k[1], (60,), maxval=TWO_PI, device=CPU),
            trandom.uniform(k[2], (60,), device=CPU),
            trandom.uniform(k[3], (60,), 0.15, 0.5, device=CPU),
            trandom.uniform(k[4], (60,), 0.03, 0.08, device=CPU),
            trandom.uniform(k[5], (60,), 0.03, 0.12, device=CPU),
            trandom.uniform(tk, (16, 24), device=CPU) * 2.0 - 1.0)
    for ref, out in zip(_jitted_noise_draws(jk), port):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_erfinv_within_two_ulps_of_xla():
    x = np.concatenate([
        np.linspace(-0.9999999, 0.9999999, 200001, dtype=np.float32),
        np.asarray(trandom.uniform(trandom.prng_key(3), (20000,),
                                   float(np.nextafter(np.float32(-1), np.float32(0))),
                                   1.0, device=CPU))])
    ref = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    out = trandom.erfinv(torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    ulps = np.abs(out.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, ulps.max()
    assert (out == ref).mean() >= 0.98
    edge = trandom.erfinv(torch.tensor([-1.0, 1.0])).numpy()
    np.testing.assert_array_equal(edge, [-np.inf, np.inf])


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_beta_matches(seed):
    jk, tk = _key(seed)
    ref = np.asarray(jax.random.beta(jk, 0.3, 1.0, (300,)))
    out = trandom.beta(tk, 0.3, 1.0, (300,), device=CPU).numpy()
    assert out.dtype == np.float32 and out.shape == (300,)
    rel = np.abs(out.astype(np.float64) - ref) / np.maximum(np.abs(ref), 1e-30)
    assert rel.max() <= 1e-5, rel.max()


def test_beta_with_both_parameters_above_one():
    # alpha >= 1 takes the unboosted branch of the gamma sampler.
    jk, tk = _key(11)
    ref = np.asarray(jax.random.beta(jk, 2.5, 1.5, (64,)))
    out = trandom.beta(tk, 2.5, 1.5, (64,), device=CPU).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_batched_draws_equal_single_draws():
    """One hash for many keys (what the generators use) gives each key's
    own draw: a draw's bits at counter i do not depend on its size."""
    keys = list(trandom.split(trandom.prng_key(9), 4))
    shapes = [(), (60,), (3, 5), (1200,)]
    many = trandom.random_bits_many(keys, shapes, device=CPU)
    for key, shape, bits in zip(keys, shapes, many):
        np.testing.assert_array_equal(bits.numpy(), trandom.random_bits(key, shape, device=CPU).numpy())
    rows = trandom.random_bits_rows(keys, 7, device=CPU)
    assert rows.shape == (4, 7)
    np.testing.assert_array_equal(rows[2].numpy(),
                                  trandom.random_bits(keys[2], (7,), device=CPU).numpy())
