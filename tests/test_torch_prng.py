"""utils/prng.py against jax.random, bit for bit: PRNGKey, split, randint
(the fitting diagnostic's partition tags and the bootstrap's row draws),
uniform, and the bootstrap's resample counts, under the tree's defaults
(threefry2x32, partitionable, 32-bit types)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.bootstrap import bootstrap_weights
from photon_ml_tpu_torch.utils import prng

SEEDS = [0, 1, 42, -5, 2**31 - 1, 20260729]


def test_the_defaults_the_port_reproduces():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(key))
    for num in (1, 2, 7, 10):
        np.testing.assert_array_equal(prng.split(prng.prng_key(seed), num),
                                      np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((262144,), 0, 10),          # the fitting tags at phase 6's training rows
    ((1000,), 0, 1000),          # a bootstrap replicate's row draw
    ((262144,), 0, 262144),      # the same at full size: hi * mult wraps in uint32
    ((37, 5), -3, 1000003),
    ((8,), 5, 5),                # empty range: minval
    ((100,), 0, 2**31 - 1),
])
def test_randint(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    got = prng.randint(prng.prng_key(seed), shape, lo, hi)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.0)])
def test_uniform(seed, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4096,), jnp.float32, lo, hi))
    got = prng.uniform(prng.prng_key(seed), (4096,), lo, hi)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("k,n", [(10, 1000), (3, 4104)])
def test_bootstrap_counts_are_the_jax_bootstrap_weights(seed, k, n):
    want = np.asarray(bootstrap_weights(jax.random.PRNGKey(seed), k, n))
    got = prng.bootstrap_counts(seed, k, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) == n).all()
