"""tpu_ray_torch.core.rng against tpu_ray.core.rng and jax.random: the
murmur3 lane streams and the numpy threefry2x32 key chains are bit-equal."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ray.core import rng as jrng
from tpu_ray_torch.core import rng

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                np.uint32)


def _u32(seed, n=1000):
    r = np.random.default_rng(seed)
    return np.concatenate([EDGE, r.integers(0, 1 << 32, n, dtype=np.uint32)])


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_hash_uniforms_bit_equal():
    a = _u32(1)
    want = np.asarray(jrng.hash_uniforms(jnp.asarray(a), 7))
    got = rng.hash_uniforms(_t(a), 7).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_hash_uniforms2_and_path_ids_bit_equal():
    a, b = _u32(2), _u32(3)
    want = np.asarray(jrng.hash_uniforms2(jnp.asarray(a), jnp.asarray(b), 5))
    np.testing.assert_array_equal(rng.hash_uniforms2(_t(a), _t(b), 5).numpy(),
                                  want)
    want = np.asarray(jrng.path_ids(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        rng.path_ids(_t(a), _t(b)).numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 7, 1024])
def test_lane_streams_bit_equal(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    kd = np.asarray(jax.random.key_data(key))
    ids = _u32(seed + 10)
    want = np.asarray(jrng.lane_uniforms(key, jnp.asarray(ids), 15))
    np.testing.assert_array_equal(rng.lane_uniforms(kd, _t(ids), 15).numpy(),
                                  want)
    want14 = np.asarray(jrng.lane_uniform_col(key, jnp.asarray(ids), 14))
    np.testing.assert_array_equal(
        rng.lane_uniform_col(kd, _t(ids), 14).numpy(), want14)


def test_int32_bit_patterns_hash_like_uint32():
    """Slot ids ride in int32 tensors; their bits must hash as uint32."""
    ids = _u32(5)
    as_i32 = torch.from_numpy(ids.view(np.int32))
    np.testing.assert_array_equal(rng.hash_uniforms(as_i32, 3).numpy(),
                                  rng.hash_uniforms(_t(ids), 3).numpy())


@pytest.mark.parametrize("seed", [0, 1, 11, 1024, 2**31 - 1])
def test_threefry_key_chains_bit_equal(seed):
    """PRNGKey(seed) -> fold_in(base, wave) -> fold_in(k_loop, it) ->
    fold_in(kb, 0 / 1): the integrator's chains, word for word."""
    base = jax.random.PRNGKey(seed)
    nb = rng.prng_key(seed)
    np.testing.assert_array_equal(nb, np.asarray(jax.random.key_data(base)))
    for wave in (0, 3):
        k_loop = jax.random.fold_in(base, wave)
        nk = rng.fold_in(nb, wave)
        np.testing.assert_array_equal(nk, np.asarray(k_loop))
        ki, ks = rng.pool_key_tables(nk, 40)
        for it in (0, 1, 17, 39):
            kb = jax.random.fold_in(k_loop, it)
            np.testing.assert_array_equal(
                ki[it], np.asarray(jax.random.key_data(
                    jax.random.fold_in(kb, 0))))
            np.testing.assert_array_equal(
                ks[it], np.asarray(jax.random.key_data(
                    jax.random.fold_in(kb, 1))))


def test_fold_in_large_data():
    key = jax.random.PRNGKey(3)
    for d in (0xFFFFFFFF, 0x80000000, 123456789):
        np.testing.assert_array_equal(
            rng.fold_in(rng.prng_key(3), d),
            np.asarray(jax.random.fold_in(key, np.uint32(d))))
