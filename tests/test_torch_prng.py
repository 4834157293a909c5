"""PyTorch port, the threefry twin (``runtime/prng.py``): every draw
is BITWISE equal to ``jax.random`` (threefry2x32, partitionable) — the
raw key words, split, fold_in, uniform, and the bin-edge row sample
``randint(key(0x51BB), (65536,), 0, n)`` — and draws are prefix-stable,
so grouping forest trees cannot change their keys."""

import jax
import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch.runtime import prng


def _raw(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 0x51BB, 2 ** 31 - 1])
def test_key(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _raw(jax.random.key(seed)))


@pytest.mark.parametrize("n", [1, 3, 10, 16])
def test_split(n):
    got = prng.split(prng.key(7), n).numpy()
    np.testing.assert_array_equal(got, _raw(jax.random.split(
        jax.random.key(7), n)))
    # batched keys split each on its own
    ks = prng.split(prng.key(7), 3)
    for i in range(3):
        np.testing.assert_array_equal(prng.split(ks, n)[i].numpy(), _raw(
            jax.random.split(jax.random.split(jax.random.key(7), 3)[i],
                             n)))


@pytest.mark.parametrize("data", [0, 1, 5, 2 ** 32 - 1])
def test_fold_in(data):
    k = jax.random.split(jax.random.key(11), 2)[1]
    got = prng.fold_in(prng.split(prng.key(11), 2)[1], data).numpy()
    np.testing.assert_array_equal(got, _raw(jax.random.fold_in(
        k, np.uint32(data))))


@pytest.mark.parametrize("shape", [(5,), (1000,), (4, 28), (64, 5)])
def test_uniform(shape):
    k = jax.random.fold_in(jax.random.key(3), 2)
    want = np.asarray(jax.random.uniform(k, shape))
    got = prng.uniform(prng.fold_in(prng.key(3), 2), shape).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [70_000, 1_000_000])
def test_randint_bin_sample(n):
    want = np.asarray(jax.random.randint(jax.random.key(0x51BB),
                                         (65536,), 0, n))
    got = prng.randint(prng.key(0x51BB), (65536,), 0, n).numpy()
    np.testing.assert_array_equal(got, want)


def test_prefix_stable_and_batched():
    k = prng.key(5)
    assert torch.equal(prng.split(k, 16)[:10], prng.split(k, 10))
    assert torch.equal(prng.uniform(k, (10,))[:5], prng.uniform(k, (5,)))
    ks = prng.split(k, 4)
    u = prng.uniform(ks, (3, 7))                     # [4, 3, 7]
    for i in range(4):
        assert torch.equal(u[i], prng.uniform(ks[i], (3, 7)))
