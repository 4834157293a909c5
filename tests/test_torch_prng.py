"""PyTorch port, the threefry twin (``runtime/prng.py``): every draw
is BITWISE equal to ``jax.random`` (threefry2x32, partitionable) — the
raw key words, split, fold_in, uniform (with and without a range),
bernoulli, normal (through XLA's float32 erf_inv and log1p), and the
bin-edge row sample ``randint(key(0x51BB), (65536,), 0, n)`` — and draws
are prefix-stable, so grouping forest trees cannot change their keys."""

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


@pytest.mark.parametrize("lo,hi", [(-0.5 / 32, 0.5 / 32),
                                   (-0.5 / 100, 0.5 / 100),
                                   (-0.5 / 7, 0.5 / 7), (2.0, 5.5)])
def test_uniform_range_bitwise(lo, hi):
    """uniform(minval, maxval): the float32 bounds and one fused
    multiply-add, bitwise (Word2Vec's Win init is the first case); an
    unfused multiply-add disagrees, so the test tells them apart."""
    k = jax.random.fold_in(jax.random.key(1), 4)
    want = np.asarray(jax.random.uniform(k, (5000, 20), minval=lo,
                                         maxval=hi))
    got = prng.uniform(prng.fold_in(prng.key(1), 4), (5000, 20), lo, hi)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("p", [0.5, 0.8, 1 - 0.1, 0.05])
def test_bernoulli_bitwise(p):
    k = jax.random.key(2)
    want = np.asarray(jax.random.bernoulli(k, p, (20_000,)))
    got = prng.bernoulli(prng.key(2), p, (20_000,)).numpy()
    np.testing.assert_array_equal(got, want)
    # batched keys draw each stream on its own
    ks = prng.split(prng.key(2), 3)
    got = prng.bernoulli(ks, p, (4, 50)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(
            jax.random.bernoulli(jax.random.split(k, 3)[i], p, (4, 50))))


@pytest.mark.parametrize("seed,shape", [(3, (250_000,)), (0, (300, 200)),
                                        (11, (7, 5))])
def test_normal_bitwise(seed, shape):
    """normal: XLA's float32 erf_inv and log1p transcribed with the same
    fused multiply-adds, and a correctly rounded sqrt: bitwise (0 ulps)
    over >= 100,000 draws, the tails (|u| > 0.9966, the sqrt branch of
    erf_inv) included."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log1p_and_erf_inv_bitwise_on_a_sweep():
    """The transcribed log1p (both of its branches) and erf_inv over a
    dense sweep of their domains, bitwise to the jitted XLA ops."""
    import jax.numpy as jnp

    x = np.linspace(-0.999999, 3.0, 400_001, dtype=np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = prng._log1p(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    u = np.linspace(-0.9999999, 0.9999999, 400_001, dtype=np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    got = prng._erf_inv(torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _fma_exact(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` correctly rounded (to nearest, ties to even)
    from the exact rational value."""
    from fractions import Fraction

    out = np.empty(len(a), np.float32)
    for i, (x, y, z) in enumerate(zip(a, b, c)):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        r = np.float32(float(v))
        near = [r, np.nextafter(r, np.float32(-np.inf)),
                np.nextafter(r, np.float32(np.inf))]
        out[i] = min(near, key=lambda t: (abs(Fraction(float(t)) - v),
                                          int(np.array(t).view(np.int32))
                                          & 1))
    return out


def _fma_halfway_cases():
    """(a, b, c) float32 whose exact a·b + c lies within 2^-53 of c's
    float32 halfway point (relative), above it with c even, below it
    with c odd: a plain float64 sum lands on the halfway point and
    rounds the wrong way. Scaled over exponents and signs."""
    rng = np.random.default_rng(0)
    a, b, c = [], [], []
    # above: m1·m2 = 2^47 + r with r < 2^18, so a·b = 2^-24 (1 + r·2^-47)
    for m1 in rng.integers(2 ** 23 + 2 ** 20, 2 ** 24, 40_000):
        r = -(2 ** 47) % int(m1)
        m2 = (2 ** 47 + r) // int(m1)
        if r < 2 ** 18 and m2 < 2 ** 24:
            a.append(m1 * 2.0 ** -23)
            b.append(m2 * 2.0 ** -48)
            c.append(1 + 2 * int(rng.integers(0, 2 ** 22)) * 2.0 ** -23)
    # below: (1 + i·2^-23)(1 - i·2^-23)·2^-24 = 2^-24 (1 - i²·2^-46)
    for i in range(1, 300):
        a.append(1 + i * 2.0 ** -23)
        b.append((1 - i * 2.0 ** -23) * 2.0 ** -24)
        c.append(1 + (2 * int(rng.integers(0, 2 ** 22)) + 1) * 2.0 ** -23)
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    e = rng.integers(-30, 30, len(a)).astype(np.float64)
    sign = np.where(rng.random(len(a)) < 0.5, -1.0, 1.0)
    return ((sign * a).astype(np.float32), (b * 2.0 ** e).astype(np.float32),
            (sign * c * 2.0 ** e).astype(np.float32))


def test_fma_rounds_once_at_halfway_points():
    """The twin's fused multiply-add is correctly rounded where a
    float64 sum rounds twice: operands whose exact a·b + c sits just off
    a float32 halfway point (where the plain float64 sum is wrong), and
    random operands; against the exact rational value, which the jitted
    XLA ``a * b + c`` (contracted into an FMA) also gives."""
    a, b, c = _fma_halfway_cases()
    rng = np.random.default_rng(1)
    ra, rb, rc = (rng.standard_normal(2000).astype(np.float32) *
                  np.float32(2.0) ** rng.integers(-20, 20, 2000)
                  for _ in range(3))
    a, b, c = (np.concatenate(v) for v in ((a, ra), (b, rb), (c, rc)))
    want = _fma_exact(a, b, c)
    ta, tb, tc = (torch.as_tensor(v) for v in (a, b, c))
    got = prng._fma(ta, tb.double(), tc).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    xla = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    np.testing.assert_array_equal(xla.view(np.int32), want.view(np.int32))
    twice = (ta.double() * tb.double() + tc.double()).float().numpy()
    assert (twice != want).sum() >= 1000       # the cases are real ones
