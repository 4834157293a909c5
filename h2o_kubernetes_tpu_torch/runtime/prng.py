"""A bitwise twin of ``jax.random``'s default generator, threefry2x32.

The JAX package draws every random number of training with
``jax.random`` (the default ``threefry2x32`` implementation, with
``jax_threefry_partitionable`` on): the bin-edge row sample, DRF's
per-tree bootstrap, the per-tree column mask and the per-node mtries
feature draw. A ``torch.Generator`` gives other numbers from the same
seed, so a seeded model would grow other trees. This module computes
the same bits:

- ``key(seed)``: the raw key ``[seed >> 32, seed & 0xFFFFFFFF]``;
- ``split(key, n)``: the partitionable ("fold-like") split, threefry of
  the counters ``(i >> 32, i & 0xFFFFFFFF)`` for i < n;
- ``fold_in(key, data)``: threefry of the pair ``(0, data)``; ``data``
  a Python int, or an integer tensor of row ids, one key per element
  (``jax.vmap(jax.random.fold_in, in_axes=(None, 0))``);
- ``random_bits(key, shape)``: 32-bit draws, ``y0 ^ y1`` of the
  threefry of each element's row-major counter;
- ``uniform(key, shape, minval, maxval)``: the mantissa trick,
  ``f = f32(bits >> 9 | 0x3F800000) - 1``, then
  ``max(minval, f·(maxval − minval) + minval)`` in float32 with the
  multiply-add fused, as XLA's CPU backend emits it;
- ``bernoulli(key, p, shape)``: ``uniform(key, shape) < f32(p)``;
- ``normal(key, shape)``: ``sqrt(2)·erf_inv(u)`` with u uniform on
  ``[nextafter(-1, 0), 1)``, through XLA's float32 ``erf_inv`` (Giles'
  polynomial) and its ``log1p`` (a Cephes rational for small
  arguments, else its own ``log`` polynomial), transcribed operation
  by operation with the same fused multiply-adds;
- ``randint(key, shape, lo, hi)``: two 32-bit draws per value combined
  by the multiply-mod of ``jax.random.randint`` (int32 sampling).

Keys are explicit int64 tensors of shape [..., 2] holding uint32 words;
there is no global state. A leading batch of keys ([T, 2]) draws T
independent streams at once ([T, *shape]). torch's uint32 lacks the
shifts and arithmetic, so every word is an int64 masked to 32 bits.
Because every draw is a function of the element's counter alone,
draws are prefix-stable: ``split(k, 16)[:10] == split(k, 10)`` and
``uniform(k, (10,))[:5] == uniform(k, (5,))``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key", "split", "fold_in", "random_bits", "uniform", "randint",
           "bernoulli", "normal", "threefry2x32"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block (20 rounds) of ``jax._src.prng``: key
    words k0, k1 and counter words x0, x1 (int64 tensors of uint32
    values, broadcast together) -> the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as its raw [2] words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def _counts(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def _words(k: torch.Tensor, extra_dims: int):
    """The key words of a [..., 2] key, shaped to broadcast against
    ``extra_dims`` trailing counter dimensions."""
    shape = k.shape[:-1] + (1,) * extra_dims
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """[..., 2] key -> [..., n, 2] keys (``jax.random.split``)."""
    c0, c1 = _counts(n, k.device)
    k0, k1 = _words(k, 1)
    y0, y1 = threefry2x32(k0, k1, c0, c1)
    return torch.stack([y0, y1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """[..., 2] key -> [..., 2] key (``jax.random.fold_in``). With an
    integer tensor ``data`` of shape [n], one [2] key folds with each
    element -> [n, 2] keys (the JAX package's ``jax.vmap(fold_in,
    in_axes=(None, 0))``, as GOSS keys its per-row draws by row id)."""
    if isinstance(data, torch.Tensor):
        if k.dim() != 1:
            raise ValueError("fold_in over a data tensor takes one [2] key")
        d = data.to(device=k.device, dtype=torch.int64) & _M32
        y0, y1 = threefry2x32(k[0], k[1], 0, d)
        return torch.stack([y0, y1], dim=-1)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & _M32)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """[..., 2] key -> [..., *shape] uint32 words (int64)."""
    shape = tuple(int(s) for s in shape)
    c0, c1 = _counts(math.prod(shape), k.device)
    k0, k1 = _words(k, 1)
    y0, y1 = threefry2x32(k0, k1, c0, c1)
    return (y0 ^ y1).reshape(k.shape[:-1] + shape)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as a fused multiply-add (XLA's
    CPU backend contracts a multiply feeding one add into an FMA). The
    product of two float32 values is exact in float64; the float64 sum
    is made round-to-odd (its exact error, from TwoSum, moves an inexact
    sum with an even last bit one ulp toward the exact value), and a
    round-to-odd float64 rounds to float32 as the exact value would,
    since float64 carries more than float32's 24 bits + 2. A plain
    float64 sum would round twice: wrong where it lands on a float32
    halfway point the exact value is not on."""
    p = a.double() * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), e)
    fix = even & (e != 0) & torch.isfinite(e)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """[..., 2] key -> [..., *shape] float32 in [minval, maxval)
    (``jax.random.uniform``). The bounds are float32, their span a
    float32 difference, and ``f·span + minval`` one fused multiply-add."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f                        # f·1 + 0 and max(0, f) are f
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(lo)))
    return torch.clamp_min(_fma(f, span, lo), lo)


def bernoulli(k: torch.Tensor, p: float, shape) -> torch.Tensor:
    """[..., 2] key -> [..., *shape] bool, true with probability p
    (``jax.random.bernoulli``: a float32 uniform below float32 p)."""
    return uniform(k, shape) < float(np.float32(p))


# XLA's float32 log1p on the CPU: |x| < 0.41421357 takes the Cephes
# rational x - x²/2 + x³·P(x)/Q(x); otherwise log(1 + x) through the
# Cephes logf polynomial on the mantissa in [sqrt(1/2), sqrt(2))
_LOG1P_P = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
            57.112965, 20.039553)
_LOG1P_Q = (1.0, 15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
            60.11866)
_LOGF_A = ((0.070376836, -0.1151461, 0.116769984),
           (-0.12420141, 0.14249323, -0.16668057),
           (0.20000714, -0.24999994, 0.3333333))
# Giles' erf_inv polynomial, w < 5 and w >= 5 (XLA's ErfInv32)
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (float64 carries more than twice
    float32's precision, so its rounding to float32 is exact; torch's
    float32 CPU sqrt is not always correctly rounded)."""
    return torch.sqrt(a.double()).float()


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a / b`` (as ``_sqrt``)."""
    return (a.double() / b.double()).float()


def _c(v: float) -> float:
    """A constant as the float32 XLA holds it."""
    return float(np.float32(v))


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p`` for x > -1, operation by operation."""
    v = x + 1.0
    bits = torch.clamp_min(v, _c(1.1754944e-38)).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    ef = ((bits >> 23) - 127).float() + 1.0
    low = m < _c(0.70710677)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    ef = ef - low.float()
    z = t * t
    x3 = z * t
    p = [_fma(_fma(t, _c(a), _c(b)), t, _c(c)) for a, b, c in _LOGF_A]
    q = _fma(_fma(p[0], x3, p[1]), x3, p[2])
    y = _fma(q, x3, ef * _c(-0.00021219444))
    big = _fma(ef, 0.693359375, (t - z * 0.5) + y)
    x2 = x * x
    num = torch.full_like(x, _c(_LOG1P_P[0]))
    den = torch.ones_like(x)
    for a, b in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
        num = _fma(num, x, _c(a))
        den = _fma(den, x, _c(b))
    small = x + _fma(x2, -0.5, (x * x2) * _div(num, den))
    return torch.where(torch.abs(x) < _c(0.41421357), small, big)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles), every multiply-add fused."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    lt_c = torch.tensor(_ERFINV_LT, dtype=torch.float32, device=x.device)
    ge_c = torch.tensor(_ERFINV_GE, dtype=torch.float32, device=x.device)
    coef = torch.where(lt[..., None], lt_c, ge_c)
    p = coef[..., 0]
    for i in range(1, len(_ERFINV_LT)):
        p = _fma(p, w, coef[..., i].double())
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """[..., 2] key -> [..., *shape] float32 standard normals
    (``jax.random.normal``)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return _erf_inv(u) * _c(np.sqrt(2.0))


def randint(k: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """[..., 2] key -> [..., *shape] int64 in [lo, hi)
    (``jax.random.randint`` with its default int32 sampling)."""
    if not -2 ** 31 <= lo < hi <= 2 ** 31 - 1:
        raise ValueError(f"randint needs -2^31 <= lo < hi < 2^31, got "
                         f"[{lo}, {hi})")
    ks = split(k, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = hi - lo
    # uint32 arithmetic: every product and sum wraps at 2^32
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return lo + off
