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
  by operation with the same fused multiply-adds (``xla_math``);
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

from . import xla_math

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
    return torch.clamp_min(xla_math.fma(f, span, lo), lo)


def bernoulli(k: torch.Tensor, p: float, shape) -> torch.Tensor:
    """[..., 2] key -> [..., *shape] bool, true with probability p
    (``jax.random.bernoulli``: a float32 uniform below float32 p)."""
    return uniform(k, shape) < float(np.float32(p))


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """[..., 2] key -> [..., *shape] float32 standard normals
    (``jax.random.normal``)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return xla_math.erf_inv(u) * float(np.float32(np.sqrt(2.0)))


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
