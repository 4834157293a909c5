"""XLA's CPU float32 arithmetic, bit for bit.

The JAX package compiles through XLA, whose CPU backend contracts a
multiply feeding one add into a fused multiply-add, evaluates ``log``,
``exp``, ``log1p`` and ``erf_inv`` with its own Cephes/Giles polynomials
(read from its optimized IR and object code) and rewrites ``cumsum`` as
a blocked reduce-window. torch rounds differently in the last bit, and
where a train compares float32 values (split gains on plateaus, a
bootstrap draw against a threshold) that bit decides. This module owns
the emulation:

- ``fma(a, b, c)``: float32 ``a·b + c`` rounded once;
- ``sqrt``, ``div``: correctly rounded float32 (torch's float32 CPU
  sqrt is not always);
- ``log``, ``log1p``, ``erf_inv``, ``exp``: XLA's CPU polynomials,
  operation by operation with the same fused multiply-adds (``log`` and
  ``exp`` are 1 ulp from torch's in 14% and 1% of arguments);
- ``softmax``: ``jax.nn.softmax`` over axis 1;
- ``cumsum``: ``jnp.cumsum`` in XLA's blocked order.

One rule says where they run. Where the card must equal the CPU bit for
bit (the threefry draws, the isolation forest's thresholds and path
lengths, the GOSS threshold, quantile interpolation) the twin runs on
every device. Where it only reproduces the JAX package's last bits for
a CPU train held against it (multinomial GBM's class priors and softmax
gradients, the split finder's prefix sums), the twin runs on the CPU
and the card takes torch's one op (``cpu_log``, ``cpu_softmax``,
``cpu_cumsum``): the card is held to the CPU within a tolerance, and
each twin costs the card tens of launches per call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma", "sqrt", "div", "log", "log1p", "erf_inv", "exp",
           "softmax", "cumsum", "cpu_log", "cpu_softmax", "cpu_cumsum"]


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
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


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (float64 carries more than twice
    float32's precision, so its rounding to float32 is exact; torch's
    float32 CPU sqrt is not always correctly rounded)."""
    return torch.sqrt(a.double()).float()


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a / b`` (as ``sqrt``)."""
    return (a.double() / b.double()).float()


def _c(v: float) -> float:
    """A constant as the float32 XLA holds it."""
    return float(np.float32(v))


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
# XLA's float32 exp on the CPU: x clamped to [-87.8, 88.8], m =
# floor(x·log2(e) + 1/2) clamped to ±127, r = x − m·ln2 in two parts,
# 1 + r + r²·P(r), times 2^m built from the exponent bits; denormal
# results flushed to zero
_EXP_P = (0.00019875691, 0.0013981999, 0.008333452, 0.041665796,
          0.16666666, 0.5)


def log(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` for v > 0: the Cephes logf polynomial
    on the mantissa in [sqrt(1/2), sqrt(2)), operation by operation."""
    bits = torch.clamp_min(v, _c(1.1754944e-38)).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    ef = ((bits >> 23) - 127).float() + 1.0
    low = m < _c(0.70710677)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    ef = ef - low.float()
    z = t * t
    x3 = z * t
    p = [fma(fma(t, _c(a), _c(b)), t, _c(c)) for a, b, c in _LOGF_A]
    q = fma(fma(p[0], x3, p[1]), x3, p[2])
    y = fma(q, x3, ef * _c(-0.00021219444))
    return fma(ef, 0.693359375, (t - z * 0.5) + y)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p`` for x > -1, operation by operation."""
    x2 = x * x
    num = torch.full_like(x, _c(_LOG1P_P[0]))
    den = torch.ones_like(x)
    for a, b in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
        num = fma(num, x, _c(a))
        den = fma(den, x, _c(b))
    small = x + fma(x2, -0.5, (x * x2) * div(num, den))
    return torch.where(torch.abs(x) < _c(0.41421357), small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles), every multiply-add fused."""
    w = -log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    lt_c = torch.tensor(_ERFINV_LT, dtype=torch.float32, device=x.device)
    ge_c = torch.tensor(_ERFINV_GE, dtype=torch.float32, device=x.device)
    coef = torch.where(lt[..., None], lt_c, ge_c)
    p = coef[..., 0]
    for i in range(1, len(_ERFINV_LT)):
        p = fma(p, w, coef[..., i].double())
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``exp``, operation by operation."""
    x = torch.clamp(x, _c(-87.8), _c(88.8))
    m = torch.floor(fma(x, _c(1.442695), 0.5)).clamp(-127.0, 127.0)
    r = fma(m, -0.693359375, x)
    r = fma(m, _c(2.1219444e-4), r)
    y = fma(r, _c(_EXP_P[0]), _c(_EXP_P[1]))
    for c in _EXP_P[2:]:
        y = fma(y, r, _c(c))
    y = 1.0 + fma(y, r * r, r)
    out = y * ((m.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out < _c(1.1754944e-38), 0.0, out)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(x, axis=1)`` of a [rows, K] float32 tensor as
    XLA's CPU backend computes it: ``exp(x − max)`` over the class sum
    taken left to right."""
    e = exp(x - x.max(dim=1, keepdim=True).values)
    s = e[:, 0]
    for k in range(1, e.shape[1]):
        s = s + e[:, k]
    return e / s[:, None]


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum(x, axis=dim)`` of float32 values as XLA's CPU
    backend computes it: its reduce-window rewrite cuts the axis into
    blocks of 16 (zero-padded), scans each block left to right, scans
    the block totals the same way (recursively) and adds each block's
    exclusive prefix. The blocks are scanned in place, one vectorized
    add per position."""
    dim %= x.dim()
    n = x.shape[dim]
    if n <= 16:
        y = x.clone()
        for k in range(1, n):
            y.select(dim, k).add_(y.select(dim, k - 1))
        return y
    nb = -(-n // 16)
    shape = list(x.shape)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, nb * 16 - n]
    blocks = torch.nn.functional.pad(x, pad).reshape(
        shape[:dim] + [nb, 16] + shape[dim + 1:])
    for k in range(1, 16):
        blocks.select(dim + 1, k).add_(blocks.select(dim + 1, k - 1))
    tot = cumsum(blocks.select(dim + 1, 15), dim)        # [..., nb, ...]
    blocks.narrow(dim, 1, nb - 1).add_(
        tot.narrow(dim, 0, nb - 1).unsqueeze(dim + 1))
    return blocks.reshape(shape[:dim] + [nb * 16] + shape[dim + 1:]) \
        .narrow(dim, 0, n)


def cpu_log(v: torch.Tensor) -> torch.Tensor:
    """``log`` on the CPU, ``torch.log`` on the card."""
    return log(v) if v.device.type == "cpu" else torch.log(v)


def cpu_softmax(x: torch.Tensor) -> torch.Tensor:
    """``softmax`` on the CPU, ``torch.softmax(x, 1)`` on the card."""
    return softmax(x) if x.device.type == "cpu" else torch.softmax(x, 1)


def cpu_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``cumsum`` on the CPU, ``torch.cumsum`` on the card."""
    return cumsum(x, dim) if x.device.type == "cpu" \
        else torch.cumsum(x, dim)
