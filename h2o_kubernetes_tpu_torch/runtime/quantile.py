"""``jnp.nanquantile``'s linear interpolation, as XLA compiles it.

Three places of the JAX package take a NaN-skipping linear quantile
through ``jnp.nanquantile`` under jit: huber's per-round δ, the quantile
bin edges and ``Frame.quantile``. XLA computes each the same way — a
stable sort (NaN last), the live count in float32, the position ``q ·
(count − 1)``, floor/ceil, weights ``hw = pos − floor`` and ``lw = 1 −
hw`` in float32 — and then contracts ``lo·lw + hi·hw`` into one fused
multiply-add. Which product it fuses depends on the program around it,
read from each program's object code: huber's δ and ``Frame.quantile``
compile to ``fma(hi, hw, lo·lw)``, the binning program to ``fma(lo, lw,
hi·hw)``. The fused step goes through ``xla_math.fma``, which rounds once.
"""

from __future__ import annotations

import torch

from .xla_math import fma

__all__ = ["nanquantile", "lerp"]


def lerp(lo, hi, lw, hw, fused: str) -> torch.Tensor:
    """float32 ``lo·lw + hi·hw`` as XLA contracts it: ``fused="hi"`` is
    ``fma(hi, hw, lo·lw)``, ``"lo"`` is ``fma(lo, lw, hi·hw)``; the
    unfused product rounds to float32 first, the fused step once."""
    if fused == "hi":
        return fma(hi, hw, lo * lw)
    if fused == "lo":
        return fma(lo, lw, hi * hw)
    raise ValueError(f"fused must be 'hi' or 'lo', got {fused!r}")


def nanquantile(x: torch.Tensor, q: torch.Tensor, fused: str
                ) -> torch.Tensor:
    """float32 ``x`` [..., n], float32 probabilities ``q`` [Q] ->
    [..., Q], NaN where a row has no live value. ``fused`` names the
    product XLA keeps inside the multiply-add: ``"hi"`` for ``fma(hi,
    hw, lo·lw)``, ``"lo"`` for ``fma(lo, lw, hi·hw)``."""
    if x.shape[-1] == 0:
        return torch.full(x.shape[:-1] + q.shape, float("nan"),
                          device=x.device)
    s = torch.sort(x, dim=-1, stable=True).values              # NaN last
    counts = (~torch.isnan(s)).sum(dim=-1, keepdim=True).to(torch.float32)
    pos = q.to(torch.float32) * (counts - 1.0)                 # [..., Q]
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    last = counts - 1.0
    low = torch.clamp(torch.minimum(low, last), min=0.0).long()
    high = torch.clamp(torch.minimum(high, last), min=0.0).long()
    return lerp(s.gather(-1, low), s.gather(-1, high), lw, hw, fused)
