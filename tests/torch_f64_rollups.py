"""Like-for-like column statistics for the port's parity tests.

The port's ``Vec.rollups`` forms the count, the mean and Σ(x − mean)²
as float64 sums in two passes; the JAX package's forms them from one
float32 pass (σ² = Σx²/n − mean²). Tests that hold a standardizing
learner (``DataInfo``) to the reference give the reference the same
statistics: ``f64_rollups`` patches the JAX ``Vec``'s rollups to the
numpy float64 two-pass value of ``two_pass`` for as long as the context
lasts. No file of the JAX package changes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest


def two_pass(x) -> tuple[int, float, float]:
    """(count, mean, sigma) of a float32 column's non-NaN values: numpy
    float64 sums, the mean first, then Σ(x − mean)² (sigma with n − 1)."""
    x = np.asarray(x, dtype=np.float32)
    v = x[~np.isnan(x)].astype(np.float64)
    n = v.size
    if n == 0:
        return 0, float("nan"), 0.0
    mean = v.sum() / n
    sigma = float(np.sqrt(((v - mean) ** 2).sum() / (n - 1))) if n > 1 \
        else 0.0
    return n, float(mean), sigma


def _values(vec) -> np.ndarray:
    """The float32 values a JAX Vec's rollups reduce (time columns
    origin-relative, enum codes with NA as NaN)."""
    if vec.kind == "time":
        x = vec.data
    elif vec.kind == "enum":
        x = vec.as_float()
    else:
        x = vec.data
    return np.asarray(x, dtype=np.float32)[: vec.nrows]


@contextlib.contextmanager
def f64_rollups():
    """Patch ``h2o_kubernetes_tpu.frame.frame.Vec._compute_rollups`` so
    mean and sigma are ``two_pass``'s (min, max and the counts stay the
    reference's)."""
    from h2o_kubernetes_tpu.frame import frame as jframe

    original = jframe.Vec._compute_rollups

    def patched(self):
        r = original(self)
        if self.nrows == 0 or r["rows"] == 0:
            return r
        _, mean, sigma = two_pass(_values(self))
        shift = self.origin if self.kind == "time" else 0.0
        return dict(r, mean=mean + shift, sigma=sigma)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jframe.Vec, "_compute_rollups", patched)
        yield
