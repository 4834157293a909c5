"""PyTorch port, model metrics against the JAX package on the same
seeded inputs, within 1e-6: ``roc_auc`` on its exact path (a sort) and
its histogram path (4096 score bins through ``build_histogram``, the
CUDA kernel on a card), weighted and not, ``logloss`` and ``rmse``. A
NaN on a live row makes either package's metric NaN."""

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu import metrics as jm
from h2o_kubernetes_tpu_torch import metrics as tm

TOL = 1e-6


def _case(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.35).astype(np.float32)
    s = (rng.normal(size=n) + 1.2 * y).astype(np.float32)
    if ties:
        s = np.round(s, 1)
    p = (1.0 / (1.0 + np.exp(-s))).astype(np.float32)
    w = rng.uniform(0.2, 3.0, n).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0
    return y, s, p, w


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "hist"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_roc_auc(exact, weighted, ties):
    y, s, _, w = _case(20_000, seed=3, ties=ties)
    w = w if weighted else None
    want = jm.roc_auc(y, s, w=w, exact=exact)
    got = tm.roc_auc(y, torch.as_tensor(s), w=w, exact=exact)
    assert abs(got - want) <= TOL, (got, want)


def test_roc_auc_path_by_size_and_nan():
    y, s, _, w = _case(70_000, seed=5)
    # past 65,536 rows both packages take the histogram path
    assert abs(tm.roc_auc(y, s) - jm.roc_auc(y, s)) <= TOL
    assert abs(tm.roc_auc(y, s) - tm.roc_auc(y, s, exact=False)) == 0
    s2 = s.copy()
    s2[10] = np.nan
    assert np.isnan(tm.roc_auc(y, s2)) and np.isnan(jm.roc_auc(y, s2))
    w[10] = 0.0                         # NaN on a dead row is ignored
    assert abs(tm.roc_auc(y, s2, w=w) - jm.roc_auc(y, s2, w=w)) <= TOL


@pytest.mark.parametrize("weighted", [False, True])
def test_logloss_and_rmse(weighted):
    y, _, p, w = _case(5000, seed=7)
    w = w if weighted else None
    for name in ("logloss", "rmse"):
        want = getattr(jm, name)(y, p, w=w)
        got = getattr(tm, name)(y, torch.as_tensor(p), w=w)
        assert abs(got - want) <= TOL * max(1.0, abs(want)), name
