"""PyTorch port, ``flat_margin``: bitwise equal to the JAX package's
on the same flat arrays (NaN features, negative enum codes), for
single-class (binomial/regression) and multinomial interleaved
ensembles. Both sum the per-round f32 leaf values in round order."""

import io

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.mojo import read_mojo_parts
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)

_PARTS = ("split_feat", "thresh", "left", "na_left", "value")
_ENUMS = (1, 4)


@pytest.mark.parametrize("nclasses,rounds,depth", [
    (2, 20, 5),        # binomial: one tree per round
    (1, 7, 3),         # regression
    (3, 6, 4),         # multinomial: K=3 interleaved class trees
    (1, 300, 2),       # more rounds than one descent block
], ids=["binomial", "regression", "multinomial", "many_rounds"])
def test_flat_margin_bitwise(nclasses, rounds, depth):
    dist = {1: "gaussian", 2: "bernoulli"}.get(nclasses, "multinomial")
    blob = random_tree_artifact(11, n_features=6, ntrees=rounds,
                                max_depth=depth, nclasses=nclasses,
                                distribution=dist, enum_features=_ENUMS)
    _, a, _ = read_mojo_parts(io.BytesIO(blob))
    X = random_rows(12, 333, 6, nan_frac=0.05, enum_features=_ENUMS)
    em = a["enum_mask"].astype(bool)
    assert (X[:, list(_ENUMS)] < 0).any() and np.isnan(X).any()
    K = nclasses if nclasses > 2 else 1
    want = np.asarray(jcore.flat_margin(
        jcore.FlatTrees(*(a[f"flat_{p}"] for p in _PARTS)), X, em,
        depth, K))
    got = tcore.flat_margin(
        tcore.FlatTrees(*(torch.as_tensor(a[f"flat_{p}"]) for p in _PARTS)),
        torch.as_tensor(X), torch.as_tensor(em), depth, K)
    assert got.shape == (K, X.shape[0]) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
