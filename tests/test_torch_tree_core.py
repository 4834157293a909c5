"""PyTorch port, the tree core: split finding and tree growing against
the JAX package, BITWISE, on dyadic inputs.

The JAX package sums each level's histograms over 8 row shards
(``lax.psum`` on the 8-device CPU mesh); the port sums on one device in
another order. With ±0.5 gradients, dyadic hessians and unit weights
every partial sum is exact in any order, so every histogram — and so
every gain, split, NA direction, tie-break, leaf value and cover — must
be equal to the last bit. The flattening (numpy, copied) is checked
bitwise on the grown trees.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu_torch.models.tree import core as tcore

ROWS = 4096
N_BINS = 16


def _dyadic_hist(seed, n_nodes=4, F=4):
    """[n, F, B, 3] histogram of dyadic rows (exact sums): feature 3
    duplicates feature 0 (the tie-break), node 3 is empty, and node 2's
    rows are mostly NA on feature 1 with a gradient tied to it."""
    binned, g, h, w = _dyadic_rows(seed, F=F, rows=600)
    rng = np.random.default_rng(seed + 100)
    rel = rng.integers(0, n_nodes - 1, size=binned.shape[0])
    na2 = (rel == 2) & (rng.random(binned.shape[0]) < 0.7)
    binned[na2, 1] = N_BINS - 1
    g[na2] = 0.5
    hist = np.zeros((n_nodes, F, N_BINS, 3), dtype=np.float64)
    vals = np.stack([g * w, h * w, w], axis=1).astype(np.float64)
    for f in range(F):
        np.add.at(hist[:, f], (rel, binned[:, f].astype(np.int64)), vals)
    return hist.astype(np.float32)


_PARAMS = [jcore.TreeParams(max_depth=4, n_bins=N_BINS, min_rows=2.0),
           jcore.TreeParams(max_depth=4, n_bins=N_BINS, min_rows=2.0,
                            reg_lambda=1.0, reg_alpha=0.5,
                            min_child_weight=0.5, gamma=0.25)]


def _tp(p):
    return tcore.TreeParams(
        max_depth=p.max_depth, n_bins=p.n_bins, min_rows=p.min_rows,
        reg_lambda=p.reg_lambda, reg_alpha=p.reg_alpha, gamma=p.gamma,
        min_child_weight=p.min_child_weight, unit_hess=p.unit_hess)


@pytest.mark.parametrize("pi", range(len(_PARAMS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_find_splits_bitwise(pi, seed):
    p = _PARAMS[pi]
    hist = _dyadic_hist(seed)
    want = jcore._find_splits(jnp.asarray(hist), p)
    got = tcore._find_splits(torch.as_tensor(hist), _tp(p))
    for name, w, g in zip(("feat", "bin", "na_left", "can_split", "value",
                           "gain", "cover", "left", "right"), want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _dyadic_rows(seed, F=4, na_frac=0.15, rows=ROWS):
    """Bin codes with an informative NA bin and a duplicate column, and
    ±0.5 gradients, hessian 0.25, unit weights."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, N_BINS - 1, size=(rows, F)).astype(np.uint8)
    na = rng.random(rows) < na_frac
    binned[na, 1] = N_BINS - 1
    binned[:, 3] = binned[:, 0]
    # an NA on feature 1 acts like its high bins where feature 2 is
    # high and like its low bins elsewhere: both NA directions pay
    hi1 = np.where(na, binned[:, 2] >= 7, binned[:, 1] > 9)
    signal = (binned[:, 0] > 6) ^ hi1
    flip = rng.random(rows) < 0.1
    g = np.where(signal ^ flip, 0.5, -0.5).astype(np.float32)
    h = np.full(rows, 0.25, dtype=np.float32)
    w = np.ones(rows, dtype=np.float32)
    return binned, g, h, w


@pytest.fixture(scope="module")
def grown(mesh8):
    """(JAX tree, port tree, port leaf rows, binned) per case."""
    out = {}
    for name, depth, unit in (("depth4", 4, False), ("unit_hess", 3, True),
                              ("stump", 0, False)):
        binned, g, h, w = _dyadic_rows(seed=depth)
        if unit:
            h = np.ones_like(h)
        p = jcore.TreeParams(max_depth=depth, n_bins=N_BINS, min_rows=5.0,
                             unit_hess=unit)
        jt = jcore.grow_tree(jnp.asarray(binned), jnp.asarray(g),
                             jnp.asarray(h), jnp.asarray(w), p)
        bt = torch.as_tensor(np.ascontiguousarray(binned.T))
        args = (bt, torch.as_tensor(g), torch.as_tensor(h),
                torch.as_tensor(w), _tp(p))
        tt = tcore.grow_tree(*args)
        out[name] = (jt, tt, tcore._grow_tree(*args)[1], bt, p)
    return out


@pytest.mark.parametrize("case", ["depth4", "unit_hess", "stump"])
def test_grow_tree_bitwise(grown, case):
    jt, tt, _, _, p = grown[case]
    isp = np.asarray(jt.is_split)
    assert bool(isp.any()) == (p.max_depth > 0)
    if p.max_depth:
        sf = np.asarray(jt.split_feat)
        # both NA directions are learned somewhere, and the duplicate
        # column 3 never wins its tie with column 0 (first max wins)
        assert (np.asarray(jt.na_left) & isp).any()
        assert (~np.asarray(jt.na_left) & isp).any()
        assert (sf == 0).any() and not (sf == 3).any()
    for f in jcore.Tree._fields:
        w = np.asarray(getattr(jt, f))
        g = getattr(tt, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("case", ["depth4", "unit_hess"])
def test_descend_and_predict_match(grown, case):
    jt, tt, leaf, bt, p = grown[case]
    node = tcore.descend_tree(tt, bt, p.max_depth, N_BINS)
    assert torch.equal(node, leaf)       # the grower's own leaf walk
    want = np.asarray(jcore.predict_tree(jt, jnp.asarray(bt.numpy().T),
                                         p.max_depth, N_BINS))
    got = tcore.predict_tree(tt, bt, p.max_depth, N_BINS).numpy()
    np.testing.assert_array_equal(got, want)


def test_flattening_bitwise(grown):
    """flatten_trees / flatten_cover on the stacked grown trees, with an
    enum feature and +inf edge padding, equal the JAX package's."""
    jts = [grown[c][0] for c in ("depth4",)] * 2
    stacked_j = jcore.Tree(*(np.stack([np.asarray(getattr(t, f))
                                       for t in jts])
                             for f in jcore.Tree._fields))
    tts = [grown[c][1] for c in ("depth4",)] * 2
    stacked_t = tcore.Tree(*(torch.stack([getattr(t, f) for t in tts])
                             for f in tcore.Tree._fields))
    rng = np.random.default_rng(0)
    edges = np.sort(rng.normal(size=(4, N_BINS - 2)), axis=1).astype(
        np.float32)
    edges[2, 9:] = np.inf
    enum = np.array([False, False, True, False])
    want = jcore.flatten_trees(stacked_j, edges, enum, 4)
    got = tcore.flatten_trees(stacked_t, edges, enum, 4)
    for name, w, g in zip(jcore.FlatTrees._fields, want, got):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(tcore.flatten_cover(stacked_t, 4),
                                  jcore.flatten_cover(stacked_j, 4))
