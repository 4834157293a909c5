"""PyTorch port, the batched histogram (kernel B3's plain version)
against the JAX package's ``_hist_vmappable`` under ``jax.vmap``:

- the K-class case: rel and vals batched, one binned matrix
  (``histogram_batched_plain``);
- the forest case: the row weight batched per tree, rel shared
  (``build_histogram`` with w [K, rows]).

C=2 and C=3; one shape's [K·n, B, C] f32 histogram exceeds the 227 KB of
one block's shared memory (the kernel cuts it into node ranges). The JAX
reference runs with impl "segment" at every shape and with the
interpret-mode Pallas kernel (its own class-flattening vmap rule) at one
small shape.
Tolerance: per cell, |port - reference| <= 1e-6 · Σ|v| over the cell's
rows (f32 sums in another order); on dyadic values, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu.ops import histogram as jhist
from h2o_kubernetes_tpu_torch.ops import histogram as thist

REL_TOL = 1e-6

# (K, rows, F, n_nodes, n_bins): a 4-class depth-3 level; a 10-tree
# level of 64 left children x 64 bins (DRF depth 7), whose K·n·B·C·4 is
# 327,680 B at C=2
_SHAPES = {"K4-n4": (4, 900, 3, 4, 32), "K10-n64": (10, 600, 2, 64, 64)}
_CASES = [pytest.param(impl, C, *_SHAPES[shape], id=f"{shape}-C{C}-{impl}")
          for impl, shapes in (("segment", list(_SHAPES)),
                               ("pallas", ["K4-n4"]))
          for shape in shapes for C in ((2, 3) if impl == "segment"
                                        else (3,))]


def _case(K, rows, F, n_nodes, n_bins, C, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, size=(rows, F)).astype(np.uint8)
    rel = rng.integers(0, n_nodes, size=(K, rows)).astype(np.int32)
    rel[rng.random((K, rows)) < 0.25] = -1
    if dyadic:
        vals = (rng.integers(-2, 3, size=(K, rows, C)) * 0.5).astype(
            np.float32)
    else:
        vals = rng.normal(size=(K, rows, C)).astype(np.float32)
    vals[rel < 0] = 0.0
    return binned, rel, vals


def _scale(binned, rel, vals, n_nodes, n_bins):
    K, rows, C = vals.shape
    out = np.zeros((K, n_nodes, binned.shape[1], n_bins, C))
    for k in range(K):
        live = rel[k] >= 0
        for f in range(binned.shape[1]):
            np.add.at(out[k, :, f], (rel[k, live],
                                     binned[live, f].astype(np.int64)),
                      np.abs(vals[k, live]).astype(np.float64))
    return out


def _check(got, want, scale):
    assert got.shape == want.shape == scale.shape
    empty = scale == 0
    assert (got[empty] == 0).all() and (want[empty] == 0).all()
    err = np.abs(got.astype(np.float64) - want) / np.where(empty, 1, scale)
    assert err.max() <= REL_TOL, err.max()


def _ref_classes(binned, rel, vals, n, B, impl):
    fn = jax.vmap(lambda r, v: jhist._hist_vmappable(
        jnp.asarray(binned), r, v, n, B, impl))
    return np.asarray(fn(jnp.asarray(rel), jnp.asarray(vals)))


def _port_classes(binned, rel, vals, n, B):
    return thist.build_histogram_batched(
        torch.as_tensor(np.ascontiguousarray(binned.T)),
        torch.as_tensor(rel), torch.as_tensor(vals), n, B).numpy()


@pytest.mark.parametrize("impl,C,K,rows,F,n_nodes,n_bins", _CASES)
def test_class_batch_matches_reference(impl, C, K, rows, F, n_nodes,
                                       n_bins):
    binned, rel, vals = _case(K, rows, F, n_nodes, n_bins, C, seed=K + C)
    got = _port_classes(binned, rel, vals, n_nodes, n_bins)
    _check(got, _ref_classes(binned, rel, vals, n_nodes, n_bins, impl),
           _scale(binned, rel, vals, n_nodes, n_bins))
    if K == 10:
        assert K * n_nodes * n_bins * C * 4 > thist.BLOCK_SMEM
        assert thist.hist_plan(K, n_nodes, F, n_bins, C, rows).ranges > 1


@pytest.mark.parametrize("shape", list(_SHAPES))
def test_class_batch_bitwise_on_dyadic_values(shape):
    K, rows, F, n, B = _SHAPES[shape]
    binned, rel, vals = _case(K, rows, F, n, B, 3, seed=5, dyadic=True)
    np.testing.assert_array_equal(
        _port_classes(binned, rel, vals, n, B),
        _ref_classes(binned, rel, vals, n, B, "segment"))


@pytest.mark.parametrize("unit_hess", [True, False], ids=["C2", "C3"])
@pytest.mark.parametrize("dyadic", [False, True], ids=["float", "dyadic"])
def test_forest_batch_matches_reference(unit_hess, dyadic):
    """One rel for every tree, a per-tree bootstrap weight (0/1, as DRF's
    row sample gives): vmap of the JAX build_histogram over w."""
    K, rows, F, n, B = _SHAPES["K10-n64"]
    rng = np.random.default_rng(3)
    binned = rng.integers(0, B, size=(rows, F)).astype(np.uint8)
    rel = rng.integers(-1, n, size=rows).astype(np.int32)
    g = rng.normal(size=rows).astype(np.float32)
    if dyadic:
        g = (np.round(g * 2) / 2).astype(np.float32)
    h = np.ones(rows, np.float32) if unit_hess else \
        (rng.integers(1, 4, rows) / 4).astype(np.float32)
    w = (rng.random((K, rows)) < 0.632).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda wk: jhist.build_histogram(
            jnp.asarray(binned), jnp.asarray(rel), jnp.asarray(g),
            jnp.asarray(h), wk, n, B, impl="segment",
            unit_hess=unit_hess))(jnp.asarray(w)))
    got = thist.build_histogram(
        torch.as_tensor(np.ascontiguousarray(binned.T)),
        torch.as_tensor(rel), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(w), n, B, unit_hess=unit_hess).numpy()
    if dyadic:
        np.testing.assert_array_equal(got, want)
        return
    live = (rel >= 0)[None] & (w > 0)
    chans = [g * w, w] if unit_hess else [g * w, h * w, w]
    v = np.where(live[..., None], np.stack(chans, -1), 0.0)
    _check(got, want, _scale(binned, np.where(live, rel, -1), v, n, B))


def test_k1_is_the_single_tree_histogram():
    """K=1 of the batched build is histogram_plain bitwise, and on the
    CPU the wrapper launches nothing."""
    binned, rel, vals = _case(1, 700, 3, 8, 32, 3, seed=9)
    codes = torch.as_tensor(np.ascontiguousarray(binned.T))
    before = (dict(thist.LAUNCHES), dict(thist.BATCHED_LAUNCHES))
    got = thist.build_histogram_batched(codes, torch.as_tensor(rel),
                                        torch.as_tensor(vals), 8, 32)
    assert (thist.LAUNCHES, thist.BATCHED_LAUNCHES) == before
    assert torch.equal(got[0], thist.histogram_plain(
        codes, torch.as_tensor(rel[0]), torch.as_tensor(vals[0]), 8, 32))
    assert torch.equal(got[0], thist.build_histogram_kernel(
        codes, torch.as_tensor(rel[0]), torch.as_tensor(vals[0]), 8, 32))
