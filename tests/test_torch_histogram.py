"""PyTorch port, the histogram build: the plain version (what a CPU
tensor takes) against the JAX package's ``build_histogram`` with
``impl="segment"`` and ``impl="pallas"`` (interpret mode on the CPU, as
tests/test_histogram.py runs it), on the same seeded inputs.

Tolerance: per cell, |port - reference| <= 1e-6 · Σ|v| over the cell's
rows (f32 sums in another order; the Pallas kernel's 3-term bf16 split
adds ~2^-24 per product). Cells no live row reaches are 0 in both.
Dead rows carry NaN gradients and must not poison the sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_kubernetes_tpu.ops import histogram as jhist
from h2o_kubernetes_tpu_torch.ops import histogram as thist

REL_TOL = 1e-6


def _case(r, F, n_nodes, n_bins, seed, dead_frac=0.2):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, size=(r, F)).astype(
        np.uint8 if n_bins <= 256 else np.int32)
    rel = rng.integers(0, n_nodes, size=r).astype(np.int32)
    rel[rng.random(r) < dead_frac] = -1
    g = rng.normal(size=r).astype(np.float32)
    h = rng.random(r).astype(np.float32)
    w = (rng.random(r) < 0.9).astype(np.float32) * rng.uniform(
        0.5, 2.0, r).astype(np.float32)
    g[rel < 0] = np.nan                 # dead rows: NaN gradients
    h[w == 0] = np.nan                  # zero-weight rows too
    return binned, rel, g, h, w


def _scale(binned, rel, g, h, w, n_nodes, n_bins, unit_hess):
    """float64 Σ|v| per cell over live rows: the tolerance's scale."""
    live = (rel >= 0) & (w > 0)
    chans = [g * w, w] if unit_hess else [g * w, h * w, w]
    v = np.abs(np.stack([np.where(live, c, 0.0) for c in chans], 1)
               ).astype(np.float64)
    F = binned.shape[1]
    out = np.zeros((n_nodes, F, n_bins, len(chans)))
    for f in range(F):
        np.add.at(out[:, f], (rel[live], binned[live, f].astype(np.int64)),
                  v[live])
    return out


def _port(binned, rel, g, h, w, n_nodes, n_bins, unit_hess, code_dtype):
    return thist.build_histogram(
        torch.as_tensor(np.ascontiguousarray(binned.T).astype(code_dtype)),
        torch.as_tensor(rel), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(w), n_nodes, n_bins, unit_hess=unit_hess).numpy()


def _check(got, want, scale):
    assert got.shape == want.shape == scale.shape
    assert np.isfinite(got).all()
    empty = scale == 0
    assert (got[empty] == 0).all() and (want[empty] == 0).all()
    err = np.abs(got.astype(np.float64) - want) / np.where(empty, 1, scale)
    assert err.max() <= REL_TOL, err.max()


# the segment reference at both shapes; the interpret-mode Pallas kernel,
# whose every shape is a slow compile on the CPU, at the depth-4 level
_SHAPES = {"1000-3-4-64": (1000, 3, 4, 64),
           "513-2-8-256": (513, 2, 8, 256)}  # depth-4 level, odd row count
_REFERENCE_CASES = [
    pytest.param(impl, unit_hess, *_SHAPES[shape],
                 id=f"{shape}-{'C2' if unit_hess else 'C3'}-{impl}")
    for impl, shapes in (("segment", list(_SHAPES)),
                         ("pallas", ["513-2-8-256"]))
    for unit_hess in (False, True) for shape in shapes]


@pytest.mark.parametrize("impl,unit_hess,r,F,n_nodes,n_bins",
                         _REFERENCE_CASES)
def test_plain_matches_reference(impl, unit_hess, r, F, n_nodes, n_bins):
    binned, rel, g, h, w = _case(r, F, n_nodes, n_bins, seed=r + n_bins)
    want = np.asarray(jhist.build_histogram(
        jnp.asarray(binned), jnp.asarray(rel), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(w), n_nodes, n_bins, impl=impl,
        unit_hess=unit_hess))
    got = _port(binned, rel, g, h, w, n_nodes, n_bins, unit_hess,
                np.uint8)
    _check(got, want, _scale(binned, rel, g, h, w, n_nodes, n_bins,
                             unit_hess))


def test_auc_shape_int16_codes_match_segment():
    """The AUC's score histogram: one node, 4096 bins, int16 codes."""
    binned, rel, g, h, w = _case(5000, 1, 1, 4096, seed=3, dead_frac=0.1)
    want = np.asarray(jhist.build_histogram(
        jnp.asarray(binned), jnp.asarray(rel), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(w), 1, 4096, impl="segment"))
    got = _port(binned, rel, g, h, w, 1, 4096, False, np.int16)
    _check(got, want, _scale(binned, rel, g, h, w, 1, 4096, False))


def test_expand_unit_hess_matches_reference():
    rng = np.random.default_rng(0)
    h2 = rng.normal(size=(2, 3, 5, 2)).astype(np.float32)
    want = np.asarray(jhist.expand_unit_hess(jnp.asarray(h2)))
    got = thist.expand_unit_hess(torch.as_tensor(h2)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper IS the plain version and launches
    nothing; the launch plan streams a root in feature groups (with
    spare copies where shared memory allows) and partitions the rows of
    the 128- and 256-node levels of 256 bins by node."""
    binned, rel, g, h, w = _case(700, 3, 4, 32, seed=5)
    codes = torch.as_tensor(np.ascontiguousarray(binned.T))
    vals = torch.as_tensor(np.stack([np.nan_to_num(g), np.nan_to_num(h),
                                     w], 1).astype(np.float32))
    rel_t = torch.as_tensor(rel)
    before = dict(thist.LAUNCHES)
    got = thist.build_histogram_kernel(codes, rel_t, vals, 4, 32)
    assert thist.LAUNCHES == before
    assert torch.equal(got, thist.histogram_plain(codes, rel_t, vals, 4, 32))
    assert thist.hist_mode(1, 1, 10, 256, 3) == "replicated"
    assert thist.hist_mode(1, 1, 1, 4096, 3, code_bytes=2) == "grouped"
    assert thist.hist_mode(1, 128, 10, 256, 3) == "partitioned"
    assert thist.hist_mode(1, 256, 10, 256, 2) == "partitioned"


@pytest.mark.parametrize("batched", [False, True])
def test_plain_sums_in_float64_and_rounds_once(batched):
    """A hot bin (most rows in one bin, as CancellationCode's NA bin
    holds 98.5% of the airlines rows): every cell equals its float64
    sum rounded to float32 once, where a float32 running sum drifts by
    many ulps; the dead rows' junk node stays out."""
    rng = np.random.default_rng(6)
    rows, n_bins = 200_000, 16
    codes = np.where(rng.random(rows) < 0.985, n_bins - 1,
                     rng.integers(0, n_bins - 1, rows)).astype(np.uint8)
    rel = rng.integers(-1, 2, rows).astype(np.int32)
    vals = rng.normal(size=(rows, 3)).astype(np.float32)
    vals[:, 2] = 1.0 + rng.random(rows).astype(np.float32)
    want = np.zeros((2, n_bins, 3))
    live = rel >= 0
    np.add.at(want, (rel[live], codes[live].astype(np.int64)),
              vals[live].astype(np.float64))
    want = want.astype(np.float32)[:, None]
    ct, rt, vt = (torch.as_tensor(a) for a in (codes[None], rel, vals))
    got = thist.histogram_batched_plain(ct, rt[None], vt[None], 2,
                                        n_bins)[0] if batched else \
        thist.histogram_plain(ct, rt, vt, 2, n_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = torch.zeros((3 * n_bins, 3)).index_add_(
        0, (torch.where(rt >= 0, rt, 2) * n_bins + ct[0].long()).long(),
        vt)[: 2 * n_bins].reshape(2, 1, n_bins, 3).numpy()
    assert (f32 != want).any()      # the float32 running sum drifts here
