"""PyTorch port, binning: the same seeded frame is binned by both
packages, and the quantile edges and uint8 bin codes must be equal
BITWISE (the port stores the codes feature-major, [F, rows]).

The frame has NaNs, a tied (rounded) column, an all-NA column, an enum
with an NA and an enum with more than 255 levels (range-grouped into
numeric bins). Past 65,536 rows both packages fit the quantiles on the
same threefry row sample, so parity holds there too (70,000 rows, a
multiple of the 8-shard mesh, so the JAX frame has no padding rows).
"""

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models.tree import binning as jbin
from h2o_kubernetes_tpu_torch import Frame
from h2o_kubernetes_tpu_torch.models.tree import binning as tbin

ROWS = 6000


def _cols(n=ROWS, seed=11):
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
            for i in range(3)}
    cols["x0"][rng.random(n) < 0.07] = np.nan
    cols["tied"] = np.round(rng.exponential(3.0, size=n)).astype(np.float32)
    cols["all_na"] = np.full(n, np.nan, dtype=np.float32)
    c = np.array(["a", "b", "c", "d", ""])[rng.integers(0, 5, n)]
    cols["c"] = c                                      # "" = NA
    cols["wide"] = np.array([f"L{i:03d}" for i in range(300)])[
        rng.integers(0, 300, n)]
    return cols


@pytest.fixture(scope="module")
def frames(mesh8):
    cols = _cols()
    return (h2o.Frame.from_arrays(cols),
            Frame.from_arrays(cols, device="cpu"), list(cols))


@pytest.mark.parametrize("n_bins", [256, 20])
def test_edges_and_codes_bitwise(frames, n_bins):
    jf, tf, names = frames
    js, jb = jbin.fused_fit_bins(jf, names, n_bins)
    ts, tb = tbin.fused_fit_bins(tf, names, n_bins)
    assert ts.is_enum == js.is_enum == [False] * 5 + [True, False]
    want = np.asarray(js.edges_matrix())
    got = ts.edges.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tb.dtype == torch.uint8 and tb.shape == (len(names), ROWS)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb)[:ROWS].T)
    # the NA bin is the last one; the 300-level enum is range-grouped
    assert tb[names.index("all_na")].eq(n_bins - 1).all()
    assert int(tb[names.index("wide")].max()) <= n_bins - 2


def test_sampled_edges_and_codes_bitwise_past_the_sample(mesh8):
    """70,000 rows: the quantile sample is randint(key(0x51BB), (65536,),
    0, 70000) in both packages, so edges and codes stay bitwise."""
    cols = _cols(n=70_000, seed=12)
    names = list(cols)
    js, jb = jbin.fused_fit_bins(h2o.Frame.from_arrays(cols), names, 256)
    ts, tb = tbin.fused_fit_bins(Frame.from_arrays(cols, device="cpu"),
                                 names, 256)
    want = np.asarray(js.edges_matrix())
    np.testing.assert_array_equal(ts.edges.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb)[:70_000].T)


def test_fit_then_bin_frame_equals_fused(frames):
    jf, tf, names = frames
    spec = tbin.fit_bins(tf, names, 64)
    _, fused = tbin.fused_fit_bins(tf, names, 64)
    assert torch.equal(tbin.bin_frame(tf, spec), fused)
    assert torch.equal(tf.binned(spec), fused)
    jspec = jbin.fit_bins(jf, names, 64)
    np.testing.assert_array_equal(spec.edges.numpy(),
                                  np.asarray(jspec.edges_matrix()))


def test_apply_bins_matches_reference_per_column(frames):
    """apply_bins on one column equals the JAX package's apply_bins on
    a matrix, for numeric, enum (with negative codes) and NaN rows."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    edges = np.sort(rng.normal(size=(2, 14)).astype(np.float32), axis=1)
    edges[1, 9:] = np.inf
    X = rng.normal(size=(500, 2)).astype(np.float32)
    X[::7, 0] = np.nan
    X[:, 1] = rng.integers(-1, 20, 500).astype(np.float32)
    X[::11, 1] = np.nan
    mask = np.array([False, True])
    want = np.asarray(jbin.apply_bins(jnp.asarray(X), jnp.asarray(edges),
                                      jnp.asarray(mask), 15))
    for j in range(2):
        got = tbin.apply_bins(torch.as_tensor(X[:, j]),
                              torch.as_tensor(edges[j]), bool(mask[j]), 15)
        np.testing.assert_array_equal(got.numpy(), want[:, j])


def test_fused_cache_follows_the_content_version():
    cols = _cols(n=800, seed=3)
    tf = Frame.from_arrays(cols, device="cpu")
    names = ["x1", "x2", "c"]
    first = tbin.fused_fit_bins(tf, names, 32)
    assert tbin.fused_fit_bins(tf, names, 32) is first
    tf["x1"] = tf["x2"]
    again = tbin.fused_fit_bins(tf, names, 32)
    assert again is not first
    assert torch.equal(again[1][0], again[1][1])


def test_sampled_edges_are_seeded_and_bounded():
    """Past 65,536 rows the quantiles come from a seeded 65,536-row
    sample: the same frame gives the same edges twice, and every edge is
    a value between the column's min and max."""
    rng = np.random.default_rng(8)
    x = rng.exponential(2.0, size=70_001).astype(np.float32)
    tf = Frame.from_arrays({"x": x}, device="cpu")
    a = tbin.fit_bins(tf, ["x"], 256).edges
    b = tbin.fit_bins(Frame.from_arrays({"x": x}, device="cpu"),
                      ["x"], 256).edges
    assert torch.equal(a, b)
    q = a[0, :253]                     # the last column is +inf padding
    assert float(q.min()) >= float(x.min())
    assert float(q.max()) <= float(x.max())
    assert torch.isinf(a[0, 253:]).all()


def test_vec_rollups_match_reference(frames):
    """min/max/mean/sigma/nacnt/zeros/rows per column, numeric and enum;
    counts and extremes exact, mean and sigma to f32 summation order."""
    jf, tf, names = frames
    for name in names:
        want, got = jf.vec(name).rollups(), tf.vec(name).rollups()
        assert set(got) == set(want), name
        for k in ("nacnt", "zeros", "rows", "min", "max"):
            np.testing.assert_equal(got[k], want[k], err_msg=f"{name} {k}")
        for k in ("mean", "sigma"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{name} {k}")


def test_rejects_bad_n_bins(frames):
    _, tf, names = frames
    for nb in (3, 257):
        with pytest.raises(ValueError, match="n_bins"):
            tbin.fit_bins(tf, names, nb)
