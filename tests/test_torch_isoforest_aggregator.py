"""PyTorch port, isolation forest and the aggregator
(``models/isolationforest.py``, ``models/aggregator.py``) against the
JAX package's on the CPU.

Isolation forest (3,000 rows, six columns with NaNs; 8 trees, sample
256 and depth 8; and a depth-5 forest on 150 rows, where the sample is
clamped to the valid rows): every tree's ``split_feat``,
``split_val`` (NaN positions equal), ``is_split`` and ``count``
BITWISE (the threefry twin's draws; the threshold
``fmin + u·(fmax − fmin)`` with XLA's fused multiply-add), the path
lengths and scores of the training rows within 1e-6; artifacts both
ways within 1e-6 (relative past 1: the numpy scorer sums path lengths
in float64 and rounds once).

Aggregator (2,000 rows, standardized through the port's column
statistics, ``tests/torch_f64_rollups.py``, given to the reference
too): the exemplar row ids and the member counts equal; the
aggregated frame's rows are the exemplars with a
``counts`` column, for two targets. The distances are float32 products
in both packages, so an admission could part them only on a row whose
nearest distance ties the radius within float32 rounding; none does
here.
"""

import io

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models import Aggregator as JAggregator
from h2o_kubernetes_tpu.models import IsolationForest as JIF
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import (Aggregator, Frame, IsolationForest,
                                      MojoModel, export_mojo)
from torch_f64_rollups import f64_rollups

_MESH1 = make_mesh(n_rows=1)
IF_CASES = {"default": (3000, dict(ntrees=8, seed=4)),
            "clamped": (150, dict(ntrees=3, max_depth=5, seed=1))}
AGG_TARGETS = (20, 60)


def cols_of(rows, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(5)}
    X["x0"][rng.uniform(size=rows) < 0.02] *= 8.0      # outliers
    X["x2"][::19] = np.nan
    X["k"] = rng.integers(0, 4, rows).astype(np.float32)   # plateaus
    return X


@pytest.fixture(scope="module")
def trained():
    iso, agg = {}, {}
    with use_mesh(_MESH1), f64_rollups():
        for name, (rows, kw) in IF_CASES.items():
            cols = cols_of(rows, seed=rows)
            jf = h2o.Frame.from_arrays(cols)
            tf = Frame.from_arrays(cols, device="cpu")
            jm = JIF(**kw).train(training_frame=jf)
            X = np.asarray(jm._design_matrix(jf))[:rows]
            iso[name] = (jm, IsolationForest(**kw).train(training_frame=tf),
                         X, np.asarray(jm.score_numpy(X)))
        cols = cols_of(2000, seed=7)
        jf = h2o.Frame.from_arrays(cols)
        tf = Frame.from_arrays(cols, device="cpu")
        for target in AGG_TARGETS:
            kw = dict(target_num_exemplars=target)
            agg[target] = (JAggregator(**kw).train(training_frame=jf),
                           Aggregator(**kw).train(training_frame=tf))
    return iso, agg, cols


@pytest.mark.parametrize("name", list(IF_CASES))
def test_trees_bitwise(trained, name):
    jm, tm = trained[0][name][:2]
    assert tm.ntrees == jm.ntrees
    assert tm.sample_size_effective == jm.sample_size_effective
    for f in ("split_feat", "split_val", "is_split", "count"):
        a = np.asarray(getattr(jm.trees, f))
        b = getattr(tm.trees, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("name", list(IF_CASES))
def test_scores_within_1e_6(trained, name):
    jm, tm, X, want = trained[0][name]
    np.testing.assert_allclose(tm.score_numpy(X), want, rtol=0, atol=1e-6)
    pf = tm.predict(Frame.from_arrays(
        cols_of(IF_CASES[name][0], seed=IF_CASES[name][0]), device="cpu"))
    assert pf.names == ["predict", "mean_length"]
    np.testing.assert_allclose(pf["predict"].to_numpy(), want[:, 0],
                               rtol=0, atol=1e-6)


def test_isolation_forest_artifacts_both_ways(trained):
    jm, tm, X, want = trained[0]["default"]
    buf = io.BytesIO()
    export_mojo(tm, buf)
    for mm in (jmojo.MojoModel(io.BytesIO(buf.getvalue())),
               MojoModel(io.BytesIO(buf.getvalue()))):
        np.testing.assert_allclose(mm.predict(X), want, rtol=1e-6,
                                   atol=1e-6)
    buf2 = io.BytesIO()
    jmojo.export_mojo(jm, buf2)
    np.testing.assert_allclose(
        MojoModel(io.BytesIO(buf2.getvalue())).predict(X),
        jmojo.MojoModel(io.BytesIO(buf2.getvalue())).predict(X), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("target", AGG_TARGETS)
def test_aggregator_exemplars_equal(trained, target):
    jm, tm = trained[1][target]
    assert tm.num_exemplars() == jm.num_exemplars()
    assert np.array_equal(tm._ex_idx, np.asarray(jm._ex_idx))
    assert np.array_equal(tm._counts, np.asarray(jm._counts))
    assert tm._counts.sum() == 2000
    af = tm.aggregated_frame
    assert af.nrows == tm.num_exemplars() and af.names[-1] == "counts"
    cols = trained[2]
    np.testing.assert_array_equal(af["x1"].to_numpy(),
                                  cols["x1"][tm._ex_idx])


def test_aggregator_target_must_be_positive(trained):
    tf = Frame.from_arrays(trained[2], device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        Aggregator(target_num_exemplars=0).train(training_frame=tf)
