"""PyTorch port, naive Bayes and PCA (``models/naivebayes.py``,
``models/pca.py``) against the JAX package's on the CPU.

The reference runs on a one-row-shard mesh with the port's column
statistics (``tests/torch_f64_rollups.py``: the float64 two-pass mean
and sigma), so both standardize alike. The frame has four normal
columns (NaNs in ``x1``), a Year-like column ``yr`` (mean 1997, sigma
6.3), a 4-level categorical with NAs and 2- and 3-class responses.

Naive Bayes, held here (binomial and 3-class, with weights and with
Laplace smoothing): priors, per-class means and standard deviations,
and the level tables within 1e-6 (of max(|x|, 1)); the reference's
tables carried into a port model score the training rows and a holdout
within 1e-6 of the reference's probabilities. Each package's own
trained model: probabilities and holdout metrics within 1e-5, on the
columns of moderate mean. The measured gap there is 4.6e-06 (weights)
and 1.6e-06 (3 classes): the reference sums its class statistics in
float32 matmuls, the port in float64, so its means and deviations
differ by up to ~1e-7 relative and each row's Gaussian log-likelihood
by up to ~1e-6. On
``yr`` the reference's deviations, one float32 pass of Σx²/n − mean²,
are off: measured 6.9e-02 against the float64 value of 6.3 (1.1%,
cancellation between two terms near 4·10⁶), so there the port's means
and deviations are held to a numpy float64 two-pass computation per
class within 1e-6 of max(|x|, 1), and the reference's gap is only
shown to exceed 1e-3.

PCA, held here (STANDARDIZE with and without ``use_all_factor_levels``,
DEMEAN with all levels, DESCALE, NONE; ``yr`` enters the STANDARDIZE
cases only:
left unscaled or uncentred, its mean of 1997 puts the Gram matrix's
small eigenvalues below float32 resolution in both packages, measured
0.35 apart under NONE): eigenvalues within 1e-5 relative, loadings
within 1e-4 after the sign convention (the largest-|loading|
coordinate positive), the proportion of variance explained within
1e-5, scores within 1e-4 of max|score|; artifacts both ways within
1e-6.
"""

import io

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models import PCA as JPCA
from h2o_kubernetes_tpu.models import NaiveBayes as JNB
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import (PCA, Frame, MojoModel, NaiveBayes,
                                      export_mojo)
from torch_f64_rollups import f64_rollups

_MESH1 = make_mesh(n_rows=1)
TOL = 1e-6
_RESP = ["y2", "y3", "w"]
NB_CASES = {
    "binomial": ("y2", {}, {"x": ["x0", "x1", "x2", "c"]}),
    "multinomial": ("y3", {"laplace": 1.0},
                    {"x": ["x0", "x1", "x3", "c"]}),
    "weights": ("y2", {}, {"x": ["x0", "x1", "x2", "c"],
                           "weights_column": "w"}),
    "year": ("y3", {}, {"x": ["x0", "yr", "c"]}),
}
PCA_CASES = [("STANDARDIZE", False), ("STANDARDIZE", True),
             ("DEMEAN", True), ("DESCALE", False), ("NONE", False)]


def cols_of(rows, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(4)}
    X["x1"][::17] = np.nan
    X["yr"] = (1997.0 + 6.3 * rng.normal(size=rows)).astype(np.float32)
    X["c"] = np.array(list("abcd"), dtype=object)[rng.integers(0, 4, rows)]
    X["c"][::23] = None
    lin = X["x0"] + 0.5 * (X["c"] == "b") + 0.2 * (X["yr"] - 1997.0)
    X["y2"] = np.array(["n", "y"])[(lin + rng.logistic(size=rows) > 0)
                                   .astype(int)]
    X["y3"] = np.array(list("pqr"))[np.digitize(lin + rng.normal(size=rows),
                                                [-0.5, 0.5])]
    X["w"] = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    return X


@pytest.fixture(scope="module")
def trained():
    cols, hold = cols_of(3000), cols_of(500, seed=5)
    tf = Frame.from_arrays(cols, device="cpu")
    nb, pca = {}, {}
    with use_mesh(_MESH1), f64_rollups():
        jf = h2o.Frame.from_arrays(cols)
        for name, (y, kw, tkw) in NB_CASES.items():
            nb[name] = (JNB(**kw).train(y=y, training_frame=jf, **tkw),
                        NaiveBayes(**kw).train(y=y, training_frame=tf,
                                               **tkw))
        for t, all_lv in PCA_CASES:
            kw = dict(k=3, transform=t, use_all_factor_levels=all_lv)
            ign = _RESP + ([] if t == "STANDARDIZE" else ["yr"])
            pca[(t, all_lv)] = (
                JPCA(**kw).train(training_frame=jf, ignored_columns=ign),
                PCA(**kw).train(training_frame=tf, ignored_columns=ign))
    return nb, pca, cols, hold


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1.0)), \
        np.abs(a - b).max()


def _class_two_pass(x, y, w, K):
    """Per-class weighted mean and population sigma of x's non-NaN
    cells, numpy float64, mean first."""
    mean, sd = np.zeros(K), np.zeros(K)
    for k in range(K):
        m = (y == k) & ~np.isnan(x)
        ww, xx = w[m].astype(np.float64), x[m].astype(np.float64)
        mean[k] = (ww * xx).sum() / ww.sum()
        sd[k] = np.sqrt((ww * (xx - mean[k]) ** 2).sum() / ww.sum())
    return mean, sd


@pytest.mark.parametrize("name", list(NB_CASES))
def test_naivebayes_tables(trained, name):
    jm, tm = trained[0][name]
    assert tm.num_cols == jm.num_cols and tm.enum_cols == jm.enum_cols
    _close(tm.priors.numpy(), np.asarray(jm.priors))
    for a, b in zip(tm.enum_tables, jm.enum_tables):
        _close(a.numpy(), np.asarray(b))
    if name != "year":
        _close(tm.num_mean.numpy(), np.asarray(jm.num_mean))
        _close(tm.num_sd.numpy(), np.asarray(jm.num_sd))
        return
    # the Year-like column: the port against float64 two-pass sums, the
    # reference's float32 single pass measurably apart
    cols = trained[2]
    codes = np.searchsorted(["p", "q", "r"], cols["y3"])
    for j, i in enumerate(tm.num_cols):
        mean, sd = _class_two_pass(cols[tm.feature_names[i]], codes,
                                   np.ones(len(codes)), 3)
        _close(tm.num_mean.numpy()[:, j], mean)
        _close(tm.num_sd.numpy()[:, j], np.maximum(sd, 1e-3))
    yr = tm.feature_names.index("yr")
    j = tm.num_cols.index(yr)
    gap = np.abs(tm.num_sd.numpy()[:, j] - np.asarray(jm.num_sd)[:, j])
    assert gap.max() > 1e-3, gap


def _carried(jm, tm):
    """A port model holding the reference's tables."""
    from h2o_kubernetes_tpu_torch.models.naivebayes import NaiveBayesModel
    from h2o_kubernetes_tpu_torch.models.base import TrainData

    td = TrainData(tm.feature_names, None, None, 0, tm.nclasses,
                   tm.response_domain, tm.distribution, tm.feature_domains)
    return NaiveBayesModel(td, tm.params, np.asarray(jm.priors),
                           np.asarray(jm.num_mean), np.asarray(jm.num_sd),
                           [np.asarray(t) for t in jm.enum_tables],
                           jm.enum_cols, jm.num_cols, "cpu")


@pytest.mark.parametrize("name", [n for n in NB_CASES if n != "year"])
def test_naivebayes_probabilities_and_metrics(trained, name):
    jm, tm = trained[0][name]
    y = NB_CASES[name][0]
    cols, hold = trained[2], trained[3]
    carried = _carried(jm, tm)
    for data in (cols, hold):
        jf = h2o.Frame.from_arrays(data)
        X = np.asarray(jm._design_matrix(jf))[: len(data["x0"])]
        want = np.asarray(jm.score_numpy(X))
        _close(carried.score_numpy(X), want)
        _close(tm.score_numpy(X), want, tol=1e-5)
    jp = jm.model_performance(h2o.Frame.from_arrays(hold), y=y)
    tp = tm.model_performance(Frame.from_arrays(hold, device="cpu"), y=y)
    assert set(tp) == set(jp)
    for k in jp:
        assert abs(tp[k] - jp[k]) <= 1e-5, (k, tp[k], jp[k])
    pf = tm.predict(Frame.from_arrays(hold, device="cpu"))
    assert pf.names[0] == "predict" and len(pf.names) == 1 + tm.nclasses


def test_naivebayes_needs_a_categorical_response(trained):
    cols = trained[2]
    for cls, fr in ((JNB, h2o.Frame.from_arrays(cols)),
                    (NaiveBayes, Frame.from_arrays(cols, device="cpu"))):
        with pytest.raises(ValueError, match="categorical response"):
            cls().train(y="x0", training_frame=fr)


@pytest.mark.parametrize("case", PCA_CASES,
                         ids=[f"{t}-{a}" for t, a in PCA_CASES])
def test_pca_components(trained, case):
    jm, tm = trained[1][case]
    jv = np.asarray(jm.eigenvalues, np.float64)
    tv = tm.eigenvalues.numpy().astype(np.float64)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tm.eigenvectors.numpy(),
                               np.asarray(jm.eigenvectors), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tm.pve(), jm.pve(), rtol=1e-5)
    assert tm.dinfo.coef_names == jm.dinfo.coef_names
    hold = trained[3]
    X = np.asarray(jm._design_matrix(h2o.Frame.from_arrays(hold)))[:500]
    js, ts = np.asarray(jm.score_numpy(X)), tm.score_numpy(X)
    assert np.abs(ts - js).max() <= 1e-4 * np.abs(js).max()
    perf = tm.model_performance()
    np.testing.assert_allclose(perf["std_deviation"],
                               jm.model_performance()["std_deviation"],
                               rtol=1e-5)


def test_pca_k_too_large_and_unknown_transform(trained):
    cols = trained[2]
    tf = Frame.from_arrays(cols, device="cpu")
    with pytest.raises(ValueError, match="expanded features"):
        PCA(k=40).train(training_frame=tf, ignored_columns=_RESP)
    with pytest.raises(ValueError, match="unknown transform"):
        PCA(transform="bogus").train(training_frame=tf)


@pytest.mark.parametrize("which", ["naivebayes", "pca"])
def test_artifacts_both_ways(trained, which):
    jm, tm = trained[0]["multinomial"] if which == "naivebayes" else \
        trained[1][("STANDARDIZE", False)]
    hold = trained[3]
    tf = Frame.from_arrays(hold, device="cpu")
    want = tm.predict_raw(tf)
    buf = io.BytesIO()
    export_mojo(tm, buf)
    jp = jmojo.MojoModel(io.BytesIO(buf.getvalue())).predict(
        h2o.Frame.from_arrays(hold))
    np.testing.assert_allclose(jp, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        MojoModel(io.BytesIO(buf.getvalue())).predict(tf), want, rtol=0,
        atol=1e-6)
    buf2 = io.BytesIO()
    jmojo.export_mojo(jm, buf2)
    jf = h2o.Frame.from_arrays(hold)
    np.testing.assert_allclose(
        MojoModel(io.BytesIO(buf2.getvalue())).predict(tf),
        jmojo.MojoModel(io.BytesIO(buf2.getvalue())).predict(jf), rtol=0,
        atol=1e-6)
