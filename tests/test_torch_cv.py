"""PyTorch port, cross-validation (``models/cv.py``) and the metric
surface it shares (``models/base.py``) against the JAX package's on the
CPU.

Reference trains run in module fixtures on a one-row-shard mesh (the
JAX Frame built inside it), at 600 rows with ``nfolds=3`` modulo folds,
so the reference's fold trains share one shape and compile once. Held
here:
- ``fold_ids`` bitwise for all four schemes (numpy draws);
- ``cross_validate`` for GBM, DRF, XGBoost, GLM and DeepLearning on a
  binomial response, plus a gaussian and a multinomial GBM: holdout
  predictions within 1e-5 (GLM 1e-4), the combined and per-fold
  metrics and ``metrics_summary`` to the same limits, the fold models'
  count. The ranking metrics (auc, pr_auc, gini, f1, its threshold,
  mean per-class error, accuracy) move in steps of 1/(P·N) when two
  rows' scores, equal or a few ulps apart, order differently, so those
  are held on identical inputs: the port's metric dispatch on the
  reference's holdout predictions equals the reference's metrics
  within the limit, and the port's CV metrics are its dispatch on its
  own holdout predictions. The multinomial case's fold frames hold
  nodes without a class's rows in round 1, whose splits all gain 0
  exactly; f32 rounding decides whether the reference splits them, and
  the margins of later rounds follow, so its training parity stays
  with tests/test_torch_multinomial.py: here its fold ids and metric
  dispatch are held to the reference's (on identical inputs), and each
  fold model to a port model trained directly on the fold's rows,
  bitwise, with the holdout predictions that model's;
- a ``fold_column``, a ``validation_frame`` and the reference's
  refusals (checkpoint with CV, an autoencoder, a fold column with NAs,
  nfolds past the rows, stratified folds on a numeric response);
- the shape-shared mode (``H2O_TPU_CV_SHAPE_SHARE_ROWS``) against the
  reference's shared mode;
- ``score_every``'s scoring history (the chunked key schedule);
- ``confusion_matrix`` and ``partial_plot`` against the reference.
"""

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import models as J
from h2o_kubernetes_tpu.models import cv as jcv
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
import h2o_kubernetes_tpu_torch as port
from h2o_kubernetes_tpu_torch.models import cv as tcv
from h2o_kubernetes_tpu_torch.models.base import score_predictions

_MESH1 = make_mesh(n_rows=1)
TOL = 1e-5
GLM_TOL = 1e-4
N = 600

_TREE = dict(ntrees=3, max_depth=3, seed=1)
CASES = {
    # name: (estimator name, response, estimator kwargs, tolerance)
    "gbm": ("GBM", "y", _TREE, TOL),
    "drf": ("DRF", "y", dict(ntrees=2, max_depth=2, seed=1), TOL),
    "xgboost": ("XGBoost", "y", _TREE, TOL),
    "glm": ("GLM", "y", dict(family="binomial"), GLM_TOL),
    "deeplearning": ("DeepLearning", "y", dict(hidden=(4,), epochs=1,
                                               seed=1), TOL),
    "gbm_gaussian": ("GBM", "yr", _TREE, TOL),
    "gbm_multinomial": ("GBM", "ym", dict(ntrees=3, max_depth=4,
                                          learn_rate=0.2, seed=1), TOL),
}
_RESP = ("y", "yr", "ym", "fold")
_RANKING = {"auc", "pr_auc", "gini", "f1", "max_f1_threshold",
            "mean_per_class_error", "accuracy"}


def cv_cols(rows=N, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    X["x2"][::41] = np.nan
    X["c"] = np.array(list("abcd"))[rng.integers(0, 4, rows)]
    s = X["x0"] - 0.7 * X["x1"] + 0.4 * rng.normal(size=rows)
    X["y"] = np.where(s > 0.2, "yes", "no")
    X["yr"] = (s + 0.1 * rng.normal(size=rows)).astype(np.float32)
    X["ym"] = np.array(list("pqrs"))[(X["x0"] > 0).astype(int)
                                     + (X["x1"] > 0.3).astype(int)
                                     + (X["x1"] > 1.0).astype(int)]
    X["fold"] = np.array(["f0", "f1", "f2"])[np.arange(rows) % 3]
    return X


def _ignored(y, extra=()):
    return [c for c in _RESP if c != y] + list(extra)


def _pair(name, cols, fold_kw=None, train_kw=None):
    """(JAX model, port model) of one case, trained with CV."""
    est, y, kw, _ = CASES[name]
    fkw = fold_kw or {"nfolds": 3, "fold_assignment": "modulo"}
    tkw = dict(train_kw or {})
    tkw.setdefault("ignored_columns", _ignored(y))
    with use_mesh(_MESH1):
        jfr = h2o.Frame.from_arrays(cols)
        jm = getattr(J, est)(**kw, **fkw).train(y=y, training_frame=jfr,
                                                **tkw)
    tf = port.Frame.from_arrays(cols, device="cpu")
    tm = getattr(port, est)(**kw, **fkw).train(y=y, training_frame=tf,
                                               **tkw)
    return jm, tm


@pytest.fixture(scope="module")
def cols():
    return cv_cols()


@pytest.fixture(scope="module")
def trained(cols):
    return {name: _pair(name, cols) for name in CASES}


def _close_metrics(got, want, tol, keys=None):
    assert set(got) == set(want)
    for k in (want if keys is None else keys):
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), \
            (k, got[k], want[k])


def _scored(model, y_true, preds):
    ok = ~np.isnan(y_true)
    return score_predictions(model.nclasses, model.distribution,
                             torch.as_tensor(y_true[ok]),
                             torch.as_tensor(preds[ok]))


def _fold_trains_direct(tm, y, cols, folds):
    """Each fold model equals bitwise a port model trained directly on
    the fold's other rows, and the holdout predictions are those
    models' predictions on the fold's rows."""
    est, _, kw, _ = CASES["gbm_multinomial"]
    tf = port.Frame.from_arrays(cols, device="cpu")
    tp = tm.cross_validation_holdout_predictions()
    for k, hold in enumerate(folds):
        m = getattr(port, est)(**kw).train(
            y=y, training_frame=tf.select_rows(~hold),
            ignored_columns=_ignored(y))
        for a, b in zip(m.trees, tm.cv.models[k].trees):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(
            m.predict_raw(tf.select_rows(hold)), tp[hold])


def _check_cv(jm, tm, tol, y, cols):
    """Holdout predictions; continuous metrics directly, ranking metrics
    on identical inputs (the module docstring)."""
    jc, tc = jm.cv, tm.cv
    np.testing.assert_array_equal(tc.fold_ids, jc.fold_ids)
    tp = tm.cross_validation_holdout_predictions()
    jp = np.asarray(jm.cross_validation_holdout_predictions())
    folds = [tc.fold_ids == k for k in range(len(tc.fold_metrics))]
    if y == "ym":
        _fold_trains_direct(tm, y, cols, folds)
    else:
        np.testing.assert_allclose(tp, jp, rtol=0, atol=tol)
    yt = port.Frame.from_arrays({y: cols[y]}, device="cpu").vec(y) \
        .as_float().numpy()
    cont = [] if y == "ym" else \
        [k for k in tc.metrics if k not in _RANKING]
    # the port's metrics are its dispatch on its own predictions ...
    assert tc.metrics == _scored(tm, yt, tp)
    assert tc.fold_metrics == [_scored(tm, yt[h], tp[h]) for h in folds]
    # ... which on the reference's predictions gives the reference's
    _close_metrics(_scored(tm, yt, jp), jc.metrics, tol)
    _close_metrics(tc.metrics, jc.metrics, tol, cont)
    assert len(tc.fold_metrics) == len(jc.fold_metrics)
    for h, a, b in zip(folds, tc.fold_metrics, jc.fold_metrics):
        _close_metrics(_scored(tm, yt[h], jp[h]), b, tol)
        _close_metrics(a, b, tol, cont)
    summ_t = tm.cross_validation_metrics_summary()
    summ_j = jm.cross_validation_metrics_summary()
    assert set(summ_t) == set(summ_j)
    for k in summ_j:
        vals = [f[k] for f in tc.fold_metrics]
        assert summ_t[k] == {"mean": float(np.mean(vals)),
                             "std": float(np.std(vals))}
        if k in cont:
            _close_metrics(summ_t[k], summ_j[k], tol)
    assert len(tm.cross_validation_models()) == \
        len(jm.cross_validation_models())


@pytest.mark.parametrize("scheme", ["auto", "random", "modulo",
                                    "stratified"])
def test_fold_ids_bitwise(scheme, cols):
    y = np.searchsorted(np.unique(cols["ym"]), cols["ym"]).astype(np.int32)
    for seed in (0, 7):
        np.testing.assert_array_equal(
            tcv.fold_ids(N, 5, scheme, y, seed),
            jcv.fold_ids(N, 5, scheme, y, seed))


@pytest.mark.parametrize("name", list(CASES))
def test_cross_validate_matches_the_reference(trained, cols, name):
    jm, tm = trained[name]
    assert isinstance(tm.cv.holdout_predictions, torch.Tensor)
    assert tm.cv.holdout_predictions.device.type == "cpu"
    _check_cv(jm, tm, CASES[name][3], CASES[name][1], cols)


def test_fold_column_and_validation_frame(cols):
    hold = cv_cols(200, seed=5)
    with use_mesh(_MESH1):
        jv = h2o.Frame.from_arrays(hold)
    tv = port.Frame.from_arrays(hold, device="cpu")
    est, y, kw, _ = CASES["gbm"]
    fkw = {"fold_column": "fold"}
    tkw = {"ignored_columns": _ignored(y, ())[:-1]}   # "fold" stays
    with use_mesh(_MESH1):
        jm = J.GBM(**kw, **fkw).train(
            y=y, training_frame=h2o.Frame.from_arrays(cols),
            validation_frame=jv, **tkw)
    tm = port.GBM(**kw, **fkw).train(
        y=y, training_frame=port.Frame.from_arrays(cols, device="cpu"),
        validation_frame=tv, **tkw)
    assert "fold" not in tm.feature_names
    assert tm.feature_names == jm.feature_names
    _check_cv(jm, tm, TOL, y, cols)
    _close_metrics(tm.validation_metrics, jm.validation_metrics, TOL,
                   [k for k in jm.validation_metrics if k not in _RANKING])


def test_refusals_match_the_reference(cols, trained):
    bad = dict(cols, fold=np.where(np.arange(N) % 7 == 0, None,
                                   cols["fold"]).astype(object))
    gbm_ckpt_j, gbm_ckpt_t = trained["gbm"]
    # the reference trains its main model before it refuses the folds:
    # the configuration of the CV cases, whose programs are compiled
    cases = [
        ("GBM", dict(_TREE, ntrees=4, nfolds=3), {"ckpt": True},
         "checkpoint cannot be combined"),
        ("GBM", dict(_TREE, fold_column="fold"), {"bad": True},
         "has NAs"),
        ("GBM", dict(_TREE, nfolds=N + 1), {}, "nfolds=601 > 600"),
        ("GBM", dict(_TREE, nfolds=3, fold_assignment="stratified"),
         {"y": "yr"}, "stratified folds need a categorical"),
    ]
    for est, kw, how, msg in cases:
        y = how.get("y", "y")
        c = bad if how.get("bad") else cols
        for mod, fr, ck in (
                (J, lambda: h2o.Frame.from_arrays(c), gbm_ckpt_j),
                (port, lambda: port.Frame.from_arrays(c, device="cpu"),
                 gbm_ckpt_t)):
            k = dict(kw, checkpoint=ck) if how.get("ckpt") else kw
            with pytest.raises(ValueError, match=msg), use_mesh(_MESH1):
                getattr(mod, est)(**k).train(
                    y=y, training_frame=fr(),
                    ignored_columns=_ignored(y, ()) if "fold_column"
                    not in kw else _ignored(y, ())[:-1])
    with pytest.raises(ValueError, match="unknown fold_assignment"):
        port.GBM(nfolds=3, fold_assignment="nope")
    with pytest.raises(ValueError, match="not supported for autoencoders"):
        port.DeepLearning(nfolds=3, autoencoder=True)


def test_shape_shared_mode_matches_the_reference(cols, monkeypatch):
    monkeypatch.setenv("H2O_TPU_CV_SHAPE_SHARE_ROWS", str(N))
    jm, tm = _pair("gbm", cols)
    _check_cv(jm, tm, TOL, "y", cols)
    # global binning saw the holdout rows: not the sliced mode's result
    with monkeypatch.context() as mp:
        mp.delenv("H2O_TPU_CV_SHAPE_SHARE_ROWS")
        sliced = port.GBM(**_TREE, nfolds=3, fold_assignment="modulo") \
            .train(y="y", training_frame=port.Frame.from_arrays(
                cols, device="cpu"), ignored_columns=_ignored("y"))
    assert not torch.equal(sliced.cv.holdout_predictions,
                           tm.cv.holdout_predictions)


def test_score_every_history_matches_the_reference(cols):
    kw = dict(ntrees=5, max_depth=3, seed=1, sample_rate=0.8,
              score_every=2)
    with use_mesh(_MESH1):
        jm = J.GBM(**kw).train(y="y", training_frame=h2o.Frame.from_arrays(
            cols), ignored_columns=_ignored("y"))
    tm = port.GBM(**kw).train(
        y="y", training_frame=port.Frame.from_arrays(cols, device="cpu"),
        ignored_columns=_ignored("y"))
    assert [h["ntrees"] for h in tm.scoring_history] == \
        [h["ntrees"] for h in jm.scoring_history] == [2, 4, 5]
    for a, b in zip(tm.scoring_history, jm.scoring_history):
        _close_metrics(a, b, TOL)
    for f in ("split_feat", "split_bin", "is_split"):
        np.testing.assert_array_equal(getattr(tm.trees, f).numpy(),
                                      np.asarray(getattr(jm.trees, f)))


@pytest.mark.parametrize("name", ["gbm", "gbm_multinomial", "glm"])
def test_confusion_matrix_matches_the_reference(trained, cols, name):
    jm, tm = trained[name]
    y = CASES[name][1]
    with use_mesh(_MESH1):
        jfr = h2o.Frame.from_arrays(cols)
        want = [jm.confusion_matrix(jfr, y)]
        if name != "gbm_multinomial":
            want.append(jm.confusion_matrix(jfr, y, threshold=0.5))
    tf = port.Frame.from_arrays(cols, device="cpu")
    got = [tm.confusion_matrix(tf, y)]
    if name != "gbm_multinomial":
        got.append(tm.confusion_matrix(tf, y, threshold=0.5))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["gbm", "gbm_gaussian"])
def test_partial_plot_matches_the_reference(trained, cols, name):
    jm, tm = trained[name]
    with use_mesh(_MESH1):
        want = jm.partial_plot(h2o.Frame.from_arrays(cols), ["x0", "c"],
                               nbins=6)
    got = tm.partial_plot(port.Frame.from_arrays(cols, device="cpu"),
                          ["x0", "c"], nbins=6)
    for g, w in zip(got, want):
        assert g.names == w.names
        for n in w.names:
            np.testing.assert_allclose(g.vec(n).to_numpy(),
                                       w.vec(n).to_numpy(), rtol=0,
                                       atol=TOL)
        if g.vec(g.names[0]).is_enum():
            assert g.vec(g.names[0]).domain == w.vec(w.names[0]).domain
