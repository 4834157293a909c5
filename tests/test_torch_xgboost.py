"""PyTorch port, XGBoost-hist with pointwise objectives: ``XGBoost(...)
.train`` in both packages on the same seeded frame, on the CPU, and
the NDCG metric.

The JAX reference runs on a one-row-shard mesh, the port's layout.
XGBoost is GBM with XGBoost's defaults (eta 0.3, depth 6, reg_lambda 1,
min_child_weight 1 on hessian mass), so the trees are float sums and
agree as GBM's do. Held here:
- the objective aliases and H2O spellings map onto the same params as
  the JAX package's, field by field, and the same errors are raised;
- ``binary:logistic`` (with a weights column), ``reg:squarederror``
  (with ``min_child_weight`` 300 and ``gamma`` 150, which change the
  trees),
  ``count:poisson`` and ``multi:softprob``: split structure equal from
  the root down up to float64 near-ties (``tools/torch_tree_parity.walk``
  with the regularized gain, λ = 1), compared leaves within 1e-5 of the
  tree's largest |leaf|, predictions within 1e-5 on every row no tie
  routes differently; the options' trees differ from the option-free
  ones in both packages;
- an exported port model loads in the JAX package with bitwise
  ``flat_margin`` margins; a JAX model carried across as numpy arrays
  scores bitwise; a model file loads back as an ``XGBoostModel``;
- ``metrics.ndcg``: a known answer, and bitwise against the JAX
  package's on random groups with ties.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import metrics as JM
from h2o_kubernetes_tpu.models import XGBoost as JXGBoost
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.operator import registry as jreg
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import Frame, XGBoost, XGBoostModel, \
    export_mojo, load_model, save_model
from h2o_kubernetes_tpu_torch import metrics as M
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.models.xgboost import \
    xgboost_model_from_arrays
from tools.torch_tree_parity import round_stats, routed_apart, walk

TOL = 1e-5
_KW = dict(ntrees=3, max_depth=2, learn_rate=0.3, seed=1)
_AUX = ("yb", "yg", "yc", "ym", "w")
# objective, response, train kwargs, constructor options
CASES = {
    "binary:logistic": ("yb", {"weights_column": "w"}, {}),
    "reg:squarederror": ("yg", {}, {"min_child_weight": 300.0,
                                    "gamma": 150.0}),
    "count:poisson": ("yc", {}, {}),
    "multi:softprob": ("ym", {}, {}),
}


def xgb_cols(rows, seed=0):
    """Five normals (NaNs in x2), a 4-level enum, and a response per
    objective: binary, gaussian, count, 3-class; weights in (0.2, 2)
    with every 13th row 0."""
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(5)}
    X["c1"] = np.array(list("abcd"))[rng.integers(0, 4, size=rows)]
    lin = 1.2 * X["x0"] - 0.8 * X["x1"] + 0.5 * X["x2"] * X["x3"] \
        + 0.4 * (X["c1"] == "b")
    X["x2"][::17] = np.nan
    X["yb"] = np.where(lin + rng.logistic(size=rows) > 0, "yes", "no")
    X["yg"] = (lin + rng.normal(scale=0.5, size=rows)).astype(np.float32)
    X["yc"] = rng.poisson(np.exp(0.5 * lin)).astype(np.float32)
    X["ym"] = np.array(list("pqr"))[np.digitize(
        lin + rng.normal(scale=0.5, size=rows), [-0.7, 0.7])]
    X["w"] = rng.uniform(0.2, 2.0, rows).astype(np.float32)
    X["w"][::13] = 0.0
    return X


def _kw(objective):
    y, train_kw, opts = CASES[objective]
    ign = [c for c in _AUX if c != y and c != train_kw.get(
        "weights_column")]
    return y, dict(train_kw, ignored_columns=ign), opts


@pytest.fixture(scope="module")
def trained():
    cols = xgb_cols(2048)
    hold = xgb_cols(500, seed=9)
    tf = Frame.from_arrays(cols, device="cpu")
    out = {}
    th = Frame.from_arrays(hold, device="cpu")
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.Frame.from_arrays(cols)
        for obj in CASES:
            y, kw, opts = _kw(obj)
            jm = JXGBoost(objective=obj, **_KW, **opts).train(
                y=y, training_frame=jf, **kw)
            tm = XGBoost(objective=obj, **_KW, **opts).train(
                y=y, training_frame=tf, **kw)
            # the reference's predictions: its trees, carried across,
            # score bitwise (test_artifacts_and_carried_models_...)
            X = tm._design_matrix(th).numpy()
            out[obj] = (jm, tm, X, _carry(jm).score_numpy(X))
    return out, cols, tf


def test_params_match_the_reference_field_by_field(mesh8):
    for kw in ({}, {"objective": "binary:logistic", "eta": 0.1,
                    "subsample": 0.7, "colsample_bytree": 0.5,
                    "reg_alpha": 0.2, "gamma": 1.5},
               {"objective": "rank:pairwise", "min_rows": 3.0,
                "sample_rate": 0.6, "col_sample_rate_per_tree": 0.4,
                "ntrees": 7, "max_depth": 4, "nbins": 64}):
        jp = JXGBoost(**kw).params
        tp = XGBoost(**kw).params
        for f in dataclasses.fields(tp):
            if f.name in ("checkpoint", "_drf_mode"):
                continue
            assert getattr(tp, f.name) == getattr(jp, f.name), (kw, f.name)
    assert XGBoost().params.reg_lambda == 1.0
    assert XGBoost().params.min_child_weight == 1.0
    assert XGBoost().params.min_rows == 1.0
    for kw, msg in (({"objective": "nope:nope"}, "unknown objective"),
                    ({"booster": "dart"}, "only booster=gbtree"),
                    ({"tree_method": "exact"}, "unknown tree_method")):
        for cls in (JXGBoost, XGBoost):
            with pytest.raises(ValueError, match=msg):
                cls(**kw)
    assert XGBoost(nfolds=3).cv_args.nfolds == 3   # item 11: ported


def _multi_stats(tm, tf, y):
    """Per tree of a multi:softprob model, float64 (g, h) of its class
    at the round's softmax (the model's own earlier rounds)."""
    from h2o_kubernetes_tpu_torch.models.base import resolve_xy

    K = tm.nclasses
    binned = tf.binned(tm.bin_spec)
    yv = resolve_xy(tf, y).y.numpy()
    d, B = tm.params.max_depth, tm.params.nbins
    margin = np.tile(np.asarray(tm.init_score, np.float64), (len(yv), 1))
    out = []
    for r in range(tm.params.ntrees):
        pr = np.exp(margin - margin.max(1, keepdims=True))
        pr /= pr.sum(1, keepdims=True)
        for k in range(K):
            out.append((pr[:, k] - (yv == k), pr[:, k] * (1 - pr[:, k])))
        for k in range(K):
            tree = tcore.Tree(*(a[r * K + k] for a in tm.trees))
            margin[:, k] += tcore.predict_tree(tree, binned, d,
                                               B).double().numpy()
    return out, binned.numpy()


@pytest.mark.parametrize("objective", list(CASES))
def test_trees_and_predictions_match_the_reference(trained, objective):
    out, cols, tf = trained
    jm, tm, X, want = out[objective]
    y, kw, _ = _kw(objective)
    assert tm.algo == jm.algo == "xgboost"
    assert tm.distribution == jm.distribution
    if objective == "multi:softprob":
        stats, binned = _multi_stats(tm, tf, y)
    else:
        stats, binned = round_stats(tm, tf, y, kw)
    compared, ties, gaps = walk(tm, jm, stats, binned, lam=1.0)
    assert compared >= 0.9 * int(np.asarray(jm.trees.is_split).sum()), \
        (compared, ties)
    assert len(ties) <= 3 and gaps.max() <= TOL, (ties, gaps.max())
    hold = Frame.from_arrays({n: X[:, j] for j, n in enumerate(
        tm.feature_names)}, domains={"c1": ["a", "b", "c", "d"]},
        device="cpu")
    got = tm.predict_raw(hold)
    ok = ~routed_apart(tm, jm, hold) if ties else slice(None)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[ok], want[ok], rtol=TOL,
                               atol=TOL * scale)


def test_options_change_the_trees_as_in_the_reference(trained):
    """Weights, min_child_weight and gamma: each option's trees differ
    from the option-free train in both packages (the parity above
    holds them equal to each other)."""
    out, cols, tf = trained
    for obj in ("binary:logistic", "reg:squarederror"):
        jm, tm, _, _ = out[obj]
        y, kw, _ = _kw(obj)
        kw.pop("weights_column", None)
        plain = XGBoost(objective=obj, **_KW).train(
            y=y, training_frame=tf,
            ignored_columns=[c for c in _AUX if c != y])
        assert not torch.equal(plain.trees.is_split, tm.trees.is_split) \
            or not torch.equal(plain.trees.value, tm.trees.value)
    _, tm, _, _ = out["reg:squarederror"]
    assert int(tm.trees.is_split.sum()) < int(plain.trees.is_split.sum())


def _carry(jm):
    spec = jm.bin_spec
    return xgboost_model_from_arrays(
        {f: np.asarray(getattr(jm.trees, f)) for f in jcore.Tree._fields},
        np.asarray(spec.edges_matrix()), spec.is_enum,
        np.asarray(jm.init_score), jm.feature_names, jm.distribution,
        jm.nclasses, jm.params.max_depth,
        response_domain=jm.response_domain,
        feature_domains=jm.feature_domains, device="cpu",
        learn_rate=jm.params.learn_rate, reg_lambda=jm.params.reg_lambda)


@pytest.mark.parametrize("objective", ["binary:logistic", "count:poisson",
                                       "multi:softprob"])
def test_artifacts_and_carried_models_score_bitwise(trained, objective,
                                                    tmp_path):
    out, _, _ = trained
    jm, tm, X, _ = out[objective]
    K = tm.nclasses if tm.nclasses > 2 else 1
    buf = io.BytesIO()
    export_mojo(tm, buf)
    js = jreg.load_artifact(buf.getvalue())
    assert js.algo == "xgboost"
    ft, em = js._serving_prepare()
    want = np.asarray(jcore.flat_margin(ft, jnp.asarray(X), em,
                                        tm.params.max_depth, K))
    ft_t, em_t = tm._serving_prepare()[:2]
    got = tcore.flat_margin(ft_t, torch.as_tensor(X), em_t,
                            tm.params.max_depth, K).numpy()
    np.testing.assert_array_equal(got, want)
    pm = _carry(jm)
    assert isinstance(pm, XGBoostModel) and pm.algo == "xgboost"
    want = np.asarray(jcore.flat_margin(jm._flat(), jnp.asarray(X),
                                        jm._enum_mask,
                                        jm.params.max_depth, K))
    ft_p, em_p = pm._serving_prepare()[:2]
    got = tcore.flat_margin(ft_p, torch.as_tensor(X), em_p,
                            pm.params.max_depth, K).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(pm.score_numpy(X), jm.score_numpy(X),
                               rtol=1e-6, atol=1e-6)
    # a model file keeps the class, the trees and the group column
    tm._group_column = "qid"
    back = load_model(save_model(tm, str(tmp_path / "m")), device="cpu")
    assert isinstance(back, XGBoostModel) and back._group_column == "qid"
    for f in tm.trees._fields:
        assert torch.equal(getattr(back.trees, f), getattr(tm.trees, f))
    tm._group_column = None


def test_ndcg_known_answer_and_bitwise():
    # one group, perfect order: 1; reversed: the known DCG ratio
    y = np.array([3, 2, 1, 0], np.float64)
    assert M.ndcg(y, -np.arange(4.0), np.zeros(4)) == 1.0
    rev = M.ndcg(y, np.arange(4.0), np.zeros(4))
    disc = 1 / np.log2(np.arange(2, 6))
    gains = 2.0 ** y - 1
    assert rev == pytest.approx((gains[::-1] * disc).sum()
                                / (gains * disc).sum(), rel=1e-15)
    # a group with no relevant row is left out of the mean
    assert M.ndcg([0, 0, 1, 0], [1, 2, 4, 3], [0, 0, 1, 1], k=1) == 1.0
    rng = np.random.default_rng(5)
    for k in (1, 3, 10):
        n = 700
        rel = rng.integers(0, 5, n).astype(np.float32)
        score = np.round(rng.normal(size=n), 1).astype(np.float32)  # ties
        grp = rng.integers(0, 40, n)
        assert M.ndcg(rel, score, grp, k=k) == JM.ndcg(rel, score, grp,
                                                        k=k)
