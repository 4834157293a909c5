"""PyTorch port, the training slice as a whole: ``GBM(...).train`` on a
bench.py-shaped frame (8 normal columns, an 8-level enum, an
exponential column) in both packages, bernoulli and gaussian, on the CPU.

The JAX package sums each level's histograms over 8 row shards and the
port on one device, so sums agree to f32 rounding, not bitwise
(tests/test_torch_tree_core.py holds the bitwise contract on dyadic
data). Held here:
- the split structure (split_feat, split_bin, na_left, is_split) is
  equal. Where a split_bin differs, the test shows that the two
  thresholds are a near-tie: their float64 gains on the node's rows
  differ by under 1e-6 relative. Where a node's two splits part its
  rows into the same two sets with left and right swapped (NA against
  the rest, the NA side flipped: an exact tie, decided by f32
  rounding), the node's subtrees are compared crosswise;
- leaf values within rtol 1e-5, with an absolute floor of 1e-5 × the
  tree's largest |leaf| (a leaf whose gradient sum nearly cancels has
  no relative accuracy in f32 under another summation order);
- probabilities, train AUC and logloss (or RMSE), holdout metrics and
  variable importances within 1e-5;
- a model trained by the JAX package and carried across as numpy
  arrays scores BITWISE through ``flat_margin``.
"""

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu_torch import GBM, Frame
from h2o_kubernetes_tpu_torch.models.gbm import gbm_model_from_arrays
from h2o_kubernetes_tpu_torch.models.tree import core as tcore

TOL = 1e-5
STRUCT = ("split_feat", "split_bin", "na_left", "is_split")


def bench_cols(rows, seed=0, gaussian=False):
    """bench.py's training table (bench.py:137-146) at ``rows`` rows."""
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(8)}
    X["c1"] = np.array(list("abcdefgh"))[rng.integers(0, 8, size=rows)]
    X["dep_delay"] = rng.exponential(10.0, size=rows).astype(np.float32)
    logit = (1.2 * X["x0"] - 0.8 * X["x1"] + 0.05 * X["dep_delay"]
             - 1.0 + rng.normal(scale=0.5, size=rows))
    X["y"] = logit.astype(np.float32) if gaussian else \
        np.where(logit > 0, "late", "ontime")
    X["x3"][::17] = np.nan
    return X


# one row count for both, so the JAX package compiles its binning once
_CASES = {"bernoulli": (4096, False), "gaussian": (4096, True)}
_KW = dict(ntrees=3, max_depth=5, learn_rate=0.2, seed=1)


@pytest.fixture(scope="module")
def trained(mesh8):
    out = {}
    for dist, (rows, gauss) in _CASES.items():
        cols = bench_cols(rows, gaussian=gauss)
        jm = JGBM(**_KW).train(y="y", training_frame=h2o.Frame.from_arrays(
            cols))
        tf = Frame.from_arrays(cols, device="cpu")
        tm = GBM(**_KW).train(y="y", training_frame=tf)
        assert tm.distribution == jm.distribution == dist
        hold = bench_cols(1000, seed=9, gaussian=gauss)
        out[dist] = (jm, tm, tf, cols, hold)
    return out


def _gain64(binned_f, g, h, na_left, b, n_bins):
    """float64 split gain of ``bin <= b`` (NA per na_left) on rows."""
    na = binned_f == n_bins - 1
    left = np.where(na, na_left, binned_f <= b)

    def term(m):
        G, H = g[m].sum(), h[m].sum()
        return G * G / (H + 1e-10)
    return term(left) + term(~left) - term(np.ones_like(left))


def _split_gap(tm, tf, t, node, b_port, b_ref):
    """Relative float64 gain gap, on the port's rows at (tree t, node),
    between two thresholds of the node's split feature."""
    binned = tf.binned(tm.bin_spec)
    from h2o_kubernetes_tpu_torch.models.base import resolve_xy

    d = tm.distribution
    data = resolve_xy(tf, "y")
    margin = torch.full_like(data.y, float(tm.init_score[0]))
    trees = [tcore.Tree(*(a[s] for a in tm.trees)) for s in range(t + 1)]
    for tree in trees[:t]:
        margin = margin + tcore.predict_tree(tree, binned, 5, 256)
    g, h = (a.double().numpy() for a in tcore._grad_hess(d, margin, data.y))
    tree = trees[t]
    at = torch.zeros(binned.shape[1], dtype=torch.int64)
    for _ in range(int(np.log2(node + 1))):        # walk to node's level
        f = tree.split_feat[at].clamp(min=0)
        rb = binned[f.long(), torch.arange(binned.shape[1])].long()
        right = torch.where(rb == 255, ~tree.na_left[at],
                            rb > tree.split_bin[at])
        at = torch.where(tree.is_split[at], 2 * at + 1 + right.long(), at)
    rows = (at == node).numpy()
    f = int(tree.split_feat[node])
    nl = bool(tree.na_left[node])
    bf = binned[f].numpy()[rows]
    a = _gain64(bf, g[rows], h[rows], nl, b_port, 256)
    r = _gain64(bf, g[rows], h[rows], nl, b_ref, 256)
    return abs(a - r) / abs(r)


def _mirror_map(tm, jm, tf):
    """([T, N] the port's heap position of each of the reference's
    nodes, the (tree, node)s mirrored): the identity, except below a
    node where the two trees part the node's rows into the same two
    sets with left and right swapped, whose children map crosswise."""
    binned = tf.binned(tm.bin_spec).numpy()
    T = {f: getattr(tm.trees, f).numpy() for f in STRUCT}
    J = {f: np.asarray(getattr(jm.trees, f)) for f in STRUCT}
    n_trees, N = J["is_split"].shape
    pmap = np.tile(np.arange(N), (n_trees, 1))
    mirrored = set()

    def left(D, t, i):
        bf = binned[max(int(D["split_feat"][t, i]), 0)]
        return np.where(bf == 255, D["na_left"][t, i],
                        bf <= D["split_bin"][t, i])

    for t in range(n_trees):
        rows = {0: np.ones(binned.shape[1], dtype=bool)}
        for n in range(N):
            m, r = pmap[t, n], rows.pop(n, None)
            if 2 * n + 2 >= N:
                continue
            kids = (2 * m + 1, 2 * m + 2)
            if r is not None and J["is_split"][t, n]:
                lj = r & left(J, t, n)
                rows[2 * n + 1], rows[2 * n + 2] = lj, r & ~lj
                if T["is_split"][t, m] and r.any() and (
                        r & left(T, t, m) == r & ~lj).all():
                    kids = kids[::-1]
                    mirrored.add((t, n))
            pmap[t, 2 * n + 1], pmap[t, 2 * n + 2] = kids
    return pmap, mirrored


def _mapped(tm, f, pmap):
    a = getattr(tm.trees, f).numpy()
    return np.take_along_axis(a, pmap, axis=1)


@pytest.mark.parametrize("dist", list(_CASES))
def test_split_structure_equal(trained, dist):
    jm, tm, tf, _, _ = trained[dist]
    pmap, mirrored = _mirror_map(tm, jm, tf)
    for f in ("split_feat", "is_split"):
        np.testing.assert_array_equal(_mapped(tm, f, pmap),
                                      np.asarray(getattr(jm.trees, f)),
                                      err_msg=f)
    nl_t = _mapped(tm, "na_left", pmap)
    nl_j = np.asarray(jm.trees.na_left)
    for t, node in np.argwhere(nl_t != nl_j):
        assert (t, node) in mirrored, ("na_left", t, node)
    sb_t = _mapped(tm, "split_bin", pmap)
    sb_j = np.asarray(jm.trees.split_bin)
    isp = np.asarray(jm.trees.is_split)
    for t, node in np.argwhere((sb_t != sb_j) & isp):
        if (t, node) in mirrored:
            continue
        gap = _split_gap(tm, tf, int(t), int(pmap[t, node]),
                         int(sb_t[t, node]), int(sb_j[t, node]))
        assert gap < 1e-6, (t, node, gap)


@pytest.mark.parametrize("dist", list(_CASES))
def test_leaf_values_close(trained, dist):
    jm, tm, tf, _, _ = trained[dist]
    pmap, _ = _mirror_map(tm, jm, tf)
    want = np.asarray(jm.trees.value)
    got = _mapped(tm, "value", pmap)
    leaf = ~np.asarray(jm.trees.is_split)
    scale = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want)
    assert (err[leaf] <= (TOL * np.abs(want) + TOL * scale)[leaf]).all()
    np.testing.assert_allclose(_mapped(tm, "cover", pmap),
                               np.asarray(jm.trees.cover), rtol=0, atol=0)


@pytest.mark.parametrize("dist", list(_CASES))
def test_scores_and_train_metrics_close(trained, dist):
    jm, tm, _, cols, hold = trained[dist]
    assert abs(float(tm.init_score[0]) - float(jm.init_score)) <= \
        TOL * max(1.0, abs(float(jm.init_score)))
    fr = h2o.Frame.from_arrays(cols)
    X = np.asarray(jm._design_matrix(fr))[: fr.nrows]
    np.testing.assert_allclose(tm.score_numpy(X), jm.score_numpy(X),
                               rtol=0, atol=TOL)
    jh, th = jm.scoring_history[-1], tm.scoring_history[-1]
    keys = ("train_auc", "train_logloss") if dist == "bernoulli" \
        else ("train_rmse",)
    for k in keys:
        assert abs(th[k] - jh[k]) <= TOL, (k, th[k], jh[k])
    jp = jm.model_performance(h2o.Frame.from_arrays(hold), y="y")
    tp = tm.model_performance(Frame.from_arrays(hold, device="cpu"), y="y")
    for k in tp:
        assert abs(tp[k] - jp[k]) <= TOL * max(1.0, abs(jp[k])), k
    jv, tv = jm.varimp(), tm.varimp()
    assert list(tv) == list(jv)
    np.testing.assert_allclose(list(tv.values()), list(jv.values()),
                               rtol=TOL, atol=TOL)


def test_predict_frame(trained):
    _, tm, _, _, hold = trained["bernoulli"]
    pf = tm.predict(Frame.from_arrays(hold, device="cpu"))
    assert pf.names == ["predict", "plate", "pontime"]
    p1 = pf["plate"].to_numpy()
    assert pf.nrows == 1000 and np.isfinite(p1).all()
    np.testing.assert_allclose(p1 + pf["pontime"].to_numpy(), 1.0,
                               atol=1e-6)


def test_carried_across_model_scores_bitwise(trained):
    """A JAX-trained GBM, handed over as numpy arrays, flattens to the
    same serving arrays and scores through flat_margin bitwise."""
    jm, _, _, cols, _ = trained["bernoulli"]
    spec = jm.bin_spec
    pm = gbm_model_from_arrays(
        {f: np.asarray(getattr(jm.trees, f)) for f in jcore.Tree._fields},
        np.asarray(spec.edges_matrix()), spec.is_enum, jm.init_score,
        jm.feature_names, jm.distribution, jm.nclasses,
        jm.params.max_depth, response_domain=jm.response_domain,
        device="cpu")
    jflat = jm._flat()
    tflat = pm._serving_prepare()[0]
    for name, a, b in zip(jcore.FlatTrees._fields, jflat, tflat):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    fr = h2o.Frame.from_arrays(cols)
    X = np.asarray(jm._design_matrix(fr))[: fr.nrows]
    em = np.asarray(spec.is_enum)
    want = np.asarray(jcore.flat_margin(jflat, X, em, 5, 1))
    got = tcore.flat_margin(tflat, torch.as_tensor(X), torch.as_tensor(em),
                            5, 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(pm.score_numpy(X), jm.score_numpy(X),
                               rtol=0, atol=1e-6)
    phi = pm.contrib_numpy(X[:300])
    p1 = pm.score_numpy(X[:300])[:, 1].astype(np.float64)
    np.testing.assert_allclose(phi.sum(axis=1), np.log(p1 / (1 - p1)),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw,item", [
    ({"nfolds": 3}, "item 11"),
    ({"score_every": 2}, "item 11"),
    ({"env": "H2O_TPU_GOSS"}, "item 9"),
    ({"env": "H2O_TPU_OOC"}, "item 9"),
])
def test_unported_options_raise(kw, item, monkeypatch):
    """The options that once raised, naming their ROADMAP item, are
    ported and train, engaged: item 11's cross-validation (fold models
    and holdout predictions) and ``score_every`` (a history row every
    2 trees), item 9's knobs (the GOSS compaction ran, the out-of-core
    chunks streamed)."""
    cols = bench_cols(200)
    fr = Frame.from_arrays(cols, device="cpu")
    kw = dict(kw)
    env = kw.pop("env", None)
    if env:
        monkeypatch.setenv(env, "1")
    model = GBM(ntrees=2, min_rows=1.0, **kw).train(y="y",
                                                    training_frame=fr)
    if env == "H2O_TPU_GOSS":
        assert model.goss_dropped == 0
    elif env == "H2O_TPU_OOC":
        assert model.ooc_stats["streamed"]
    elif "nfolds" in kw:
        assert item == "item 11" and len(model.cv.models) == 3
        assert model.cross_validation_holdout_predictions().shape == \
            (200, 2)
    else:
        assert item == "item 11"
        assert [h["ntrees"] for h in model.scoring_history] == [2]
