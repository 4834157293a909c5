"""PyTorch port, the six GBM distributions beyond bernoulli/gaussian/
multinomial: poisson, gamma, tweedie, laplace, quantile and huber, each
trained by both packages on the same seeded frame, on the CPU, with no
weights and with a weights column (plus an offset where the reference
allows one: not for laplace).

The JAX reference runs on a one-row-shard mesh, the port's layout (the
JAX package takes huber's δ per row shard and averages it over
shards). Sums are float, so trees agree to f32 rounding, and f32
rounding decides between thresholds whose gains tie at its resolution.
Held here:
- the split structure (split_feat, split_bin, na_left, is_split) is
  equal from the root down; where a decision differs it is a float64
  near-tie: the two decisions' float64 gains on the node's rows, at the
  round's gradients and weights, differ by at most 1e-6 of the node's
  G²/H (``tools/torch_tree_parity.walk``), and that node's subtree is
  not compared;
- compared leaves within 1e-5 (absolute floor 1e-5 × the tree's largest
  |leaf|), ``init_score`` within 1e-6, laplace's ``margin_scale`` equal;
- predictions within 1e-5 relative (absolute floor 1e-5 × the largest
  |prediction|) on every row no tie routed differently, train RMSE and
  holdout metrics within 1e-5;
- huber's δ (``core.huber_delta``) bitwise equal to ``jnp.nanquantile``
  at 70,000 rows with weight-0 rows, on seeds where ``np.nanquantile``
  differs from both in the last bit (seed 0) and where it does not;
- the responses and offsets the reference rejects raise ValueError in
  both packages;
- a JAX model of each distribution carried across as numpy arrays
  scores bitwise-equal margins and explains within 1e-5 of the JAX
  package's float64 contributions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models.drf import DRF as JDRF
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import DRF, GBM, Frame
from h2o_kubernetes_tpu_torch.models.gbm import gbm_model_from_arrays
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from tools.torch_tree_parity import round_stats, routed_apart, walk

TOL = 1e-5
RESPONSES = {"poisson": "ycnt", "gamma": "ypos", "tweedie": "ycnt",
             "laplace": "yheavy", "quantile": "yheavy", "huber": "yheavy"}
_AUX = ("y", "ypos", "ycnt", "yheavy", "w", "off")
_KW = dict(ntrees=3, max_depth=3, learn_rate=0.2, seed=1)


def dist_cols(rows, seed=0):
    """bench.py's features (8 normals with NaNs, an 8-level enum, an
    exponential column) with responses for each family: a count, a
    positive gamma-noised response, a heavy-tailed one; weights (every
    11th row 0) and a small offset."""
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(8)}
    X["c1"] = np.array(list("abcdefgh"))[rng.integers(0, 8, size=rows)]
    X["dep_delay"] = rng.exponential(10.0, size=rows).astype(np.float32)
    lin = (0.6 * X["x0"] - 0.4 * X["x1"] + 0.02 * X["dep_delay"]
           + 0.3 * (X["c1"] < "d"))
    X["x3"][::17] = np.nan
    X["y"] = lin.astype(np.float32)
    X["ycnt"] = rng.poisson(np.exp(lin)).astype(np.float32)
    X["ypos"] = (np.exp(lin) * rng.gamma(2.0, 0.5, rows)).astype(np.float32)
    X["yheavy"] = (2 * lin + rng.standard_t(2, rows)).astype(np.float32)
    X["w"] = rng.uniform(0.2, 2.0, rows).astype(np.float32)
    X["w"][::11] = 0.0
    X["off"] = (0.1 * rng.normal(size=rows)).astype(np.float32)
    return X


def train_kw(dist, variant):
    """(response, train kwargs) of a case: ``plain`` or ``weighted``
    (weights, and the offset where the distribution takes one)."""
    y = RESPONSES.get(dist, "y")
    kw = {}
    if variant == "weighted":
        kw["weights_column"] = "w"
        if dist not in ("laplace", "multinomial"):
            kw["offset_column"] = "off"
    used = {y} | set(kw.values())
    kw["ignored_columns"] = [c for c in _AUX if c not in used]
    return y, kw


def carry(jm, device="cpu"):
    """A JAX GBM/DRF model as a port model, through numpy arrays."""
    spec = jm.bin_spec
    return gbm_model_from_arrays(
        {f: np.asarray(getattr(jm.trees, f)) for f in jcore.Tree._fields},
        np.asarray(spec.edges_matrix()), spec.is_enum,
        np.asarray(jm.init_score), jm.feature_names, jm.distribution,
        jm.nclasses, jm.params.max_depth,
        response_domain=jm.response_domain,
        feature_domains=jm.feature_domains, device=device,
        offset_column=getattr(jm, "offset_column", None),
        margin_scale=float(getattr(jm, "margin_scale", 1.0)),
        _drf_mode=jm.params._drf_mode, learn_rate=jm.params.learn_rate,
        seed=jm.params.seed, sample_rate=jm.params.sample_rate,
        col_sample_rate_per_tree=jm.params.col_sample_rate_per_tree,
        mtries=jm.params.mtries, min_rows=jm.params.min_rows)


@pytest.fixture(scope="module")
def trained():
    cols = dist_cols(4096)
    hold = dist_cols(1000, seed=9)
    out = {}
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.Frame.from_arrays(cols)
        jh = h2o.Frame.from_arrays(hold)
        tf = Frame.from_arrays(cols, device="cpu")
        th = Frame.from_arrays(hold, device="cpu")
        for dist in RESPONSES:
            for variant in ("plain", "weighted"):
                y, kw = train_kw(dist, variant)
                jm = JGBM(distribution=dist, **_KW).train(
                    y=y, training_frame=jf, **kw)
                tm = GBM(distribution=dist, **_KW).train(
                    y=y, training_frame=tf, **kw)
                stats, binned = round_stats(tm, tf, y, kw)
                jperf = jm.model_performance(jh, y=y)
                X = np.asarray(jm._design_matrix(jh))[: jh.nrows]
                off = hold["off"] if "offset_column" in kw else None
                jp = np.asarray(jm.predict_raw(jh))[: jh.nrows]
                out[dist, variant] = dict(
                    jm=jm, tm=tm, y=y, kw=kw, walk=walk(tm, jm, stats,
                                                        binned),
                    jperf=jperf, X=X, off=off, jp=jp, th=th, jh=jh)
    return out


CASES = [(d, v) for d in RESPONSES for v in ("plain", "weighted")]


@pytest.mark.parametrize("dist,variant", CASES)
def test_split_structure_equal_up_to_near_ties(trained, dist, variant):
    c = trained[dist, variant]
    compared, ties, gaps = c["walk"]
    n_ref = int(np.asarray(c["jm"].trees.is_split).sum()) * 2 + 3
    assert len(ties) <= 2 and compared >= 0.8 * n_ref, (ties, compared)
    assert gaps.max() <= TOL, gaps.max()


@pytest.mark.parametrize("dist,variant", CASES)
def test_init_scale_and_train_metric(trained, dist, variant):
    c = trained[dist, variant]
    jm, tm = c["jm"], c["tm"]
    ji = float(jm.init_score)
    assert abs(float(tm.init_score[0]) - ji) <= 1e-6 * max(1.0, abs(ji))
    assert tm.margin_scale == float(getattr(jm, "margin_scale", 1.0))
    if dist == "laplace":
        assert tm.margin_scale != 1.0
    jr = jm.scoring_history[-1]["train_rmse"]
    tr = tm.scoring_history[-1]["train_rmse"]
    assert abs(tr - jr) <= TOL * max(1.0, jr), (tr, jr)


@pytest.mark.parametrize("dist,variant", CASES)
def test_predictions_and_holdout_metrics(trained, dist, variant):
    c = trained[dist, variant]
    jm, tm = c["jm"], c["tm"]
    apart = routed_apart(tm, jm, c["th"])
    assert apart.mean() <= 0.05
    got = tm.score_numpy(c["X"], offset=c["off"])
    np.testing.assert_allclose(got[~apart], c["jp"][~apart], rtol=TOL,
                               atol=TOL * np.abs(c["jp"]).max())
    perf = tm.model_performance(c["th"], y=c["y"])
    assert set(perf) == set(c["jperf"])
    if not apart.any():
        for k, v in c["jperf"].items():
            assert abs(perf[k] - v) <= TOL * max(1.0, abs(v)), (k, perf[k],
                                                                v)


def test_poisson_deviance_is_poissons(trained):
    """model_performance of a poisson model reports the poisson
    deviance, as the JAX package's does."""
    c = trained["poisson", "plain"]
    from h2o_kubernetes_tpu_torch import metrics as M

    perf = c["tm"].model_performance(c["th"], y=c["y"])
    y = c["th"].vec(c["y"]).to_numpy()
    p = c["tm"].score_numpy(c["X"])
    assert perf["mean_residual_deviance"] == pytest.approx(
        M.mean_residual_deviance(y, p, "poisson"), rel=1e-12)
    assert perf["mean_residual_deviance"] != pytest.approx(
        M.mean_residual_deviance(y, p), rel=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_huber_delta_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = 70_000
    r = (rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0
    absr = np.where(w > 0, np.abs(r), np.nan).astype(np.float32)
    got = tcore.huber_delta(torch.as_tensor(r), torch.as_tensor(w), 0.9)
    got = got.numpy()
    want = np.asarray(jnp.nanquantile(jnp.asarray(absr), 0.9))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_huber_delta_empty_and_single():
    one = torch.tensor([3.0, -5.0])
    assert float(tcore.huber_delta(one, torch.tensor([0.0, 1.0]), 0.9)) \
        == 5.0
    assert np.isnan(float(tcore.huber_delta(one, torch.zeros(2), 0.9)))


@pytest.mark.parametrize("dist,y,kw,drf", [
    ("laplace", "yheavy", {"offset_column": "off"}, False),
    ("multinomial", "c1", {"offset_column": "off"}, False),
    ("gaussian", "y", {"offset_column": "off"}, True),
    ("gamma", "y", {}, False),
    ("poisson", "y", {}, False),
    ("tweedie", "y", {}, False),
])
def test_rejected_cases_raise(dist, y, kw, drf):
    cols = dist_cols(300, seed=2)
    ign = [c for c in _AUX + ("c1",) if c != y and c not in kw.values()]
    for mk, fr in ((JDRF if drf else JGBM, h2o.Frame.from_arrays(cols)),
                   (DRF if drf else GBM,
                    Frame.from_arrays(cols, device="cpu"))):
        est = mk(ntrees=2, max_depth=2) if drf else \
            mk(ntrees=2, max_depth=2, distribution=dist)
        with pytest.raises(ValueError):
            est.train(y=y, training_frame=fr, ignored_columns=ign, **kw)


@pytest.mark.parametrize("dist", list(RESPONSES))
def test_carried_across_scores_and_explains(trained, dist):
    """A JAX model of each distribution, carried across as numpy: its
    flat margins are bitwise the JAX package's, its predictions within
    1e-6 relative, and its contributions (the serving path) within 1e-5
    of the JAX package's float64 ``predict_contributions``, summing to
    the margin."""
    c = trained[dist, "plain"]
    jm = c["jm"]
    pm = carry(jm)
    assert pm.distribution == dist and pm.margin_scale == \
        float(getattr(jm, "margin_scale", 1.0))
    X = c["X"]
    em = np.asarray(jm.bin_spec.is_enum)
    want = np.asarray(jcore.flat_margin(jm._flat(), X, em, 3, 1))
    got = tcore.flat_margin(pm._serving_prepare()[0], torch.as_tensor(X),
                            torch.as_tensor(em), 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(pm.score_numpy(X), c["jp"], rtol=1e-6,
                               atol=0)
    phi = pm.contrib_numpy(X[:200]).astype(np.float64)
    jphi = jm.predict_contributions(c["jh"])
    jphi = np.stack([np.asarray(jphi.vec(n).to_numpy())
                     for n in jphi.names], axis=1)[:200]
    np.testing.assert_allclose(phi, jphi, rtol=0, atol=1e-5)
    margin = np.asarray(jm._margins(jnp.asarray(X[:200])))
    np.testing.assert_allclose(phi.sum(axis=1), margin, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(margin).max()))
