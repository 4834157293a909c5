"""PyTorch port, DRF: ``DRF(...).train`` in both packages on the same
seeded frame — binary, regression and 4-class responses.

The JAX package folds its row-shard index into each tree's bootstrap
key, so its reference runs on a ONE-row-shard mesh (``make_mesh(
n_rows=1)``, the JAX frame built inside it): the port is that one shard.
Every draw (bootstrap rows, per-node mtries features) comes from the
threefry twin, and DRF's histogram sums are exact for the 0/1 and
class-indicator targets, so held here:
- the split structure (split_feat, split_bin, na_left, is_split) is
  BITWISE equal, and so are the bootstrap keep masks of
  ``_round_sampling`` and the column masks;
- leaf values bitwise for the classification targets; for the
  regression target within 1e-6 of the tree's largest |leaf| (its
  float sums round in another order — the bin cumsum associates
  differently in XLA — and a leaf whose sum nearly cancels keeps no
  relative accuracy); predictions within 1e-6;
- the resolved mtries, the train metrics the port reports (1e-5), and
  the serving contract (contributions sum to the prediction, 1e-4).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models.drf import DRF as JDRF
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.runtime.mesh import ROWS, make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import DRF, Frame
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.runtime import prng

STRUCT = ("split_feat", "split_bin", "na_left", "is_split")
_KW = dict(ntrees=3, max_depth=3, seed=3)
_RESPONSES = {"binary": "yb", "regression": "yr", "4-class": "y4"}


def drf_cols(rows=4096, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(6)}
    X["x2"][::13] = np.nan
    X["c"] = np.array(list("abcd"))[rng.integers(0, 4, rows)]
    logit = X["x0"] - X["x1"] + 0.5 * X["x4"] + rng.normal(size=rows)
    X["yb"] = np.where(logit > 0, "p", "n")
    X["yr"] = (logit + 0.1 * X["x3"]).astype(np.float32)
    X["y4"] = np.array(list("ABCD"))[np.digitize(logit, [-1, 0, 1])]
    return X


@pytest.fixture(scope="module")
def forests():
    cols = drf_cols()
    out = {}
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.Frame.from_arrays(cols)
        for name, y in _RESPONSES.items():
            ign = [r for r in _RESPONSES.values() if r != y]
            jm = JDRF(**_KW).train(y=y, training_frame=jf,
                                   ignored_columns=ign)
            X = np.asarray(jm._design_matrix(jf))[: jf.nrows]
            jp = jm.score_numpy(X)
            tm = DRF(**_KW).train(y=y, training_frame=Frame.from_arrays(
                cols, device="cpu"), ignored_columns=ign)
            out[name] = (jm, tm, jp, X)
    return out


@pytest.mark.parametrize("case", list(_RESPONSES))
def test_forest_structure_bitwise(forests, case):
    jm, tm, _, _ = forests[case]
    K = 4 if case == "4-class" else 1
    assert tm.trees.split_feat.shape[0] == _KW["ntrees"] * K
    assert tm.params.mtries == jm.params.mtries == 2
    for f in STRUCT:
        np.testing.assert_array_equal(getattr(tm.trees, f).numpy(),
                                      np.asarray(getattr(jm.trees, f)),
                                      err_msg=f)
    assert tm.trees.is_split.any()
    got, want = tm.trees.value.numpy(), np.asarray(jm.trees.value)
    if case != "regression":             # 0/1 and class-indicator sums
        np.testing.assert_array_equal(got, want)
        return
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-6 * scale).all()


@pytest.mark.parametrize("case", list(_RESPONSES))
def test_predictions_and_metrics_close(forests, case):
    jm, tm, jp, X = forests[case]
    tp = tm.score_numpy(X)
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    jh, th = jm.scoring_history[-1], tm.scoring_history[-1]
    assert set(th) <= set(jh) and len(th) >= 2
    for k in th:
        assert abs(th[k] - jh[k]) <= 1e-5 * max(1.0, abs(jh[k])), k
    assert tm.drf_mode and tm.algo == "drf"
    np.testing.assert_array_equal(
        tm.init_score, np.zeros(4 if case == "4-class" else 1))


def test_contributions_sum_to_the_prediction(forests):
    """A binomial forest has no link: Σφ = P(class 1)."""
    _, tm, _, X = forests["binary"]
    phi = tm.contrib_numpy(X[:300]).astype(np.float64)
    p1 = tm.score_numpy(X[:300])[:, 1]
    np.testing.assert_allclose(phi.sum(axis=1), p1, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sample_rate,col_rate", [(0.632, 1.0),
                                                  (0.5, 0.7)])
def test_round_sampling_masks_bitwise(sample_rate, col_rate):
    """The JAX package's _round_sampling on a one-shard mesh against the
    port's, for three trees' keys: the kept rows and columns are equal."""
    rows, F = 1000, 7
    w = np.ones(rows, np.float32)
    w[::9] = 0.0
    jbp = jcore.BoostParams(sample_rate=sample_rate,
                            col_sample_rate_per_tree=col_rate)
    mesh = make_mesh(n_rows=1)
    jfn = jax.jit(jax.shard_map(
        lambda w, kr, kc: jcore._round_sampling(jbp, w, F, kr, kc),
        mesh=mesh, in_specs=(P(ROWS), P(), P()), out_specs=(P(ROWS), P())))
    tbp = tcore.BoostParams(sample_rate=sample_rate,
                            col_sample_rate_per_tree=col_rate)
    jkeys = jax.random.split(jax.random.key(9), 3)
    tkeys = prng.split(prng.key(9), 3)
    for t in range(3):
        jr, jc, _ = jax.random.split(jkeys[t], 3)
        wj, cj = jfn(w, jr, jc)
        tr, tc, _ = prng.split(tkeys[t], 3)
        wt, ct = tcore._round_sampling(tbp, torch.as_tensor(w), F,
                                       tr[None], tc[None])
        np.testing.assert_array_equal(wt[0].numpy(), np.asarray(wj))
        if col_rate < 1.0:
            np.testing.assert_array_equal(ct[0].numpy(), np.asarray(cj))
        else:
            assert ct is None and np.asarray(cj).all()


def test_trees_do_not_depend_on_the_group_size(monkeypatch):
    """A forest grown 2 trees at a time equals one grown all at once."""
    cols = drf_cols(rows=1500, seed=4)
    kw = dict(ntrees=4, max_depth=3, seed=2)
    fr = Frame.from_arrays(cols, device="cpu")
    ign = ["yr", "y4"]
    whole = DRF(**kw).train(y="yb", training_frame=fr, ignored_columns=ign)
    monkeypatch.setattr(tcore, "drf_group_size", lambda n, p, F: (2, 2))
    pairs = DRF(**kw).train(y="yb", training_frame=fr, ignored_columns=ign)
    for a, b in zip(whole.trees, pairs.trees):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arg,want", [(-1, 2), (-2, -1), (5, 5)])
def test_mtries_resolution_matches_reference(arg, want):
    cols = drf_cols(rows=200)
    ign = ["yr", "y4"]
    tf = Frame.from_arrays(cols, device="cpu")
    t = DRF(mtries=arg)
    t._resolve_mtries("yb", tf, None, ign)
    j = JDRF(mtries=arg)
    j._resolve_mtries("yb", h2o.Frame.from_arrays(cols), None, ign)
    assert t.params.mtries == j.params.mtries == want
    t = DRF()
    t._resolve_mtries("yr", tf, None, ["yb", "y4"])
    assert t.params.mtries == 2                      # 7 features // 3


def test_key_schedule_follows_the_dispatch_chunks():
    """At drf_higgs's shape (1,000,000 rows x 28 features x 64 bins x
    2^8 = 4.59e11 work units a tree, against the JAX package's 3e12 per
    dispatch) the JAX package grows 10 trees in chunks [6, 4], each from
    its own split of the seed key; the port walks the same schedule."""
    from h2o_kubernetes_tpu.models import gbm as jgbm
    from h2o_kubernetes_tpu_torch.models import gbm as tgbm

    jp = jgbm.GBMParams(ntrees=10, max_depth=8, nbins=64, seed=1,
                        _drf_mode=True)
    tp = tgbm.GBMParams(ntrees=10, max_depth=8, nbins=64, seed=1,
                        _drf_mode=True)
    assert tgbm._chunk_sizes(tp, 1_000_000, 28, 1) == \
        jgbm._chunk_sizes(jp, 1_000_000, 28, 1) == [6, 4]
    key, want = jax.random.key(1), []
    for n in (6, 4):
        key, kc = jax.random.split(key)
        want.append(np.asarray(jax.random.key_data(jax.random.split(kc,
                                                                    n))))
    got = tgbm._round_keys(tp, 1_000_000, 28, 1, "cpu").numpy()
    np.testing.assert_array_equal(got, np.concatenate(want).astype(
        np.int64))


def test_forest_without_draws_grows_identical_trees():
    """sample_rate=1 and mtries=-2 draw nothing: every tree of a group
    is grown (not one), and all are the same tree."""
    cols = drf_cols(rows=800, seed=6)
    m = DRF(ntrees=3, max_depth=3, sample_rate=1.0, mtries=-2).train(
        y="yb", training_frame=Frame.from_arrays(cols, device="cpu"),
        ignored_columns=["yr", "y4"])
    assert m.trees.split_feat.shape[0] == 3
    for a in m.trees:
        assert torch.equal(a[0], a[1]) and torch.equal(a[0], a[2])
