"""PyTorch port, XGBoost learning to rank (LambdaMART): the group
layout, the lambda gradients, the round's sampling and ``rank:ndcg`` /
``rank:pairwise`` trains, in both packages on the same seeded query
groups, on the CPU.

The JAX reference runs on a one-row-shard mesh, the port's layout (its
frames are then unpadded). The port batches the groups by size where
the reference maps fixed batches, so a group's gradients are the same
sums in another order. Held here:
- ``_GroupLayout``'s ``idx``/``pos``/``mask`` equal the reference's
  exactly, padded rows (fresh singleton groups) included;
- ``_ideal_dcg`` within 1e-6 relative;
- the lambda gradients (``_RankBatches.grads``, the reference's
  ``_lambda_grads``) g and h within 1e-6 of max|g| (max|h|) for both
  objectives, at the first round's tied margins and at random margins,
  with batches of several widths;
- the row and column masks of a ``subsample=0.8, colsample_bytree=0.6``
  round are bitwise the reference's draws;
- a ``rank:ndcg`` train (sampled, with a validation frame): split
  structure equal from the root down up to float64 near-ties
  (``tools/torch_tree_parity.walk``, λ = 1), compared leaves within
  1e-5 of the tree's largest |leaf|, train and validation ``ndcg@10``
  within 1e-6; a ``rank:pairwise`` train raises its NDCG;
- an enum relevance trains as its codes; ``group_column``,
  ``offset_column`` and cross-validation are refused.
"""

import jax
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import XGBoost as JXGBoost
from h2o_kubernetes_tpu.models import xgboost as jx
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import Frame, XGBoost
from h2o_kubernetes_tpu_torch.models import xgboost as tx
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.runtime import prng
from tools.torch_tree_parity import walk

_KW = dict(ntrees=3, max_depth=3, seed=1)
_OPTS = dict(subsample=0.8, colsample_bytree=0.6)


def rank_cols(n_groups=40, seed=0):
    """Query groups of 3 to 40 documents (qid float, rows in group
    order), three features (NaNs in f3), relevance 0-4 from two of
    them; some groups have no relevant document."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(3, 41, size=n_groups)
    n = int(sizes.sum())
    f = {f"f{i}": rng.normal(size=n).astype(np.float32) for i in range(4)}
    raw = 1.2 * f["f0"] - 0.8 * f["f1"] + rng.normal(scale=0.4, size=n)
    rel = np.clip(np.digitize(raw, [-0.5, 0.5, 1.2, 1.8]), 0, 4)
    qid = np.repeat(np.arange(n_groups), sizes)
    rel[qid % 7 == 3] = 0                      # groups with no relevant row
    f["f3"][::19] = np.nan
    return dict(f, rel=rel.astype(np.float32), qid=qid.astype(np.float32))


@pytest.fixture(scope="module")
def trained():
    cols, hold = rank_cols(), rank_cols(12, seed=7)
    tf, th = Frame.from_arrays(cols, device="cpu"), \
        Frame.from_arrays(hold, device="cpu")
    with use_mesh(make_mesh(n_rows=1)):
        jf, jh = h2o.Frame.from_arrays(cols), h2o.Frame.from_arrays(hold)
        jm = JXGBoost(objective="rank:ndcg", **_KW, **_OPTS).train(
            y="rel", training_frame=jf, group_column="qid",
            validation_frame=jh)
    tm = XGBoost(objective="rank:ndcg", **_KW, **_OPTS).train(
        y="rel", training_frame=tf, group_column="qid",
        validation_frame=th)
    return jm, tm, cols, tf


def _layout_case(seed):
    rng = np.random.default_rng(seed)
    n, padded = 300, 306
    gids = rng.integers(0, 25, n) * 3 + 1          # unsorted, sparse ids
    full = np.concatenate([gids, gids.max() + 1 + np.arange(padded - n)])
    return full, padded


def test_group_layout_matches_the_reference(mesh8):
    full, padded = _layout_case(0)
    jl, tl = jx._GroupLayout(full, padded), tx._GroupLayout(full, padded)
    assert (jl.n_groups, jl.max_docs) == (tl.n_groups, tl.max_docs)
    np.testing.assert_array_equal(np.asarray(jl.idx), tl.idx)
    np.testing.assert_array_equal(np.asarray(jl.pos), tl.pos)
    np.testing.assert_array_equal(np.asarray(jl.mask), tl.mask)
    assert (tl.pos[300:] >= 0).all()           # padded rows: own groups


def test_ideal_dcg_matches_the_reference(mesh8):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 5, (30, 17)).astype(np.float32)
    mask = rng.random((30, 17)) < 0.7
    want = np.asarray(jx._ideal_dcg(jax.numpy.asarray(y),
                                    jax.numpy.asarray(mask)))
    got = tx._ideal_dcg(torch.as_tensor(y), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("margins", ["tied", "random"])
@pytest.mark.parametrize("use_ndcg", [True, False], ids=["ndcg", "pairwise"])
def test_lambda_grads_match_the_reference(mesh8, margins, use_ndcg):
    cols = rank_cols(30, seed=3)
    y = cols["rel"]
    n = len(y)
    gid = cols["qid"].astype(np.int64)
    margin = np.zeros(n, np.float32) if margins == "tied" else \
        np.random.default_rng(4).normal(size=n).astype(np.float32)
    batch = 4
    jl = jx._GroupLayout(gid, n)
    yd, md = jx._dense_layout(jax.numpy.asarray(y), jl.idx, jl.mask)
    jg, jh = jx._lambda_grads(jax.numpy.asarray(margin), jl.idx, jl.pos,
                              jl.mask, use_ndcg, batch, y_dense=yd,
                              maxdcg=md)
    tl = tx._GroupLayout(gid, n)
    old = tx._PAIR_ELEMS
    tx._PAIR_ELEMS = 4 * 20 * 20               # several batch widths
    try:
        rb = tx._RankBatches(tl, torch.as_tensor(y), batch)
        assert len({w for _, _, w in rb.batches}) > 2
        tg, th = rb.grads(torch.as_tensor(margin), use_ndcg)
    finally:
        tx._PAIR_ELEMS = old
    jg, jh = np.asarray(jg), np.asarray(jh)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
    np.testing.assert_allclose(th.numpy(), jh, rtol=0,
                               atol=1e-6 * np.abs(jh).max())
    # the trainer's batches (one batch at these sizes) give the same
    g1, _ = tx._RankBatches(tl, torch.as_tensor(y), batch).grads(
        torch.as_tensor(margin), use_ndcg)
    np.testing.assert_allclose(g1.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())


def test_round_masks_are_the_reference_draws():
    n, F, rounds = 1000, 7, 3
    key = jax.random.key(11)
    keys = tx._rank_keys(11, rounds)
    for t in range(rounds):
        key, kt = jax.random.split(key)
        k_row, k_col, _ = jax.random.split(kt, 3)
        jrow = np.asarray(jax.random.uniform(k_row, (n,)) < 0.8)
        jcol = np.asarray(jax.random.uniform(k_col, (F,)) < 0.6)
        trow = (prng.uniform(keys[t, 0], (n,)) < 0.8).numpy()
        tcol = (prng.uniform(keys[t, 1], (F,)) < 0.6).numpy()
        np.testing.assert_array_equal(trow, jrow)
        np.testing.assert_array_equal(tcol, jcol)
        assert 0 < tcol.sum() < F


def _round_stats(tm, tf, objective):
    """Per round, float64 (g·w_t, h·w_t) of the port's lambda gradients
    at its own margins, and the [F, rows] codes."""
    p = tm.params
    y = tf.vec("rel").as_float()
    layout = tx._GroupLayout(tf.vec("qid").to_numpy().astype(np.int64),
                             tf.nrows)
    rb = tx._RankBatches(layout, y, 16)
    binned = tf.binned(tm.bin_spec)
    keys = tx._rank_keys(p.seed, p.ntrees)
    margin = torch.zeros(tf.nrows)
    out = []
    for t in range(p.ntrees):
        g, h = rb.grads(margin, objective == "rank:ndcg")
        w = torch.ones(tf.nrows)
        if p.sample_rate < 1.0:
            w = w * (prng.uniform(keys[t, 0], (tf.nrows,)) < p.sample_rate)
        out.append(((g * w).double().numpy(), (h * w).double().numpy()))
        tree = tcore.Tree(*(a[t] for a in tm.trees))
        margin = margin + tcore.predict_tree(tree, binned, p.max_depth,
                                             p.nbins)
    return out, binned.numpy()


def test_rank_train_matches_the_reference(trained):
    jm, tm, cols, tf = trained
    assert tm.algo == "xgboost" and tm.distribution == "rank:ndcg"
    stats, binned = _round_stats(tm, tf, "rank:ndcg")
    compared, ties, gaps = walk(tm, jm, stats, binned, lam=1.0)
    assert compared >= 0.9 * int(np.asarray(jm.trees.is_split).sum()), \
        (compared, ties)
    assert len(ties) <= 2 and (gaps.max() if gaps.size else 0) <= 1e-5
    jt, tt = jm.scoring_history[-1], tm.scoring_history[-1]
    assert jt.keys() == tt.keys() == {"ntrees", "train_ndcg@10"}
    assert abs(tt["train_ndcg@10"] - jt["train_ndcg@10"]) <= 1e-6
    assert abs(tm.validation_metrics["ndcg@10"]
               - jm.validation_metrics["ndcg@10"]) <= 1e-6
    perf = tm.model_performance(tf, "rel")
    assert abs(perf["ndcg@10"] - tt["train_ndcg@10"]) <= 1e-6


def test_pairwise_train_learns_and_scores_raw_margins(trained):
    """rank:pairwise (its gradients are held to the reference above)
    raises the training NDCG round by round, and its predictions are
    the raw margins."""
    tf = trained[3]
    m = XGBoost(objective="rank:pairwise", score_every=1, **_KW).train(
        y="rel", training_frame=tf, group_column="qid")
    nd = [h["train_ndcg@10"] for h in m.scoring_history]
    assert len(nd) == _KW["ntrees"] + 1 and nd[-1] > nd[0] > 0.5
    X = m._design_matrix(tf).numpy()
    np.testing.assert_array_equal(m.score_numpy(X), m.predict_raw(tf))


def test_enum_relevance_trains_as_its_codes():
    cols = rank_cols(15, seed=5)
    grades = np.array(["0", "1", "2", "3", "4"])
    ecols = dict(cols, rel=grades[cols["rel"].astype(int)])
    a = XGBoost(objective="rank:ndcg", **_KW).train(
        y="rel", training_frame=Frame.from_arrays(cols, device="cpu"),
        group_column="qid")
    b = XGBoost(objective="rank:ndcg", **_KW).train(
        y="rel", training_frame=Frame.from_arrays(ecols, device="cpu"),
        group_column="qid")
    assert b.nclasses == 1 and b.response_domain is None
    for f in a.trees._fields:
        assert torch.equal(getattr(a.trees, f), getattr(b.trees, f)), f
    assert a.scoring_history == b.scoring_history


def test_rank_refusals():
    cols = rank_cols(5)
    fr = Frame.from_arrays(dict(cols, off=np.zeros_like(cols["rel"])),
                           device="cpu")
    with pytest.raises(ValueError, match="need group_column"):
        XGBoost(objective="rank:ndcg", ntrees=1).train(
            y="rel", training_frame=fr)
    with pytest.raises(ValueError, match="offset_column is not supported"):
        XGBoost(objective="rank:pairwise", ntrees=1).train(
            y="rel", training_frame=fr, group_column="qid",
            offset_column="off")
    # the JAX package's refusal: folds would split query groups
    with pytest.raises(ValueError, match="group-aware folds"):
        XGBoost(objective="rank:ndcg", ntrees=1, nfolds=2).train(
            y="rel", training_frame=fr, group_column="qid")
