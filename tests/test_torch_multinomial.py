"""PyTorch port, multinomial GBM: ``GBM(...).train`` on a 4-class
response (the label of ``tools/bench_suite.py``'s gbm_multinomial
workload) in both packages, on the CPU.

The JAX reference runs on a one-row-shard mesh, the port's layout. The
softmax gradients are float sums, and XLA's exp and cumsum round
differently from torch's in the last bit, so trees agree to f32
rounding, not bitwise, and f32 rounding decides between thresholds
whose gains are tied at its resolution: thresholds on a plateau of
empty bins (the sibling-subtracted histogram's empty bins hold rounding
residuals), and the zero-information splits of a node whose rows all
carry one gradient (round 1, before the margins differ). Held here:
- the split structure (split_feat, split_bin, na_left, is_split) is
  equal from the root down; at a node where it differs, the two
  decisions' float64 gains on the node's rows differ by at most 1e-6
  of the node's G²/H, and that node's subtree is not compared; such
  ties are at most 3, and at least 90% of the reference's nodes are
  compared;
- compared leaf values, train logloss, the probabilities of every row
  no tie routes differently, and the ``model_performance`` metrics
  (same keys) within 1e-5;
- a model trained by the JAX package and carried across as numpy
  arrays scores with BITWISE margins through ``flat_margin``.

The JAX package's CPU histogram adds a bin's rows one after another in
float32; the port's plain version sums them in float64 and rounds each
cell once (``ops/histogram.histogram_plain``, held to float64 sums in
tests/test_torch_histogram.py). The limits above hold the port's own
train. Two more tests hold the same limits on a port train fed the
reference's accumulation (``_f32_running_histogram``, the plain
version's float32 twin), which isolates the grower, split finder,
leaves and boosting loop from the histogram sums.
"""

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import GBM, Frame
from h2o_kubernetes_tpu_torch.models.gbm import gbm_model_from_arrays
from h2o_kubernetes_tpu_torch.models.tree import core as tcore

TOL = 1e-5
K = 4
_KW = dict(ntrees=3, max_depth=4, learn_rate=0.2, seed=1)


def multinomial_cols(rows, seed=3):
    """gbm_multinomial's table (tools/bench_suite.py:248-256): 10 normal
    columns, classes a/b by a score's tails, c/d by a third column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 10)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1]
    y = np.where(score > 0.6, "a", np.where(
        score < -0.6, "b", np.where(X[:, 2] > 0, "c", "d")))
    cols = {f"f{i}": X[:, i] for i in range(10)}
    cols["f3"][::11] = np.nan
    cols["y"] = y
    return cols


def _f32_running_histogram(binned, rel, vals, n_nodes, n_bins):
    """``histogram_plain`` with the JAX package's CPU accumulation: one
    float32 ``index_add_`` per feature, a bin's rows added one after
    another."""
    F, C = binned.shape[0], vals.shape[1]
    seg_node = torch.where(rel >= 0, rel, n_nodes).long() * n_bins
    out = torch.empty((F, n_nodes * n_bins, C), dtype=vals.dtype)
    for f in range(F):
        acc = torch.zeros(((n_nodes + 1) * n_bins, C), dtype=vals.dtype)
        acc.index_add_(0, seg_node + binned[f].long(), vals)
        out[f] = acc[: n_nodes * n_bins]
    return out.reshape(F, n_nodes, n_bins, C).permute(1, 0, 2, 3) \
        .contiguous()


@pytest.fixture(scope="module")
def trained():
    cols = multinomial_cols(4096)
    with use_mesh(make_mesh(n_rows=1)):
        jm = JGBM(**_KW).train(y="y", training_frame=h2o.Frame.from_arrays(
            cols))
    tf = Frame.from_arrays(cols, device="cpu")
    tm = GBM(**_KW).train(y="y", training_frame=tf)
    hold = multinomial_cols(1000, seed=9)
    return jm, tm, _walk(tm, jm, *_round_grads(tm, tf)), cols, hold


@pytest.fixture(scope="module")
def trained_f32(trained):
    """The port trained on the reference's float32 accumulation, and its
    walk against the reference."""
    from h2o_kubernetes_tpu_torch.ops import histogram as hist_op

    jm, _, _, cols, _ = trained
    tf = Frame.from_arrays(cols, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hist_op, "histogram_plain", _f32_running_histogram)
        tm = GBM(**_KW).train(y="y", training_frame=tf)
    return tm, _walk(tm, jm, *_round_grads(tm, tf))


def _round_grads(tm, tf):
    """float64 (g, h) [rounds, K, rows] of every round, from the port's
    own trees, and the [F, rows] codes."""
    from h2o_kubernetes_tpu_torch.models.base import resolve_xy

    binned = tf.binned(tm.bin_spec)
    y = resolve_xy(tf, "y").y.numpy()
    margin = torch.as_tensor(tm.init_score)[None, :].repeat(
        binned.shape[1], 1)
    out = []
    for r in range(_KW["ntrees"]):
        pr = torch.softmax(margin.double(), dim=1).numpy().T
        yk = (y[None, :] == np.arange(K)[:, None]).astype(np.float64)
        out.append((pr - yk, pr * (1.0 - pr)))
        for k in range(K):
            tree = tcore.Tree(*(a[r * K + k] for a in tm.trees))
            margin[:, k] += tcore.predict_tree(tree, binned, 4, 256)
    return out, binned.numpy()


def _gain64(bf, g, h, split, na_left, b):
    """(float64 gain of a node decision on its rows, the node's G²/H)."""
    def term(m):
        return g[m].sum() ** 2 / (h[m].sum() + 1e-10)
    whole = np.ones(bf.shape, dtype=bool)
    if not split:
        return 0.0, term(whole)
    left = np.where(bf == 255, na_left, bf <= b)
    return term(left) + term(~left) - term(whole), term(whole)


def _walk(tm, jm, grads, binned):
    """Walk every tree from the root while the two packages' decisions
    agree. A node where they differ must be a tie at f32 resolution:
    the two decisions' float64 gains on the node's rows differ by at
    most 1e-6 of the node's G²/H (the gain is a difference of terms that
    size, so f32 cannot order them finer); its subtree is not compared.
    Returns (nodes compared, the ties, leaf value gaps of compared
    leaves, rows that passed a tie per tree)."""
    fields = ("is_split", "split_feat", "split_bin", "na_left")
    T = tm.trees.is_split.shape[0]
    tt = {f: getattr(tm.trees, f).numpy() for f in fields + ("value",)}
    jt = {f: np.asarray(getattr(jm.trees, f)) for f in fields + ("value",)}
    compared, ties, leaf_gaps = 0, [], []
    tied_rows = np.zeros(binned.shape[1], dtype=bool)
    for t in range(T):
        g, h = (a[t % K] for a in grads[t // K])
        rows_at = {0: np.ones(binned.shape[1], dtype=bool)}
        for node in range(tt["is_split"].shape[1]):
            if node not in rows_at:
                continue
            rows = rows_at.pop(node)
            dec_t = tuple(tt[f][t, node] for f in fields)
            dec_j = tuple(jt[f][t, node] for f in fields)
            if not dec_t[0] and not dec_j[0]:
                compared += 1
                leaf_gaps.append(abs(tt["value"][t, node]
                                     - jt["value"][t, node]))
                continue
            if dec_t != dec_j:
                gains = [_gain64(binned[max(d[1], 0)][rows], g[rows],
                                 h[rows], d[0], d[3], d[2])
                         for d in (dec_t, dec_j)]
                gap = abs(gains[0][0] - gains[1][0])
                assert gap <= 1e-6 * gains[0][1], (t, node, dec_t, dec_j,
                                                  gains)
                ties.append((t, node))
                tied_rows |= rows
                continue
            compared += 1
            bf = binned[dec_t[1]]
            left = rows & np.where(bf == 255, dec_t[3], bf <= dec_t[2])
            rows_at[2 * node + 1] = left
            rows_at[2 * node + 2] = rows & ~left
    return compared, ties, np.asarray(leaf_gaps), tied_rows


def _assert_structure(jm, tm, walk):
    assert tm.trees.split_feat.shape == (_KW["ntrees"] * K, 31)
    compared, ties, leaf_gaps, _ = walk
    n_ref = int(np.asarray(jm.trees.is_split).sum()) + len(leaf_gaps)
    assert len(ties) <= 3 and compared >= 0.9 * n_ref, (ties, compared,
                                                        n_ref)
    assert leaf_gaps.max() <= TOL


def test_split_structure_equal(trained):
    """Every split equal, or a tie at f32 resolution (see _walk); the
    ties are few and the compared leaves agree within 1e-5."""
    jm, tm, walk, _, _ = trained
    _assert_structure(jm, tm, walk)


def test_split_structure_equal_on_the_reference_accumulation(trained,
                                                             trained_f32):
    """The same limits on the train fed the reference's float32
    histogram sums."""
    jm = trained[0]
    _assert_structure(jm, *trained_f32)


def test_train_logloss_and_priors_close(trained):
    jm, tm, _, _, _ = trained
    # log of the class shares: 1 ulp apart at most
    np.testing.assert_allclose(tm.init_score, np.asarray(jm.init_score),
                               rtol=2 ** -23, atol=0)
    jl = jm.scoring_history[-1]["train_logloss"]
    tl = tm.scoring_history[-1]["train_logloss"]
    assert abs(tl - jl) <= TOL, (tl, jl)


def test_probabilities_and_model_performance_close(trained):
    """Probabilities within 1e-5 on every row no tie routed differently;
    the holdout metrics (the same keys) within 1e-5."""
    jm, tm, walk, cols, hold = trained
    _assert_probabilities(jm, tm, walk, cols, hold)


def test_probabilities_close_on_the_reference_accumulation(trained,
                                                           trained_f32):
    """The same limits on the train fed the reference's float32
    histogram sums."""
    jm, _, _, cols, hold = trained
    tm, walk = trained_f32
    _assert_probabilities(jm, tm, walk, cols, hold)


def _assert_probabilities(jm, tm, walk, cols, hold):
    fr = h2o.Frame.from_arrays(cols)
    X = np.asarray(jm._design_matrix(fr))[: fr.nrows]
    tp = tm.score_numpy(X)
    assert tp.shape == (4096, K)
    tied = walk[3]
    assert tied.mean() <= 0.5
    np.testing.assert_allclose(tp[~tied], jm.score_numpy(X)[~tied], rtol=0,
                               atol=TOL)
    jp = jm.model_performance(h2o.Frame.from_arrays(hold), y="y")
    tpf = tm.model_performance(Frame.from_arrays(hold, device="cpu"),
                               y="y")
    assert set(tpf) == set(jp) == {"logloss", "accuracy",
                                   "mean_per_class_error", "auc"}
    for k in jp:
        assert abs(tpf[k] - jp[k]) <= TOL, (k, tpf[k], jp[k])
    pf = tm.predict(Frame.from_arrays(hold, device="cpu"))
    assert pf.names == ["predict", "pa", "pb", "pc", "pd"]


def test_carried_across_model_scores_bitwise(trained):
    """A JAX-trained 4-class GBM, handed over as numpy arrays (trees
    interleaved class-fastest, [K] class priors), flattens to the same
    serving arrays and scores through flat_margin bitwise."""
    jm, _, _, cols, _ = trained
    spec = jm.bin_spec
    pm = gbm_model_from_arrays(
        {f: np.asarray(getattr(jm.trees, f)) for f in jcore.Tree._fields},
        np.asarray(spec.edges_matrix()), spec.is_enum,
        np.asarray(jm.init_score), jm.feature_names, jm.distribution,
        jm.nclasses, jm.params.max_depth,
        response_domain=jm.response_domain, device="cpu")
    jflat = jm._flat()
    tflat = pm._serving_prepare()[0]
    for name, a, b in zip(jcore.FlatTrees._fields, jflat, tflat):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    fr = h2o.Frame.from_arrays(cols)
    X = np.asarray(jm._design_matrix(fr))[: fr.nrows]
    em = np.asarray(spec.is_enum)
    want = np.asarray(jcore.flat_margin(jflat, X, em, 4, K))
    got = tcore.flat_margin(tflat, torch.as_tensor(X), torch.as_tensor(em),
                            4, K).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(pm.score_numpy(X), jm.score_numpy(X),
                               rtol=0, atol=1e-6)
