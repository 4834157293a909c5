"""PyTorch port, where the training slice's metrics run: on the model's
device. ``model_performance`` (and so ``GBM.train(validation_frame=)``)
hands the metrics the scores and the response as tensors on the model's
device, rows with an NA response dropped there, so on a card the AUC's
4096-bin score histogram is the CUDA kernel's. No JAX here, so the
card-only cases (``-m cuda``) also run where the JAX package is absent.
"""

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch import GBM, Frame, metrics
from h2o_kubernetes_tpu_torch.ops import histogram as H

_KW = dict(ntrees=3, max_depth=3, learn_rate=0.2, seed=1)


def _cols(rows, seed=0, na_every=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    X["c1"] = np.array(list("abcd"))[rng.integers(0, 4, size=rows)]
    logit = 1.2 * X["x0"] - 0.8 * X["x1"] + rng.normal(scale=0.8,
                                                       size=rows)
    X["y"] = np.where(logit > 0, "late", "ontime").astype(object)
    if na_every:
        X["y"][::na_every] = None               # NA responses
    return X


def _host_metrics(model, frame, hold):
    """The binomial metrics recomputed from host copies of the scores
    and of the rows whose response is not NA."""
    ok = np.array([v is not None for v in hold["y"]])
    p1 = model.predict_raw(frame)[ok, 1]
    y = (hold["y"][ok] == model.response_domain[1]).astype(np.float32)
    stats = metrics.binomial_stats(y, p1)
    return {"auc": metrics.roc_auc(y, p1), "logloss": metrics.logloss(y, p1),
            "rmse": metrics.rmse(y, p1)} | {
                k: stats[k] for k in ("pr_auc", "gini", "f1",
                                      "max_f1_threshold",
                                      "mean_per_class_error")}


def test_model_performance_hands_the_metrics_device_tensors(monkeypatch):
    model = GBM(**_KW).train(y="y", training_frame=Frame.from_arrays(
        _cols(3000), device="cpu"))
    hold = _cols(2000, seed=5, na_every=97)
    frame = Frame.from_arrays(hold, device="cpu")
    want = _host_metrics(model, frame, hold)
    seen = []
    for name in ("binomial_auc_and_stats", "logloss", "rmse"):
        def spy(y, s, *a, _fn=getattr(metrics, name), **k):
            seen.append((y, s))
            return _fn(y, s, *a, **k)
        monkeypatch.setattr(metrics, name, spy)
    got = model.model_performance(frame, y="y")
    assert len(seen) == 3
    for y, s in seen:
        assert isinstance(y, torch.Tensor) and isinstance(s, torch.Tensor)
        assert y.device == s.device == model.device
        assert y.shape == s.shape == (2000 - 21,)     # 21 NA responses
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-7, (k, got[k], want[k])


def test_validation_frame_is_scored_like_model_performance():
    hold = _cols(1500, seed=6, na_every=50)
    model = GBM(**_KW).train(
        y="y", training_frame=Frame.from_arrays(_cols(3000), device="cpu"),
        validation_frame=Frame.from_arrays(hold, device="cpu"))
    assert model.validation_metrics == model.model_performance(
        Frame.from_arrays(hold, device="cpu"), y="y")


@pytest.mark.cuda
def test_model_performance_on_card_launches_the_histogram_kernel():
    """Past 65,536 rows the AUC takes its histogram path: one launch of
    the kernel (1 node x 4096 int16 bins, in the regime its plan picks),
    which the threshold table shares, no other launch; the metrics agree
    with the host recomputation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    model = GBM(**_KW).train(y="y", training_frame=Frame.from_arrays(
        _cols(5000), device="cuda"))
    assert model.device.type == "cuda"
    hold = _cols(70_000, seed=7, na_every=97)
    frame = Frame.from_arrays(hold, device="cuda")
    before = dict(H.LAUNCHES)
    got = model.model_performance(frame, y="y")
    regime = H.hist_mode(1, 1, 1, 4096, 3, code_bytes=2)
    assert H.LAUNCHES == {**before, regime: before[regime] + 1}
    want = _host_metrics(model, frame, hold)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    before = dict(H.LAUNCHES)
    GBM(**_KW).train(y="y", training_frame=Frame.from_arrays(
        _cols(5000), device="cuda"), validation_frame=frame)
    # 3 trees x 3 levels, the train AUC's exact path (5,000 rows), and
    # the validation AUC's histogram
    assert sum(H.LAUNCHES.values()) == sum(before.values()) + 3 * 3 + 1


@pytest.mark.cuda
def test_xgboost_and_glm_train_on_the_card_by_default():
    """XGBoost (pointwise and rank:ndcg) and GLM train where the frame
    lives, the card by default: the trees' levels launch the histogram
    kernel (3 per depth-3 tree, no AUC launch at 5,000 rows), and the
    results agree with the CPU's (train metrics within 1e-4, GLM
    coefficients within 1e-4 of the largest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from h2o_kubernetes_tpu_torch import GLM, XGBoost

    cols = _cols(5000)
    cols["q"] = np.repeat(np.arange(100), 50).astype(np.float32)
    cols["rel"] = np.clip(np.round(cols["x0"] + 1.5), 0, 4
                          ).astype(np.float32)
    card, cpu = Frame.from_arrays(cols), Frame.from_arrays(cols, device="cpu")
    assert card.device.type == "cuda"
    kw = dict(ntrees=3, max_depth=3, seed=1)
    for obj, y, extra in (("binary:logistic", "y", {}),
                          ("rank:ndcg", "rel", {"group_column": "q"})):
        ign = [c for c in ("y", "rel", "q") if c != y and c not in
               extra.values()]
        before = sum(H.LAUNCHES.values())
        m = XGBoost(objective=obj, **kw).train(
            y=y, training_frame=card, ignored_columns=ign, **extra)
        assert m.device.type == "cuda"
        assert sum(H.LAUNCHES.values()) - before == 3 * 3
        c = XGBoost(objective=obj, **kw).train(
            y=y, training_frame=cpu, ignored_columns=ign, **extra)
        for k, v in c.scoring_history[-1].items():
            assert abs(m.scoring_history[-1][k] - v) <= 1e-4, (obj, k)
    ign = ["rel", "q"]
    g_card = GLM(family="binomial").train(y="y", training_frame=card,
                                          ignored_columns=ign)
    g_cpu = GLM(family="binomial").train(y="y", training_frame=cpu,
                                         ignored_columns=ign)
    assert g_card.device.type == "cuda"
    b, want = g_card.beta.cpu().numpy(), g_cpu.beta.numpy()
    np.testing.assert_allclose(b, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    hold = Frame.from_arrays(_cols(70_000, seed=7), device="cuda")
    before = dict(H.LAUNCHES)
    perf = g_card.model_performance(hold, y="y")
    assert sum(H.LAUNCHES.values()) == sum(before.values()) + 1
    assert 0.5 < perf["auc"] <= 1.0


def _exact_cols(rows=4096, seed=11):
    """A dense column, two one-hot groups of 8 (bundled under EFB) and
    y in {0, 1}, exactly half ones: one gaussian round's sums are
    exact, so its tree is bitwise the same on the card and the CPU."""
    rng = np.random.default_rng(seed)
    cols = {"d0": rng.normal(size=rows).astype(np.float32)}
    for g in range(2):
        cat = rng.integers(0, 8, size=rows)
        for k in range(8):
            cols[f"g{g}_{k}"] = (cat == k).astype(np.float32)
    y = np.zeros(rows, dtype=np.float32)
    y[rng.permutation(rows)[: rows // 2]] = 1.0
    cols["y"] = y
    return cols


_KNOBS = {
    "efb": {"H2O_TPU_EFB": "1"},
    "goss": {"H2O_TPU_GOSS": "1", "H2O_TPU_GOSS_TOP_A": "0.5",
             "H2O_TPU_GOSS_RAND_B": "0.25"},
    "ooc": {"H2O_TPU_OOC": "1", "H2O_TPU_OOC_CHUNK_ROWS": "1024"},
    "efb_ooc": {"H2O_TPU_EFB": "1", "H2O_TPU_OOC": "1",
                "H2O_TPU_OOC_CHUNK_ROWS": "1024"},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_KNOBS))
def test_efb_goss_ooc_train_on_the_card(monkeypatch, case):
    """EFB, GOSS and out-of-core boosting train on the card through the
    histogram kernel: one gaussian round on a dyadic response (exact
    sums) bitwise the CPU's tree, and three bernoulli rounds with train
    AUC and logloss within 1e-4 of the CPU's. Out-of-core streams its
    chunks from pinned memory (upload time and rate recorded)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for k, v in _KNOBS[case].items():
        monkeypatch.setenv(k, v)
    cols = _exact_cols()
    card, cpu = Frame.from_arrays(cols), Frame.from_arrays(cols, device="cpu")
    kw = dict(ntrees=1, max_depth=4, distribution="gaussian", seed=3,
              min_rows=4.0)
    before = sum(H.LAUNCHES.values())
    m = GBM(**kw).train(y="y", training_frame=card)
    c = GBM(**kw).train(y="y", training_frame=cpu)
    assert m.device.type == "cuda" and sum(H.LAUNCHES.values()) > before
    isp = c.trees.is_split
    for f in ("split_feat", "split_bin", "na_left"):
        assert torch.equal(getattr(m.trees, f).cpu()[isp],
                           getattr(c.trees, f)[isp]), f
    for f in ("is_split", "value", "gain", "cover"):
        assert torch.equal(getattr(m.trees, f).cpu(), getattr(c.trees, f)), f
    if "ooc" in case:
        st = m.ooc_stats
        assert st["streamed"] and st["chunks"] == 4
        assert st["upload_ms"] > 0 and st["upload_gb_per_s"] > 0
        assert 0.0 <= st["overlap_ratio"] <= 1.0
    bern = dict(ntrees=3, max_depth=3, learn_rate=0.2, seed=1)
    cols = _cols(5000)
    m = GBM(**bern).train(y="y", training_frame=Frame.from_arrays(cols))
    c = GBM(**bern).train(y="y", training_frame=Frame.from_arrays(
        cols, device="cpu"))
    for k, v in c.scoring_history[-1].items():
        assert abs(m.scoring_history[-1][k] - v) <= 1e-4, (case, k)


@pytest.mark.cuda
def test_deeplearning_and_word2vec_train_on_the_card_by_default():
    """DeepLearning and Word2Vec train where the frame lives, the card
    by default, with the JAX package's draws: the DL init is bitwise the
    CPU's, the trains agree with the CPU's (DL train metrics within
    1e-4 and the weights within 1e-4 of each layer's largest; W2V
    embeddings within 1e-4 of the largest, the card's scatter adds in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from h2o_kubernetes_tpu_torch import DeepLearning, Word2Vec

    cols = _cols(4000)
    card, cpu = Frame.from_arrays(cols), Frame.from_arrays(cols, device="cpu")
    kw = dict(hidden=(16, 16), epochs=2, seed=1)
    m = DeepLearning(**kw).train(y="y", training_frame=card)
    c = DeepLearning(**kw).train(y="y", training_frame=cpu)
    assert m.device.type == "cuda"
    for k, v in c.scoring_history[-1].items():
        assert abs(m.scoring_history[-1][k] - v) <= 1e-4, k
    for a, b in zip(m.net_numpy(), c.net_numpy()):
        assert np.abs(a["w"] - b["w"]).max() <= 1e-4 * np.abs(b["w"]).max()
    rng = np.random.default_rng(3)
    toks = np.array([f"w{i}" for i in rng.zipf(1.3, 20_000) % 400],
                    dtype=object)
    toks[::15] = None
    wk = dict(vec_size=16, epochs=1, min_word_freq=2, seed=1)
    a = Word2Vec(**wk).train(Frame.from_arrays({"t": toks}))
    b = Word2Vec(**wk).train(Frame.from_arrays({"t": toks}, device="cpu"))
    assert a.vocab == b.vocab
    assert np.abs(a.W - b.W).max() <= 1e-4 * np.abs(b.W).max()


@pytest.mark.cuda
def test_import_file_and_group_by_on_the_card(tmp_path):
    """import_file puts the frame on the card by default, equal to the
    CPU's bitwise; a group_by there gives the CPU's keys, counts, min and
    max bitwise and its sums within 1e-6 of each group's Σ|x| (float
    atomics add in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from h2o_kubernetes_tpu_torch import import_file

    rng = np.random.default_rng(3)
    n = 20_000
    p = tmp_path / "d.csv"
    with open(p, "w") as f:
        f.write("g,x,t\n")
        for i in range(n):
            f.write(f"{'abc'[rng.integers(0, 3)]},"
                    f"{'' if i % 31 == 0 else round(rng.normal(), 5)},"
                    f"2020-01-{1 + i % 28:02d} 10:00:{i % 60:02d}\n")
    card, cpu = import_file(str(p)), import_file(str(p), device="cpu")
    assert card.device.type == "cuda"
    for name in cpu.names:
        a, b = card[name], cpu[name]
        assert (a.kind, a.domain, a.origin) == (b.kind, b.domain, b.origin)
        assert torch.equal(a.data.cpu().view(torch.int32),
                           b.data.view(torch.int32))
    go = [f.group_by("g").sum("x").min("x").max("t").count().get_frame()
          for f in (card, cpu)]
    assert go[0].device.type == "cuda"
    for name in ("g", "nrow", "min_x", "max_t"):
        assert np.array_equal(go[0][name].to_numpy(), go[1][name].to_numpy(),
                              equal_nan=True), name
    x = cpu["x"].to_numpy().astype(np.float64)
    codes = cpu["g"].to_numpy()
    scale = np.array([np.nansum(np.abs(x[codes == g])) for g in range(3)])
    gap = np.abs(go[0]["sum_x"].to_numpy().astype(np.float64)
                 - go[1]["sum_x"].to_numpy())
    assert (gap <= 1e-6 * scale).all(), gap


@pytest.mark.cuda
def test_cross_validation_and_automl_on_the_card():
    """A cross-validated GBM and a small AutoML on the card against the
    same runs on the CPU: fold ids bitwise, the holdout predictions stay
    on the card (70,000 rows: their AUC histograms launch the kernel)
    and agree with the CPU's within 1e-4; the leaderboards hold the
    same ids and GLM_1's AUC within 1e-4 (GBM_1's 50 rounds at
    ``min_rows=1`` on 2,000-row folds pass f32 near-ties that the two
    devices decide apart, as chip_smoke.py phase 27 reports)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from h2o_kubernetes_tpu_torch import AutoML

    cols = _cols(70_000, seed=3)
    card = Frame.from_arrays(cols)
    cpu = Frame.from_arrays(cols, device="cpu")
    kw = dict(_KW, nfolds=3, fold_assignment="modulo")
    before = sum(H.LAUNCHES.values())
    mc = GBM(**kw).train(y="y", training_frame=card)
    assert sum(H.LAUNCHES.values()) > before
    mh = GBM(**kw).train(y="y", training_frame=cpu)
    assert mc.cv.holdout_predictions.device.type == "cuda"
    np.testing.assert_array_equal(mc.cv.fold_ids, mh.cv.fold_ids)
    np.testing.assert_allclose(mc.cross_validation_holdout_predictions(),
                               mh.cross_validation_holdout_predictions(),
                               rtol=0, atol=1e-4)
    for k, v in mh.cv.metrics.items():
        assert abs(mc.cv.metrics[k] - v) <= 1e-4, k
    small = _cols(3000, seed=4)
    runs = [AutoML(max_models=2, nfolds=3, seed=1, verbosity=None,
                   include_algos=["glm", "gbm", "stackedensemble"]).train(
        y="y", training_frame=Frame.from_arrays(small, device=d))
        for d in ("cuda", "cpu")]
    rows = [{r["model_id"]: r["auc"] for r in a.leaderboard.as_list()}
            for a in runs]
    assert set(rows[0]) == set(rows[1]) and len(rows[0]) == 4
    glm = "GLM_1_AutoML_automl"
    assert abs(rows[0][glm] - rows[1][glm]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kmeans", "pca", "glrm", "naivebayes",
                                  "isolationforest", "coxph", "aggregator",
                                  "targetencoder"])
def test_other_learners_train_on_the_card(name):
    """Each of the eight other learners trained on the card against the
    same train on the CPU at 20,000 rows of chip_smoke.py phase 28's
    tables, at the parity tests' tolerances (``tools/torch_learners.
    compare``: k-means seeding and the trees of an isolation forest
    bitwise, GLRM's initial factors bitwise, PCA's eigenvalues within
    1e-5, ...), and the card model's artifact in ``MojoModel`` within
    1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tools import torch_learners as L

    tables = L.arrays(20_000)
    fc, fh = L.frames(tables, "cuda"), L.frames(tables, "cpu")
    (mc, tc), (mh, th) = L.train(name, fc), L.train(name, fh)
    if hasattr(mc, "device"):
        assert mc.device.type == "cuda"
    res = L.compare(name, mc, mh, fc, fh, tc, th)
    assert res["ok"], res
    if name != "aggregator":
        assert L.artifact_gap(name, mc, fc, 5000) <= 1e-6
