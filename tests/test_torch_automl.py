"""PyTorch port, AutoML (``automl.py``), stacked ensembles
(``models/stackedensemble.py``) and the model files AutoML's
``checkpoint_dir`` keeps (``persist.py``), against the JAX package's on
the CPU.

The reference runs its serial path (``H2O_TPU_AUTOML_PIPELINE=0``, set
for the reference side only) on a one-row-shard mesh; the port runs
pipelined, its only path. At 600 rows with ``nfolds=3``,
``include_algos=["glm", "gbm", "stackedensemble"]`` and
``max_models=2``: the same model ids in the same order (adjacent rows
whose sort metrics lie within 1e-4 may swap), both ensembles present,
GLM_1's metrics within 1e-4 (``training_time_s`` aside). GBM_1 (50
trees of depth 6 at ``min_rows=1`` on 400-row folds) meets f32
near-ties in its first tree, whose leaves then move the margins every
later round grows from, so its holdout predictions are not the
reference's row for row. Its main and fold models are walked against
the reference's (``tools/torch_tree_parity.walk``, C2's near-tie
contract): every decision that differs before and in the first tree
with a tie is a float64 near-tie, and every leaf compared there is
within 1e-4 of the reference's. Its row and the ensembles' are also
held on identical inputs: the port's metric dispatch on the
reference's GBM_1 holdout predictions gives the reference's row within
1e-4, and a port ensemble stacked on the reference's two base models'
holdout predictions (the same fold ids) gives the reference's ensemble
rows within 1e-4; the port's own rows are its dispatch on its own
holdout predictions and its metalearner's CV. Also held: the
``Leaderboard``'s ordering, the ensemble's refusals, include/exclude
exclusivity, a ``checkpoint_dir`` resume after a fault injected at
``automl.step`` (the rerun trains only the missing step and the
leaderboard equals the uninterrupted one), the ``event_log``, the
scheduler's stats, and GLM, DeepLearning and ensemble model files
both ways (save, load, the same predictions and CV state).
"""

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import automl as jautoml
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
import h2o_kubernetes_tpu_torch as port
from h2o_kubernetes_tpu_torch import automl as tautoml
from h2o_kubernetes_tpu_torch.runtime import faults, health

_MESH1 = make_mesh(n_rows=1)
TOL = 1e-4
N = 600
_AML = dict(max_models=2, nfolds=3, seed=1, verbosity=None,
            include_algos=["glm", "gbm", "stackedensemble"])


def aml_cols(rows=N, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    X["c"] = np.array(list("abc"))[rng.integers(0, 3, rows)]
    s = X["x0"] - 0.6 * X["x1"] + 0.3 * (X["c"] == "b") \
        + 0.5 * rng.normal(size=rows)
    X["y"] = np.where(s > 0, "late", "ontime")
    return X


@pytest.fixture(scope="module")
def cols():
    return aml_cols()


@pytest.fixture(scope="module")
def runs(cols):
    mp = pytest.MonkeyPatch()
    mp.setenv("H2O_TPU_AUTOML_PIPELINE", "0")
    try:
        with use_mesh(_MESH1):
            ja = jautoml.AutoML(**_AML).train(
                y="y", training_frame=h2o.Frame.from_arrays(cols))
    finally:
        mp.undo()
    ta = port.AutoML(**_AML).train(
        y="y", training_frame=port.Frame.from_arrays(cols, device="cpu"))
    return ja, ta


def _rows(aml):
    return [{k: v for k, v in r.items() if k != "training_time_s"}
            for r in aml.leaderboard.as_list()]


def _same_board(got, want, metric, exact=()):
    """Same ids in the same order up to swaps of adjacent rows whose sort
    metrics lie within TOL; the metrics of the ids in ``exact`` within
    TOL."""
    assert len(got) == len(want)
    ids_g = [r["model_id"] for r in got]
    ids_w = [r["model_id"] for r in want]
    for i, (a, b) in enumerate(zip(ids_g, ids_w)):
        if a != b:
            j = ids_w.index(a)
            assert abs(j - i) == 1 and abs(
                want[i][metric] - want[j][metric]) <= TOL, (ids_g, ids_w)
    by_id = {r["model_id"]: r for r in want}
    for r in got:
        if r["model_id"] not in exact:
            continue
        w = by_id[r["model_id"]]
        assert set(r) == set(w)
        for k in w:
            if k != "model_id":
                assert abs(r[k] - w[k]) <= TOL, (r["model_id"], k, r[k],
                                                 w[k])


class _Carried:
    """A reference base model as the port's StackedEnsemble reads it."""

    def __init__(self, jm):
        from h2o_kubernetes_tpu_torch.models.cv import CVResult

        self.algo, self.nclasses = jm.algo, jm.nclasses
        self.feature_names = list(jm.feature_names)
        self.cv = CVResult(np.asarray(jm.cv.fold_ids), None, torch.as_tensor(
            np.asarray(jm.cv.holdout_predictions)), {}, {})


def test_leaderboard_matches_the_reference_serial_run(runs, cols):
    from h2o_kubernetes_tpu_torch.models.base import score_predictions

    ja, ta = runs
    assert ta.leaderboard.sort_metric == ja.leaderboard.sort_metric == "auc"
    got, want = _rows(ta), _rows(ja)
    _same_board(got, want, "auc", exact={"GLM_1_AutoML_automl"})
    fr = port.Frame.from_arrays(cols, device="cpu")
    yt = fr.vec("y").as_float()
    jw = {r["model_id"]: r for r in want}
    tw = {r["model_id"]: r for r in got}
    gid = "GBM_1_AutoML_automl"
    jg, tg = ja.leaderboard.models[gid], ta.leaderboard.models[gid]
    np.testing.assert_array_equal(tg.cv.fold_ids, jg.cv.fold_ids)
    on_ref = score_predictions(2, "bernoulli", yt, torch.as_tensor(
        np.asarray(jg.cv.holdout_predictions)))
    _same_board([{"model_id": gid, **on_ref}], [jw[gid]], "auc",
                exact={gid})
    assert score_predictions(2, "bernoulli", yt,
                             tg.cv.holdout_predictions) == \
        {k: v for k, v in tw[gid].items() if k != "model_id"}
    base = [ja.leaderboard.models[m] for m in
            ("GLM_1_AutoML_automl", gid)]
    se = port.StackedEnsemble([_Carried(m) for m in base],
                              metalearner_nfolds=3).train(
        y="y", training_frame=fr)
    for tag in ("BestOfFamily", "AllModels"):
        sid = f"StackedEnsemble_{tag}_AutoML_automl"
        _same_board([{"model_id": sid, **se.cv.metrics}], [jw[sid]], "auc",
                    exact={sid})
        mine = ta.leaderboard.models[sid]
        assert {k: v for k, v in tw[sid].items() if k != "model_id"} == \
            mine.metalearner.cv.metrics
    ids = [r["model_id"] for r in got]
    assert "StackedEnsemble_BestOfFamily_AutoML_automl" in ids
    assert "StackedEnsemble_AllModels_AutoML_automl" in ids
    assert ta.job.status == "DONE" and ta.job.progress == 1.0
    assert {"dest": "automl", "description": "AutoML", "status": "DONE",
            "progress": 1.0, "msg": ""} in port.jobs()
    st = ta.scheduler_stats
    assert st["device_steps"] == 2 and st["host_applied"] == 2
    assert 0.0 <= st["host_busy_s"] <= st["wall_s"]
    assert st["device_busy_s"] <= st["wall_s"]


def test_gbm_fold_models_match_the_reference_up_to_near_ties(runs, cols):
    """GBM_1's main model and each fold model against the reference's,
    walked from the root up to the first tree with a near-tie: every
    differing decision a float64 near-tie (``walk`` asserts it), every
    compared leaf within TOL of the tree's largest |leaf|."""
    from tools.torch_tree_parity import round_stats, walk

    ja, ta = runs
    gid = "GBM_1_AutoML_automl"
    jg, tg = ja.leaderboard.models[gid], ta.leaderboard.models[gid]
    fr = port.Frame.from_arrays(cols, device="cpu")
    folds = tg.cv.fold_ids
    pairs = [(tg, jg, fr)] + [
        (a, b, fr.select_rows(folds != k))
        for k, (a, b) in enumerate(zip(tg.cv.models, jg.cv.models))]
    assert len(pairs) == 4
    for tm, jm, tf in pairs:
        stats, binned = round_stats(tm, tf, "y", {})
        compared, ties, gaps = walk(tm, jm, stats, binned, until_tie=True)
        assert compared > 0 and gaps.size and gaps.max() <= TOL, (
            compared, ties, gaps.max())


def test_leader_predicts_and_event_log(runs, cols):
    _, ta = runs
    assert ta.leader is ta.leaderboard.models[
        ta.leaderboard.rows[0]["model_id"]]
    pf = ta.predict(port.Frame.from_arrays(cols, device="cpu"))
    assert pf.names == ["predict", "plate", "pontime"] and pf.nrows == N
    msgs = [m for _, m in ta.event_log]
    assert msgs[0].startswith("GLM_1_AutoML_automl: auc=")
    assert msgs[1].startswith("GBM_1_AutoML_automl: auc=")
    assert any(m.startswith("StackedEnsemble_AllModels: auc=")
               for m in msgs)
    assert msgs[-2].startswith("pipeline: device_busy=")
    assert msgs[-1].startswith("done in ")


def test_leaderboard_orders_by_its_metric():
    lb = tautoml.Leaderboard("auc", ascending=False)
    for mid, auc in (("a", 0.7), ("b", 0.9), ("c", 0.8)):
        lb.add(mid, object(), {"auc": auc})
    assert [r["model_id"] for r in lb.as_list()] == ["b", "c", "a"]
    lb2 = tautoml.Leaderboard("rmse", ascending=True)
    for mid, v in (("a", 2.0), ("b", 1.0)):
        lb2.add(mid, object(), {"rmse": v})
    assert lb2.rows[0]["model_id"] == "b" and "b" in repr(lb2)
    assert repr(tautoml.Leaderboard("auc", False)) == "Leaderboard(empty)"


def test_include_exclude_are_exclusive():
    for mod in (jautoml, tautoml):
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.AutoML(include_algos=["gbm"], exclude_algos=["glm"])
    assert port.AutoML(exclude_algos=["deeplearning"]).algos == {
        "glm", "drf", "gbm", "xgboost", "stackedensemble"}


def test_stacked_ensemble_refusals(runs, cols):
    _, ta = runs
    fr = port.Frame.from_arrays(cols, device="cpu")
    base = [m for m in ta.leaderboard.models.values()
            if m.algo in ("glm", "gbm")]
    no_cv = port.GLM(family="binomial").train(y="y", training_frame=fr)
    with pytest.raises(ValueError, match="was not trained with nfolds"):
        port.StackedEnsemble([base[0], no_cv]).train(y="y",
                                                     training_frame=fr)
    other = port.GLM(family="binomial", nfolds=3, seed=1).train(
        y="y", training_frame=fr)             # random folds, not modulo
    with pytest.raises(ValueError, match="different fold assignment"):
        port.StackedEnsemble([base[0], other]).train(y="y",
                                                     training_frame=fr)
    with pytest.raises(ValueError, match="different frame"):
        port.StackedEnsemble(base).train(
            y="y", training_frame=fr.select_rows(np.arange(N - 3)))
    with pytest.raises(ValueError, match="unknown metalearner"):
        port.StackedEnsemble(base, metalearner_algorithm="svm").train(
            y="y", training_frame=fr)
    with pytest.raises(ValueError, match="non-empty"):
        port.StackedEnsemble([])
    se = port.StackedEnsemble(base, metalearner_algorithm="gbm",
                              metalearner_params={"ntrees": 2}).train(
        y="y", training_frame=fr)
    assert se.cv is None and se.base_tags == ["glm", "gbm"]
    assert se.predict_raw(fr).shape == (N, 2)


def test_checkpoint_resume_after_an_injected_fault(runs, cols, tmp_path):
    """The second step's fault ends the run; the first step's model file
    and manifest line are written, and a rerun with the same directory
    reloads it, trains only the second, and ends with the uninterrupted
    run's leaderboard."""
    _, ta = runs
    fr = port.Frame.from_arrays(cols, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    try:
        with faults.inject("automl.step:device_error@1"):
            a1 = port.AutoML(**_AML, checkpoint_dir=ckpt)
            with pytest.raises(health.ClusterHealthError,
                               match="node died during GBM_1"):
                a1.train(y="y", training_frame=fr)
        assert a1.job.status == "FAILED"
        assert [r["model_id"] for r in a1.leaderboard.as_list()] == \
            ["GLM_1_AutoML_automl"]
    finally:
        health.reset()
    calls = []
    orig = port.GBM.train

    def spy(self, *a, **k):
        calls.append(type(self).__name__)
        return orig(self, *a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port.GBM, "train", spy)
        a2 = port.AutoML(**_AML, checkpoint_dir=ckpt).train(
            y="y", training_frame=fr)
    assert calls == ["GBM"] + ["GBM"] * 3       # the final fit, 3 folds
    assert ("GLM_1_AutoML_automl: resumed from checkpoint"
            in [m for _, m in a2.event_log])
    assert _rows(a2) == _rows(ta)


@pytest.mark.parametrize("algo", ["glm", "deeplearning",
                                  "stackedensemble"])
def test_model_files_both_ways(runs, cols, tmp_path, algo):
    _, ta = runs
    fr = port.Frame.from_arrays(cols, device="cpu")
    if algo == "glm":
        m = ta.leaderboard.models["GLM_1_AutoML_automl"]
    elif algo == "deeplearning":
        m = port.DeepLearning(hidden=(4,), epochs=1, seed=2, nfolds=3,
                              fold_assignment="modulo").train(
            y="y", training_frame=fr)
    else:
        m = ta.leaderboard.models[
            "StackedEnsemble_AllModels_AutoML_automl"]
    back = port.load_model(port.save_model(m, str(tmp_path / algo)),
                           device="cpu")
    assert type(back) is type(m)
    np.testing.assert_array_equal(back.predict_raw(fr), m.predict_raw(fr))
    assert back.cv.metrics == m.cv.metrics
    assert back.cv.metrics_summary == m.cv.metrics_summary
    np.testing.assert_array_equal(back.cv.fold_ids, m.cv.fold_ids)
    assert torch.equal(back.cv.holdout_predictions,
                       m.cv.holdout_predictions)
    if algo != "stackedensemble":
        assert back.scoring_history == m.scoring_history
        assert len(back.cv.models) == len(m.cv.models) == 3
        np.testing.assert_array_equal(back.cv.models[1].predict_raw(fr),
                                      m.cv.models[1].predict_raw(fr))
    else:
        assert back.base_tags == m.base_tags


def test_estimator_names_and_the_ensemble_artifact(runs, cols):
    """h2o-py's names map to the port's learners (the item-12 learners'
    raise, naming their item); an ensemble's artifact nests its base
    models' and metalearner's and scores with numpy as the model does."""
    import io

    from h2o_kubernetes_tpu_torch import estimators as E
    from h2o_kubernetes_tpu_torch import export_mojo, MojoModel

    assert E.H2OAutoML is port.AutoML and E.H2OGradientBoostingEstimator \
        is port.GBM and E.H2OStackedEnsembleEstimator is \
        port.StackedEnsemble
    with pytest.raises(NotImplementedError, match="item 12"):
        E.H2OKMeansEstimator(k=3)
    _, ta = runs
    se = ta.leaderboard.models["StackedEnsemble_AllModels_AutoML_automl"]
    buf = io.BytesIO()
    export_mojo(se, buf)
    mm = MojoModel(io.BytesIO(buf.getvalue()))
    fr = port.Frame.from_arrays(cols, device="cpu")
    np.testing.assert_allclose(mm.predict(fr), se.predict_raw(fr),
                               rtol=0, atol=1e-5)
