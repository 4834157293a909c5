"""N-fold cross-validation shared by every supervised estimator.

An estimator built with ``nfolds=`` (or ``fold_column=``) trains its
main model, then one model per fold on the out-of-fold rows, each
predicting its fold's rows; the holdout predictions are scored together
(the combined CV metrics) and fold by fold (``metrics_summary``: mean
and standard deviation per metric), and they are what a stacked
ensemble's metalearner trains on.

- Fold assignment: ``fold_assignment`` auto (random), random, modulo or
  stratified, drawn with numpy exactly as the JAX package draws them,
  or an explicit ``fold_column``.
- Each fold trains on ``frame.select_rows(~hold)`` (a gather on the
  frame's device) and predicts ``frame.select_rows(hold)``. The JAX
  package's shape-shared mode, which trains every fold on the whole
  frame with the holdout rows' weights zeroed (so global binning sees
  the holdout rows: a different result), runs when
  ``H2O_TPU_CV_SHAPE_SHARE_ROWS=N`` is set and the frame has at most N
  rows.
- The fold loop is pipelined (``runtime/scheduler.HostStream``): the
  main thread trains fold k+1 while one worker scatters fold k's
  holdout predictions into the [n, ...] result and scores them. The
  worker's launches go to the same default CUDA stream as the main
  thread's, so they are ordered after the work already queued; every
  fold's metrics are a function of its predictions alone, so the
  result equals a serial loop's.
- ``CVResult.holdout_predictions`` stays on the frame's device, so a
  stacked ensemble builds its level-one frame there;
  ``Model.cross_validation_holdout_predictions()`` returns numpy.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..frame import Frame, Vec

__all__ = ["CVArgs", "CVResult", "fold_ids", "cross_validate",
           "finalize_train"]

_CV_KEYS = ("nfolds", "fold_assignment", "fold_column",
            "keep_cross_validation_predictions",
            "keep_cross_validation_models")
_MASK_COL = "_cv_mask_w_"


@dataclass
class CVArgs:
    """CV knobs popped off an estimator's keyword arguments."""

    nfolds: int = 0
    fold_assignment: str = "auto"     # auto | random | modulo | stratified
    fold_column: str | None = None
    keep_cross_validation_predictions: bool = True
    keep_cross_validation_models: bool = True

    @classmethod
    def pop(cls, kw: dict) -> "CVArgs":
        out = cls(**{k: kw.pop(k) for k in _CV_KEYS if k in kw})
        if out.fold_assignment.lower() not in (
                "auto", "random", "modulo", "stratified"):
            raise ValueError(
                f"unknown fold_assignment '{out.fold_assignment}'")
        return out

    @property
    def enabled(self) -> bool:
        return self.nfolds >= 2 or self.fold_column is not None


@dataclass
class CVResult:
    """A model's cross-validation: ``fold_ids`` numpy [n];
    ``holdout_predictions`` [n, K] probabilities or [n] predictions on
    the frame's device."""

    fold_ids: np.ndarray
    models: list | None
    holdout_predictions: torch.Tensor | None
    metrics: dict[str, float]                     # combined holdout
    metrics_summary: dict[str, dict[str, float]]  # per metric mean/std
    fold_metrics: list[dict[str, float]] = field(default_factory=list)


def fold_ids(n: int, nfolds: int, scheme: str = "auto",
             y: np.ndarray | None = None, seed: int = 0) -> np.ndarray:
    """Per-row fold index in [0, nfolds) under an assignment scheme,
    drawn with numpy as the JAX package draws it."""
    scheme = scheme.lower()
    if scheme == "modulo":
        return (np.arange(n) % nfolds).astype(np.int32)
    rng = np.random.default_rng(seed if seed >= 0 else None)
    if scheme in ("auto", "random"):
        return rng.integers(0, nfolds, size=n).astype(np.int32)
    if scheme == "stratified":
        if y is None:
            raise ValueError("stratified fold assignment needs a "
                             "categorical response")
        out = np.empty(n, dtype=np.int32)
        start = 0
        for cls_val in np.unique(y):
            idx = np.flatnonzero(y == cls_val)
            rng.shuffle(idx)
            # round-robin within the class, the starting fold rotating
            # across classes so small classes do not all land in fold 0
            out[idx] = (np.arange(len(idx)) + start) % nfolds
            start += len(idx)
        return out
    raise ValueError(f"unknown fold_assignment '{scheme}'")


def _combined_metrics(model, y_true, preds) -> dict[str, float]:
    """Metrics of holdout predictions against ``y_true`` (float, NaN
    for an NA response), on the predictions' device."""
    from .base import score_predictions

    ok = ~torch.isnan(y_true)
    return score_predictions(model.nclasses, model.distribution,
                             y_true[ok], preds[ok])


def _fold_map(frame: Frame, y: str, cv: CVArgs, seed: int):
    """(fold ids numpy [n], nfolds) after the JAX package's checks."""
    n = frame.nrows
    yv = frame.vec(y)
    if cv.fold_column is not None:
        fv = frame.vec(cv.fold_column)
        fc = fv.to_numpy()
        has_na = (fc < 0).any() if fv.is_enum() else \
            np.isnan(np.asarray(fc, dtype=np.float64)).any()
        if has_na:
            raise ValueError(f"fold_column '{cv.fold_column}' has NAs")
        codes = np.unique(fc)
        folds = np.searchsorted(codes, fc).astype(np.int32)
        nfolds = len(codes)
        if nfolds < 2:
            raise ValueError("fold_column must define >= 2 folds")
    else:
        nfolds = cv.nfolds
        if nfolds > n:
            raise ValueError(f"nfolds={nfolds} > {n} rows")
        scheme = cv.fold_assignment.lower()
        if scheme == "auto":
            scheme = "random"
        if scheme == "stratified" and not yv.is_enum():
            raise ValueError("stratified folds need a categorical response")
        folds = fold_ids(n, nfolds, scheme,
                         yv.to_numpy() if yv.is_enum() else None, seed)
    counts = np.bincount(folds, minlength=nfolds)
    if (counts == 0).any():
        raise ValueError(
            f"fold assignment left fold(s) "
            f"{np.flatnonzero(counts == 0).tolist()} empty "
            f"(nfolds={nfolds}, nrows={n})")
    return folds, nfolds


def _shape_share(n: int, frame: Frame) -> bool:
    """The shape-shared mode: on only under H2O_TPU_CV_SHAPE_SHARE_ROWS
    (the frame has at most that many rows), never when the mask
    column's name is taken."""
    env = os.environ.get("H2O_TPU_CV_SHAPE_SHARE_ROWS")
    return env is not None and n <= int(env) and \
        _MASK_COL not in frame.names


def cross_validate(est, y: str, frame: Frame, cv: CVArgs,
                   train_kw: dict[str, Any], seed: int = 0) -> CVResult:
    """Train one model per fold (a deep copy of ``est`` with CV off)
    and score its holdout rows; returns the holdout predictions and
    the metrics."""
    from ..runtime.scheduler import HostStream

    n = frame.nrows
    folds, nfolds = _fold_map(frame, y, cv, seed)
    tkw = dict(train_kw)
    tkw.pop("validation_frame", None)
    if cv.fold_column:
        tkw["ignored_columns"] = list(tkw.get("ignored_columns") or []) \
            + [cv.fold_column]
    share = _shape_share(n, frame)
    dev = frame.device
    y_all = frame.vec(y).as_float()           # enum NA -> NaN
    folds_t = torch.as_tensor(folds, device=dev)
    if share:
        wcol = tkw.get("weights_column")
        base_w = frame.vec(wcol).as_float() if wcol else \
            torch.ones(n, dtype=torch.float32, device=dev)
        tkw["weights_column"] = _MASK_COL
        if wcol:
            # the original weights fold into the mask and stay out of
            # the features (resolve_xy ignores only the active column)
            tkw["ignored_columns"] = list(
                tkw.get("ignored_columns") or []) + [wcol]

    models: list = [None] * nfolds
    fold_metrics: list = [None] * nfolds
    box: dict = {}

    def extract(k, m, hold, pk):
        if "preds" not in box:
            box["preds"] = torch.zeros((n,) + tuple(pk.shape[1:]),
                                       dtype=pk.dtype, device=pk.device)
        box["preds"][hold] = pk
        fold_metrics[k] = _combined_metrics(m, y_all[hold], pk)

    host = HostStream(name="h2o-torch-cv-host")
    try:
        for k in range(nfolds):
            # fail fast as a serial loop would: an earlier fold's error
            # surfaces before the next train starts
            errs = host.pop_errors()
            if errs:
                raise errs[0][2]
            hold = folds_t == k
            clone = copy.deepcopy(est)
            clone.cv_args = CVArgs()        # fold models never recurse
            if share:
                vecs = {nm: frame.vec(nm) for nm in frame.names}
                vecs[_MASK_COL] = Vec(torch.where(hold, 0.0, base_w),
                                      name=_MASK_COL)
                m = clone.train(y=y, training_frame=Frame(vecs), **tkw)
                pk = m._predict_device(frame)[hold]
            else:
                m = clone.train(y=y, training_frame=frame.select_rows(~hold),
                                **tkw)
                pk = m._predict_device(frame.select_rows(hold))
            models[k] = m
            host.submit(k, lambda k=k, m=m, hold=hold, pk=pk:
                        extract(k, m, hold, pk), label=f"fold {k}")
        errs = host.drain()
        if errs:
            raise errs[0][2]
    finally:
        host.stop()

    keys = fold_metrics[0].keys()
    summary = {key: {"mean": float(np.mean([fm[key] for fm in fold_metrics])),
                     "std": float(np.std([fm[key] for fm in fold_metrics]))}
               for key in keys}
    preds = box["preds"]
    combined = _combined_metrics(models[0], y_all, preds)
    return CVResult(
        fold_ids=folds,
        models=models if cv.keep_cross_validation_models else None,
        holdout_predictions=(preds if
                             cv.keep_cross_validation_predictions else None),
        metrics=combined, metrics_summary=summary,
        fold_metrics=fold_metrics)


def finalize_train(est, model, y: str, training_frame: Frame,
                   train_kw: dict[str, Any], validation_frame=None):
    """The post-train step of every supervised estimator: validation
    metrics, then cross-validation when the estimator asked for it.
    Returns the model."""
    if validation_frame is not None:
        model.validation_metrics = model.model_performance(
            validation_frame, y)
    cv = getattr(est, "cv_args", None)
    if cv is not None and cv.enabled:
        seed = int(getattr(est.params, "seed", 0) or 0)
        model.cv = cross_validate(est, y, training_frame, cv, train_kw,
                                  seed=seed)
    else:
        model.cv = None
    return model
