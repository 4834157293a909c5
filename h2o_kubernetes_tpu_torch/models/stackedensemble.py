"""Stacked ensembles: a metalearner over the base models'
cross-validation holdout predictions.

The level-one frame holds each base model's holdout predictions (the
class-1 probability for binomial, all K probabilities for multinomial,
the prediction for regression) on the training frame's device; the
metalearner (GLM by default, DRF or GBM) trains on it, and scoring
runs every base model, then the metalearner on their outputs.

Every base model must have kept its holdout predictions, on the same
response, the same rows and the same fold assignment (its stored fold
ids), as the JAX package checks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame import Frame, Vec
from ..runtime.mesh import single_process_only
from .base import Model, resolve_xy

__all__ = ["StackedEnsemble", "StackedEnsembleModel"]


def _level_one_columns(m, preds: torch.Tensor, tag: str
                       ) -> dict[str, torch.Tensor]:
    """The columns a base model contributes to the level-one frame."""
    if m.nclasses == 2:
        return {tag: preds[:, 1]}
    if m.nclasses > 2:
        return {f"{tag}_p{k}": preds[:, k] for k in range(m.nclasses)}
    return {tag: preds}


def _frame_of(cols: dict[str, torch.Tensor]) -> Frame:
    return Frame({n: Vec(c.contiguous(), name=n) for n, c in cols.items()})


class StackedEnsembleModel(Model):
    algo = "stackedensemble"
    _evictable = False        # scores through its base models

    def __init__(self, data, base_models: list, metalearner,
                 base_tags: list[str]):
        self.feature_names: list[str] = []
        self.feature_domains: dict = {}
        self.nclasses = data.nclasses
        self.response_domain = data.response_domain
        self.distribution = data.distribution
        self.offset_column = None
        self.scoring_history: list[dict] = []
        self.validation_metrics: dict | None = None
        self.base_models = base_models
        self.metalearner = metalearner
        self.base_tags = base_tags
        self.device = metalearner.device

    def _level_one_frame(self, frame) -> Frame:
        cols: dict[str, torch.Tensor] = {}
        for m, tag in zip(self.base_models, self.base_tags):
            cols.update(_level_one_columns(m, m._predict_device(frame),
                                           tag))
        return _frame_of(cols)

    def _predict_device(self, frame) -> torch.Tensor:
        # predict(), predict_raw() and model_performance() route here
        return self.metalearner._predict_device(
            self._level_one_frame(frame))

    @property
    def _artifact_meta(self) -> dict:
        return {"algo": "stackedensemble", "feature_names": [],
                "feature_domains": {}, "nclasses": self.nclasses,
                "response_domain": self.response_domain,
                "distribution": self.distribution,
                "base_tags": list(self.base_tags),
                "base_count": len(self.base_models)}

    @property
    def _artifact_arrays(self) -> dict:
        return {}


class StackedEnsemble:
    """H2OStackedEnsembleEstimator analog."""

    def __init__(self, base_models: list,
                 metalearner_algorithm: str = "glm",
                 metalearner_params: dict | None = None,
                 metalearner_nfolds: int = 0):
        if not base_models:
            raise ValueError("base_models must be non-empty")
        self.base_models = list(base_models)
        self.metalearner_algorithm = metalearner_algorithm
        self.metalearner_params = dict(metalearner_params or {})
        self.metalearner_nfolds = metalearner_nfolds

    def train(self, y: str, training_frame: Frame) -> StackedEnsembleModel:
        single_process_only("StackedEnsemble")
        models = self.base_models
        ref = models[0]
        fold_ref = None
        for i, m in enumerate(models):
            if m.cv is None or m.cv.holdout_predictions is None:
                raise ValueError(
                    f"base model #{i} ({m.algo}) was not trained with "
                    "nfolds >= 2 and keep_cross_validation_predictions")
            if m.nclasses != ref.nclasses:
                raise ValueError("base models disagree on the response "
                                 f"({m.nclasses} vs {ref.nclasses} classes)")
            if m.cv.holdout_predictions.shape[0] != training_frame.nrows:
                raise ValueError(
                    f"base model #{i} was trained on a different frame "
                    f"({m.cv.holdout_predictions.shape[0]} rows vs "
                    f"{training_frame.nrows})")
            if fold_ref is None:
                fold_ref = m.cv.fold_ids
            elif not np.array_equal(m.cv.fold_ids, fold_ref):
                raise ValueError(
                    f"base model #{i} used a different fold assignment; "
                    "train all base models with the same fold_column or "
                    "(fold_assignment, seed)")

        tags = []
        seen: dict[str, int] = {}
        for m in models:
            seen[m.algo] = seen.get(m.algo, 0) + 1
            tags.append(f"{m.algo}{seen[m.algo]}" if seen[m.algo] > 1
                        else m.algo)

        dev = training_frame.device
        cols: dict[str, torch.Tensor] = {}
        for m, tag in zip(models, tags):
            cols.update(_level_one_columns(
                m, m.cv.holdout_predictions.to(dev), tag))
        lone = _frame_of(cols)
        lone[y] = training_frame.vec(y)

        cvkw = {"nfolds": self.metalearner_nfolds,
                "fold_assignment": "modulo"} \
            if self.metalearner_nfolds >= 2 else {}
        if self.metalearner_algorithm == "glm":
            from .glm import GLM

            params = dict(self.metalearner_params)
            if ref.nclasses == 2:
                params.setdefault("family", "binomial")
            elif ref.nclasses == 1:
                params.setdefault("family", "gaussian")
            else:
                # a multinomial response takes a DRF metalearner, as in
                # the JAX package
                from .drf import DRF

                meta = DRF(ntrees=50, seed=0, **cvkw).train(
                    y=y, training_frame=lone)
                return self._finish(meta, models, tags, training_frame, y)
            meta = GLM(**params, **cvkw).train(y=y, training_frame=lone)
        elif self.metalearner_algorithm in ("drf", "gbm"):
            from .drf import DRF
            from .gbm import GBM

            cls = DRF if self.metalearner_algorithm == "drf" else GBM
            meta = cls(**self.metalearner_params, **cvkw).train(
                y=y, training_frame=lone)
        else:
            raise ValueError(
                f"unknown metalearner '{self.metalearner_algorithm}'")
        return self._finish(meta, models, tags, training_frame, y)

    @staticmethod
    def _finish(meta, models, tags, training_frame, y):
        # resolve_xy only for the response's metadata: the features are
        # the base models'
        data = resolve_xy(training_frame, y,
                          x=models[0].feature_names[:1])
        model = StackedEnsembleModel(data, models, meta, tags)
        # the metalearner's CV over the level-one frame is the whole
        # ensemble's generalization estimate
        model.cv = meta.cv
        return model
