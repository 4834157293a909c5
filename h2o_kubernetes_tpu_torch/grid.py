"""Grid search: the H2OGridSearch analog.

A hyper-parameter grid over one estimator class, walked exhaustively
("Cartesian", in sorted parameter-name order) or by seeded random
draws without repeats ("RandomDiscrete" with ``max_models``,
``max_runtime_secs`` and ``seed``: numpy's generator, so the JAX
package's combos), each model trained with the shared ``train()``
arguments and ranked as the AutoML leaderboard ranks (auc descending,
logloss and rmse ascending), on the validation frame, the CV metrics
or the training metrics. ``max_models`` counts built models: a combo
that fails is recorded in ``failed_params`` and the walk goes on.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Sequence

import numpy as np

from .automl import _DESC, Job, Leaderboard
from .frame import Frame

__all__ = ["GridSearch", "H2OGridSearch"]


class GridSearch:
    """Hyper-parameter search over one estimator class.

    `model` is an estimator class (GBM, GLM, ...) or an instance whose
    constructor params become the grid's fixed base params.
    `hyper_params` maps param name -> list of candidate values.
    `search_criteria`: {"strategy": "Cartesian"} (default) or
    {"strategy": "RandomDiscrete", "max_models": N,
     "max_runtime_secs": S, "seed": K}.
    """

    def __init__(self, model, hyper_params: dict[str, Sequence[Any]],
                 grid_id: str | None = None,
                 search_criteria: dict[str, Any] | None = None):
        if not hyper_params:
            raise ValueError("hyper_params must name at least one "
                             "parameter to search")
        if isinstance(model, type):
            self.model_cls = model
            self.base_params: dict[str, Any] = {}
        else:
            self.model_cls = type(model)
            # reconstruct constructor kwargs from the instance's params
            # dataclass (estimators store them on .params) AND its CV
            # settings (popped into .cv_args at construction — dropping
            # them would silently train grid models without the
            # requested cross-validation)
            p = getattr(model, "params", None)
            self.base_params = {
                k: v for k, v in vars(p).items()
                if not k.startswith("_")} if p is not None else {}
            cv = getattr(model, "cv_args", None)
            if cv is not None:
                self.base_params.update(
                    {k: v for k, v in vars(cv).items()
                     if not k.startswith("_")})
        self.hyper_params = {k: list(v) for k, v in hyper_params.items()}
        crit = dict(search_criteria or {})
        self.strategy = crit.pop("strategy", "Cartesian")
        if self.strategy not in ("Cartesian", "RandomDiscrete"):
            raise ValueError(f"unknown strategy '{self.strategy}'")
        self.max_models = crit.pop("max_models", 0)
        self.max_runtime_secs = crit.pop("max_runtime_secs", 0)
        self.seed = crit.pop("seed", 0)
        crit.pop("stopping_rounds", None)       # accepted, not used
        crit.pop("stopping_tolerance", None)
        crit.pop("stopping_metric", None)
        if crit:
            raise ValueError(f"unknown search_criteria {sorted(crit)}")
        self.grid_id = grid_id or f"Grid_{self.model_cls.__name__}"
        self.models: list[Any] = []
        self.model_ids: list[str] = []
        self.failed_params: list[dict[str, Any]] = []
        self.leaderboard: Leaderboard | None = None
        self.job: Job | None = None

    # -- combination generators ---------------------------------------------
    def _cartesian(self):
        names = sorted(self.hyper_params)
        for combo in itertools.product(
                *(self.hyper_params[n] for n in names)):
            yield dict(zip(names, combo))

    def _random(self):
        rng = np.random.default_rng(self.seed)
        names = sorted(self.hyper_params)
        seen: set[tuple] = set()
        total = 1
        for n in names:
            total *= len(self.hyper_params[n])
        while len(seen) < total:
            combo = tuple(
                rng.integers(0, len(self.hyper_params[n])) for n in names)
            if combo in seen:
                continue
            seen.add(combo)
            yield {n: self.hyper_params[n][i]
                   for n, i in zip(names, combo)}

    def train(self, y: str, training_frame: Frame,
              x: Sequence[str] | None = None,
              validation_frame: Frame | None = None,
              **train_kw) -> "GridSearch":
        t0 = time.monotonic()
        deadline = t0 + self.max_runtime_secs if self.max_runtime_secs \
            else None
        yv = training_frame.vec(y) if y in training_frame.names else None
        nclasses = yv.cardinality() if yv is not None and yv.is_enum() \
            else 1
        if nclasses == 2:
            metric, asc = "auc", False
        elif nclasses > 2:
            metric, asc = "logloss", True
        else:
            metric, asc = "rmse", True
        self.sort_metric = metric
        self.leaderboard = Leaderboard(metric, asc)
        self.job = Job(dest=self.grid_id,
                       description=f"grid {self.model_cls.__name__}")
        self.job.start()           # registers itself in automl.JOBS

        combos = self._cartesian() if self.strategy == "Cartesian" \
            else self._random()
        built = attempt = 0
        try:
            for hp in combos:
                # H2O's max_models bounds BUILT models, not attempts —
                # a failed combo doesn't eat the budget (generators are
                # finite, so all-failing grids still terminate)
                if self.max_models and built >= self.max_models:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                attempt += 1
                params = {**self.base_params, **hp}
                model_id = f"{self.grid_id}_model_{attempt}"
                call_kw = dict(train_kw)
                if x is not None:
                    call_kw["x"] = x
                if validation_frame is not None:
                    call_kw["validation_frame"] = validation_frame
                try:
                    est = self.model_cls(**params)
                    model = est.train(y=y, training_frame=training_frame,
                                      **call_kw)
                    if validation_frame is not None:
                        metrics = model.model_performance(
                            validation_frame, y)
                    elif getattr(model, "cv", None) is not None:
                        metrics = model.cv.metrics
                    else:
                        metrics = model.model_performance(
                            training_frame, y)
                except Exception as e:  # noqa: BLE001 - grid keeps going
                    self.failed_params.append({**hp, "error": repr(e)})
                    continue
                model.grid_params = dict(hp)
                self.leaderboard.add(model_id, model, metrics)
                built += 1
                self.job.update(
                    min(0.99, built / max(self.max_models or 20, 1)))
        except BaseException as e:
            self.job.failed(repr(e))
            raise
        # expose models sorted by the grid metric (H2O sorts get_grid
        # output; .models follows the sorted order for convenience)
        rows = self.leaderboard.as_list()
        self.model_ids = [r["model_id"] for r in rows]
        self.models = [self.leaderboard.models[i] for i in self.model_ids]
        self.job.done()
        return self

    # -- h2o-py surface ------------------------------------------------------
    def get_grid(self, sort_by: str | None = None,
                 decreasing: bool | None = None) -> list[dict[str, Any]]:
        """Ranked [{model_id, <metrics>, <hyper params>}] rows."""
        if self.leaderboard is None:
            raise ValueError("grid has not been trained")
        rows = [dict(r) for r in self.leaderboard.as_list()]
        for r in rows:
            m = self.leaderboard.models[r["model_id"]]
            r.update(getattr(m, "grid_params", {}))
        if sort_by:
            if decreasing is None:
                decreasing = sort_by in _DESC
            rows.sort(key=lambda r: r.get(sort_by, float("inf")),
                      reverse=bool(decreasing))
        return rows

    @property
    def leader(self):
        if not self.models:
            raise ValueError("grid has no successful models")
        return self.models[0]

    def __repr__(self):
        done = len(self.model_ids)
        return (f"GridSearch({self.model_cls.__name__}, {done} models, "
                f"{len(self.failed_params)} failed)")


H2OGridSearch = GridSearch
