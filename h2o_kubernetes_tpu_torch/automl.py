"""AutoML: a model search under shared cross-validation, two stacked
ensembles and a leaderboard.

The plan is the JAX package's: per-algorithm default models first (GLM,
DRF, XRT, five GBMs, three XGBoosts, one DeepLearning), then random
GBM/XGBoost/DeepLearning draws until ``max_models`` or
``max_runtime_secs`` runs out. Every base model trains with modulo
folds and keeps its holdout predictions, the level-one data of the
BestOfFamily and AllModels ensembles. The leaderboard ranks by the CV
metrics (or on ``leaderboard_frame``): auc descending for binomial,
logloss ascending for multinomial, rmse ascending for regression.

``AutoML.train`` runs on ``runtime/scheduler.PipelinedExecutor``: the
caller's thread holds the device token and trains the plan in order,
and the host stream applies each step's completion (leaderboard
insertion, the resume manifest's write, the event log) in plan order,
so the leaderboard and the manifest equal a serial run's. The JAX
package's ``H2O_TPU_AUTOML_PIPELINE=0`` serial path has no twin here.
``checkpoint_dir`` saves each finished base model and its metrics; a
rerun with the same directory reloads those steps and trains only the
rest. The ``automl.step`` fault point (``runtime/faults.py``) fires
before each step trains.

``Job``/``jobs()`` record AutoML and grid runs (the ``/3/Jobs``
surface) and write ``diagnostics.timeline``.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from .frame import Frame
from .models.deeplearning import DeepLearning
from .models.drf import DRF
from .models.gbm import GBM
from .models.glm import GLM
from .models.stackedensemble import StackedEnsemble
from .models.xgboost import XGBoost

__all__ = ["AutoML", "Job", "Leaderboard", "jobs", "JOBS"]

# metrics where larger is better (everything else ranks ascending)
_DESC = {"auc", "accuracy", "r2", "pr_auc", "ndcg@10"}

JOBS: dict[str, "Job"] = {}       # every Job registers here


def jobs() -> list[dict[str, Any]]:
    """Every job with its status and progress."""
    return [{"dest": j.dest, "description": j.description,
             "status": j.status, "progress": j.progress, "msg": j.msg}
            for j in JOBS.values()]


# one lock for every Job transition and one for the resume manifest's
# read-modify-write (the host stream writes it while others may read)
_JOB_STATE_LOCK = threading.Lock()
_MANIFEST_LOCK = threading.Lock()


@dataclass
class Job:
    """An asynchronous-style progress record."""

    dest: str
    description: str
    status: str = "CREATED"        # CREATED | RUNNING | DONE | FAILED
    progress: float = 0.0
    msg: str = ""
    start_time: float = 0.0
    end_time: float = 0.0

    def start(self):
        from .diagnostics import timeline

        self.status = "RUNNING"
        self.start_time = time.time()
        JOBS[self.dest] = self
        timeline.record("job_start", self.description, dest=self.dest)
        return self

    def update(self, progress: float, msg: str = ""):
        with _JOB_STATE_LOCK:
            if self.status in ("DONE", "FAILED"):
                return          # terminal states keep their message
            self.progress = float(progress)
            if msg:
                self.msg = msg

    def done(self):
        from .diagnostics import timeline

        with _JOB_STATE_LOCK:
            if self.status == "FAILED":
                return          # a reaped job stays failed
            self.status = "DONE"
            self.progress = 1.0
            self.end_time = time.time()
        timeline.record("job_done", self.description, dest=self.dest,
                        seconds=self.end_time - self.start_time)

    def failed(self, msg: str):
        with _JOB_STATE_LOCK:
            if self.status == "DONE":
                return
            self.status = "FAILED"
            self.msg = msg
            self.end_time = time.time()


# the host stream inserts rows while the training thread (or a poller) reads
_LB_LOCK = threading.Lock()


class Leaderboard:
    """Ranked table of (model_id, metrics)."""

    def __init__(self, sort_metric: str, ascending: bool):
        self.sort_metric = sort_metric
        self.ascending = ascending
        self.rows: list[dict[str, Any]] = []
        self.models: dict[str, Any] = {}

    def add(self, model_id: str, model, metrics: dict[str, float]):
        with _LB_LOCK:
            self.models[model_id] = model
            self.rows.append({"model_id": model_id, **metrics})
            self.rows.sort(key=lambda r: r.get(self.sort_metric, np.inf)
                           if self.ascending
                           else -r.get(self.sort_metric, -np.inf))

    @property
    def leader(self):
        with _LB_LOCK:
            return self.models[self.rows[0]["model_id"]] \
                if self.rows else None

    def as_list(self) -> list[dict[str, Any]]:
        with _LB_LOCK:
            return [dict(r) for r in self.rows]

    def __repr__(self):
        rows = self.as_list()
        if not rows:
            return "Leaderboard(empty)"
        cols: list[str] = []
        for r in rows:            # union of metric keys, stable order
            cols += [c for c in r if c != "model_id" and c not in cols]
        w = max(len(r["model_id"]) for r in rows)
        lines = ["  ".join([f"{'model_id':<{w}}"] +
                           [f"{c:>12}" for c in cols])]
        for r in rows:
            lines.append("  ".join(
                [f"{r['model_id']:<{w}}"] +
                [f"{r[c]:>12.5f}" if c in r else " " * 12 for c in cols]))
        return "\n".join(lines)


def _default_plan(seed: int) -> list[tuple[str, str, dict]]:
    """(family, name, params): the defaults-first steps."""
    return [
        ("glm", "GLM_1", {}),
        ("drf", "DRF_1", {"ntrees": 50}),
        # XRT: no-bootstrap full-data trees with the default per-node
        # feature sampling
        ("drf", "XRT_1", {"ntrees": 50, "sample_rate": 1.0,
                          "min_rows": 5}),
        ("gbm", "GBM_1", {"ntrees": 50, "max_depth": 6, "min_rows": 1}),
        ("gbm", "GBM_2", {"ntrees": 50, "max_depth": 7, "min_rows": 10}),
        ("gbm", "GBM_3", {"ntrees": 50, "max_depth": 8, "min_rows": 10}),
        ("gbm", "GBM_4", {"ntrees": 50, "max_depth": 9, "min_rows": 10}),
        ("gbm", "GBM_5", {"ntrees": 50, "max_depth": 10, "min_rows": 100,
                          "nbins": 64}),
        ("xgboost", "XGBoost_1", {"ntrees": 50, "max_depth": 8,
                                  "min_child_weight": 5}),
        ("xgboost", "XGBoost_2", {"ntrees": 50, "max_depth": 10,
                                  "min_child_weight": 10, "nbins": 64}),
        ("xgboost", "XGBoost_3", {"ntrees": 50, "max_depth": 5,
                                  "min_child_weight": 3}),
        ("deeplearning", "DeepLearning_1", {"hidden": (64, 64),
                                            "epochs": 10}),
    ]


def _random_grid(rng: np.random.Generator) -> tuple[str, dict]:
    """One random-search draw over the GBM/XGBoost/DL spaces."""
    fam = rng.choice(["gbm", "xgboost", "deeplearning"],
                     p=[0.4, 0.4, 0.2])
    if fam == "gbm":
        return fam, {
            "ntrees": int(rng.choice([30, 50, 80])),
            "max_depth": int(rng.integers(3, 11)),
            "learn_rate": float(rng.choice([0.05, 0.1, 0.2])),
            "sample_rate": float(rng.choice([0.6, 0.8, 1.0])),
            "col_sample_rate_per_tree": float(rng.choice([0.5, 0.8, 1.0])),
            "min_rows": float(rng.choice([1, 5, 10, 30])),
        }
    if fam == "xgboost":
        return fam, {
            "ntrees": int(rng.choice([30, 50, 80])),
            "max_depth": int(rng.integers(3, 11)),
            "learn_rate": float(rng.choice([0.05, 0.1, 0.3])),
            "reg_lambda": float(rng.choice([0.1, 1.0, 10.0])),
            "min_child_weight": float(rng.choice([1, 5, 15])),
            "subsample": float(rng.choice([0.6, 0.8, 1.0])),
        }
    return fam, {
        "hidden": tuple(rng.choice([32, 64, 128],
                                   size=int(rng.integers(1, 4)))),
        "epochs": int(rng.choice([5, 10, 20])),
        "input_dropout_ratio": float(rng.choice([0.0, 0.1, 0.2])),
    }


_EST = {"glm": GLM, "drf": DRF, "gbm": GBM, "xgboost": XGBoost,
        "deeplearning": DeepLearning}


class AutoML:
    """H2OAutoML analog."""

    def __init__(self, max_models: int = 12,
                 max_runtime_secs: float | None = None,
                 nfolds: int = 5, seed: int = 0,
                 include_algos: Sequence[str] | None = None,
                 exclude_algos: Sequence[str] | None = None,
                 sort_metric: str = "auto",
                 project_name: str = "automl",
                 checkpoint_dir: str | None = None,
                 verbosity: str | None = "info"):
        """``checkpoint_dir``: the resume manifest's directory (local
        or ``mem://``); each finished base model is saved there with its
        metrics, and a rerun with the same directory reloads them
        instead of training them again."""
        if include_algos and exclude_algos:
            raise ValueError("include_algos and exclude_algos are "
                             "mutually exclusive")
        self.checkpoint_dir = checkpoint_dir
        self.max_models = max_models
        self.max_runtime_secs = max_runtime_secs
        self.nfolds = nfolds
        self.seed = seed
        algos = {"glm", "drf", "gbm", "xgboost", "deeplearning",
                 "stackedensemble"}
        if include_algos:
            algos = {a.lower() for a in include_algos}
        if exclude_algos:
            algos -= {a.lower() for a in exclude_algos}
        self.algos = algos
        self.sort_metric = sort_metric
        self.project_name = project_name
        self.verbosity = verbosity
        self.leaderboard: Leaderboard | None = None
        self.job: Job | None = None
        # the executor's stats() of the last train()
        self.scheduler_stats: dict | None = None
        self._models_by_family: dict[str, list] = {}
        # (timestamp, message) per step outcome, failures included
        self.event_log: list[tuple[str, str]] = []

    # -- internals ----------------------------------------------------------

    def _log(self, msg: str):
        self.event_log.append(
            (time.strftime("%Y-%m-%dT%H:%M:%S"), msg))
        if self.verbosity:
            print(f"[AutoML {self.project_name}] {msg}")

    def _resolve_sort(self, nclasses: int) -> tuple[str, bool]:
        if self.sort_metric != "auto":
            m = self.sort_metric.lower()
            return m, m not in _DESC
        if nclasses == 2:
            return "auc", False
        if nclasses > 2:
            return "logloss", True
        return "rmse", True

    # -- main entry ---------------------------------------------------------

    def train(self, y: str, training_frame: Frame,
              x: Sequence[str] | None = None,
              leaderboard_frame: Frame | None = None) -> "AutoML":
        """Run the model search on the training frame's device."""
        from .runtime import faults
        from .runtime.health import (ClusterHealthError, healthy,
                                     is_device_error, mark_unhealthy)
        from .runtime.scheduler import PipelinedExecutor

        t0 = time.monotonic()
        deadline = t0 + self.max_runtime_secs if self.max_runtime_secs \
            else None
        rng = np.random.default_rng(self.seed)
        yv = training_frame.vec(y)
        nclasses = yv.cardinality() if yv.is_enum() else 1
        metric, asc = self._resolve_sort(nclasses)
        self.leaderboard = Leaderboard(metric, asc)
        self._models_by_family = {}
        self.job = Job(dest=self.project_name, description="AutoML").start()

        plan = [(fam, name, prm) for fam, name, prm in
                _default_plan(self.seed) if fam in self.algos]
        n_done = 0
        # max_models 0/None is unbounded, held by the time budget; with
        # neither limit, the default plan only
        budget = self.max_models if self.max_models else None

        def out_of_budget():
            # n_done counts at train completion, so pending completions
            # on the host stream cannot over-train
            if budget is not None and n_done >= budget:
                return True
            return deadline is not None and time.monotonic() > deadline

        completed = self._load_manifest()
        execu = PipelinedExecutor()
        self.scheduler_stats = None

        def complete_step(model_id, fam, model, metrics, resumed):
            """Everything after a step's device work, on the host stream
            in plan order."""
            self.leaderboard.add(model_id, model, metrics)
            self._models_by_family.setdefault(fam, []).append(
                (model_id, model))
            if resumed:
                self._log(f"{model_id}: resumed from checkpoint")
                return
            self._save_step(model_id, fam, model, metrics)
            self._log(f"{model_id}: {metric}="
                      f"{metrics.get(metric, float('nan')):.5f}")

        def run_one(seq: int, fam: str, name: str, params: dict) -> None:
            """Train (or resume) one step and queue its completion."""
            if fam == "glm":
                params = {**params,
                          "family": "binomial" if nclasses == 2
                          else "multinomial" if nclasses > 2
                          else "gaussian"}
            model_id = f"{name}_AutoML_{self.project_name}"
            if model_id in completed:
                model, metrics = self._load_step(
                    completed[model_id], training_frame.device)
                execu.host.submit(seq, functools.partial(
                    complete_step, model_id, fam, model, metrics, True),
                    label=model_id)
                return
            faults.fire("automl.step", step=model_id)
            est = _EST[fam](
                **params, seed=self.seed,
                nfolds=self.nfolds, fold_assignment="modulo",
                keep_cross_validation_predictions=True)
            t = time.monotonic()
            with execu.device(model_id):
                model = est.train(y=y, training_frame=training_frame, x=x)
                if leaderboard_frame is not None:
                    ms = model.model_performance(leaderboard_frame, y)
                elif model.cv is not None:
                    ms = model.cv.metrics
                else:   # nfolds < 2: the training metrics
                    ms = model.model_performance(training_frame, y)
            metrics = {**ms, "training_time_s": time.monotonic() - t}
            execu.host.submit(seq, functools.partial(
                complete_step, model_id, fam, model, metrics, False),
                label=model_id)

        def step_failed(name: str, e: Exception) -> None:
            """A failed step never ends the run, unless the device went
            down with it: then every later step would fail too."""
            self._log(f"{name} failed: {e!r}")
            if is_device_error(e) and healthy():
                mark_unhealthy(f"device error during {name}: {e}")
            if not healthy():
                err = ClusterHealthError(
                    f"node died during {name}: {e!r} — restart and "
                    "rerun with the same checkpoint_dir to resume")
                self.job.failed(repr(err))
                raise err from e

        def poll_host_errors():
            """Completion failures (a failed manifest write) get the same
            treatment as a failed step."""
            for s, label, err in execu.host.pop_errors():
                step_failed(label or f"step {s}",
                            err if isinstance(err, Exception)
                            else RuntimeError(repr(err)))

        def run_step(seq, fam, name, params, what):
            try:
                run_one(seq, fam, name, params)
            except ClusterHealthError as e:
                execu.host.skip(seq)
                self.job.failed(repr(e))
                raise
            except Exception as e:
                # a failed attempt consumes budget: a persistent failure
                # cannot loop
                execu.host.skip(seq)
                step_failed(what, e)

        grid_families = [f for f in ("gbm", "xgboost", "deeplearning")
                         if f in self.algos]
        if budget is None and deadline is None:
            grid_families = []          # nothing bounds the grid search
        seq = grid_idx = 0
        try:
            for fam, name, params in plan:
                if out_of_budget():
                    break
                poll_host_errors()
                run_step(seq, fam, name, params, name)
                seq += 1
                n_done += 1
                self.job.update(min(0.8, n_done / max(budget or 20, 1)))

            while grid_families and not out_of_budget():
                poll_host_errors()
                fam, params = _random_grid(rng)
                if fam not in grid_families:
                    continue
                grid_idx += 1
                run_step(seq, fam, f"{fam.upper()}_grid_{grid_idx}",
                         params, f"grid {fam}")
                seq += 1
                n_done += 1
                self.job.update(min(0.9, n_done / max(budget or 20, 1)))

            # every base model's completion is applied before the
            # ensembles read the leaderboard and the family map
            try:
                execu.host.drain(timeout=600.0)
            except TimeoutError as te:
                self.job.failed(repr(te))
                raise
            poll_host_errors()

            try:
                if "stackedensemble" in self.algos and \
                        leaderboard_frame is None and \
                        len(self.leaderboard.models) >= 2 and \
                        self.nfolds >= 2:
                    self._build_ensembles(y, training_frame, metric)
            except Exception as e:
                self.job.failed(repr(e))
                raise
            self.job.done()
        finally:
            # every exit path settles the host stream: finished steps'
            # manifest writes land before an error propagates (the
            # resume depends on it), and no thread outlives the run
            try:
                execu.host.drain(timeout=120.0)
            except TimeoutError as te:
                self._log(f"scheduler drain wedged: {te}")
            for s, label, err in execu.host.pop_errors():
                self._log(f"{label or s} completion failed: {err!r}")
            execu.shutdown(timeout=30.0)
            self.scheduler_stats = st = execu.stats()
            self._log(f"pipeline: device_busy={st['device_busy_s']:.1f}s "
                      f"host_busy={st['host_busy_s']:.1f}s")

        self._log(f"done in {time.monotonic() - t0:.1f}s — leader: "
                  f"{self.leaderboard.rows[0]['model_id']}"
                  if self.leaderboard.rows else "done (no models)")
        return self

    # -- resume manifest (checkpoint_dir) -----------------------------------

    def _manifest_path(self):
        from .persist import join_path

        return join_path(self.checkpoint_dir, "automl_manifest.json")

    def _load_manifest(self) -> dict:
        """{model_id: {file, fam, metrics}} of the completed steps."""
        if not self.checkpoint_dir:
            return {}
        import os

        from .persist import is_remote, read_bytes

        try:
            return json.loads(read_bytes(self._manifest_path()))
        except FileNotFoundError:
            # only a missing manifest means a fresh run: any other read
            # failure must not silently retrain over a valid manifest
            if not is_remote(self.checkpoint_dir):
                os.makedirs(self.checkpoint_dir, exist_ok=True)
            return {}

    def _save_step(self, model_id, fam, model, metrics) -> None:
        if not self.checkpoint_dir:
            return
        from .persist import join_path, save_model, write_bytes_atomic

        path = join_path(self.checkpoint_dir, f"{model_id}.model")
        save_model(model, path)
        with _MANIFEST_LOCK:
            manifest = self._load_manifest()
            manifest[model_id] = {"file": path, "fam": fam,
                                  "metrics": metrics}
            write_bytes_atomic(self._manifest_path(),
                               json.dumps(manifest).encode())

    @staticmethod
    def _load_step(entry, device):
        from .persist import load_model

        return load_model(entry["file"], device=device), entry["metrics"]

    def _build_ensembles(self, y, frame, metric):
        """BestOfFamily and AllModels: base models with holdout
        predictions, ranked as on the leaderboard; each ensemble ranks
        by its metalearner's CV over the level-one frame."""
        id2fam = {mid: fam for fam, lst in self._models_by_family.items()
                  for mid, _ in lst}
        ranked = [(r["model_id"], self.leaderboard.models[r["model_id"]])
                  for r in self.leaderboard.rows
                  if r["model_id"] in id2fam]
        usable = [(mid, m) for mid, m in ranked if m.cv is not None and
                  m.cv.holdout_predictions is not None]
        if len(usable) < 2:
            return
        best_of_family: dict = {}
        for mid, m in usable:
            best_of_family.setdefault(id2fam[mid], (mid, m))

        for tag, pool in (
                ("BestOfFamily", list(best_of_family.values())),
                ("AllModels", usable)):
            if len(pool) < 2:
                continue
            try:
                se = StackedEnsemble(
                    [m for _, m in pool],
                    metalearner_nfolds=self.nfolds).train(
                    y=y, training_frame=frame)
                metrics = se.cv.metrics if se.cv else \
                    se.model_performance(frame, y)
                self.leaderboard.add(
                    f"StackedEnsemble_{tag}_AutoML_{self.project_name}",
                    se, metrics)
                self._log(f"StackedEnsemble_{tag}: "
                          f"{metric}={metrics.get(metric, float('nan')):.5f}")
            except Exception as e:
                self._log(f"StackedEnsemble_{tag} failed: {e!r}")

    # -- results ------------------------------------------------------------

    @property
    def leader(self):
        return self.leaderboard.leader if self.leaderboard else None

    def predict(self, frame: Frame):
        if self.leader is None:
            raise ValueError("AutoML has no trained models")
        return self.leader.predict(frame)
