"""GBM — gradient boosting on the histogram tree core, on one device.

``GBM(ntrees, max_depth, learn_rate, nbins, seed).train(y=...,
training_frame=...)`` is the JAX package's entry point. It trains where
the frame lives (a frame on the card trains through the CUDA histogram
kernel) and returns a ``GBMModel``, which serves through the scorer
surface of ``FlatTreeScorer`` (``score_numpy``, ``contrib_numpy``,
``warm_up``) over the flattened trees it grew. ``models/drf.py``'s DRF
trains through the same ``train`` in DRF mode.

Ported: the bernoulli (logit link, g = p - y, h = p(1-p)), gaussian
(g = f - y, h = 1: two-channel histograms) and multinomial (K class
trees per round, softmax gradients) distributions, weights, an offset
column, ``sample_rate``, ``col_sample_rate_per_tree`` and ``mtries``.
Every random draw is the JAX package's (``runtime/prng.py``), keyed by
the JAX package's schedule, so a seeded model grows the same trees.
Everything else raises ``NotImplementedError`` naming the ROADMAP item
that brings it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import default_nbins, hist_bytes_budget
from ..operator.registry import FlatTreeScorer
from ..runtime import prng
from .base import TrainData, resolve_xy
from .tree.binning import BinSpec, fused_fit_bins
from .tree.core import (BoostParams, Tree, TreeParams, boost_trees,
                        boost_trees_drf, boost_trees_multi, draws_random,
                        drf_group_size, flatten_cover, flatten_trees,
                        level_hist_bytes)

__all__ = ["GBM", "GBMModel", "GBMParams", "gbm_model_from_arrays"]

_DISTRIBUTIONS = ("bernoulli", "gaussian", "multinomial")
_UNIT_HESS_DISTS = ("gaussian",)
_CV_KEYS = ("nfolds", "fold_assignment", "fold_column",
            "keep_cross_validation_predictions",
            "keep_cross_validation_models")


@dataclass
class GBMParams:
    ntrees: int = 50
    max_depth: int = 5
    learn_rate: float = 0.1
    min_rows: float = 10.0
    nbins: int = 256
    sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    mtries: int = -1
    distribution: str = "auto"
    reg_lambda: float = 0.0
    reg_alpha: float = 0.0
    min_child_weight: float = 0.0
    min_split_improvement: float = 1e-5  # H2O default
    seed: int = 0
    score_every: int = 0
    checkpoint: object = None
    # DRF mode (models/drf.py): no shrinkage, g = -y, trees average
    _drf_mode: bool = False


# max histogram work units (rows·F·nbins·2^depth·K summed over a chunk's
# trees) of one of the JAX package's compiled dispatches: the port does
# not chunk, but draws each chunk's key as the JAX package does
_DISPATCH_BUDGET = 3e12


def _make_tree_params(p: GBMParams, distribution: str) -> TreeParams:
    return TreeParams(max_depth=p.max_depth, n_bins=p.nbins,
                      min_rows=p.min_rows, reg_lambda=p.reg_lambda,
                      reg_alpha=p.reg_alpha,
                      gamma=p.min_split_improvement,
                      min_child_weight=p.min_child_weight,
                      unit_hess=(p._drf_mode
                                 or distribution in _UNIT_HESS_DISTS),
                      mtries=p.mtries)


def _make_boost_params(p: GBMParams, distribution: str) -> BoostParams:
    return BoostParams(distribution=distribution,
                       learn_rate=1.0 if p._drf_mode else p.learn_rate,
                       sample_rate=p.sample_rate,
                       col_sample_rate_per_tree=p.col_sample_rate_per_tree,
                       drf_mode=p._drf_mode)


def _chunk_sizes(p: GBMParams, rows: int, F: int, K: int) -> list[int]:
    """Tree counts of the dispatches the JAX package's in-HBM loop
    issues for this shape (its ``_chunk_sizes`` on one row shard): each
    chunk draws its own key, so the port walks the same schedule."""
    per_round = rows * max(F, 1) * p.nbins * (2 ** p.max_depth) * K
    budget_chunk = max(1, int(_DISPATCH_BUDGET // per_round))
    out, t = [], 0
    while t < p.ntrees:
        out.append(min(budget_chunk, p.ntrees - t))
        t += out[-1]
    return out


def _round_keys(p: GBMParams, rows: int, F: int, K: int, device
                ) -> torch.Tensor:
    """[ntrees, 2] per-round threefry keys, the JAX package's schedule:
    ``key = key(seed)``, then per dispatch chunk ``key, kc =
    split(key)`` and the chunk's rounds ``split(kc, n)``."""
    key = prng.key(p.seed, device)
    out = []
    for n in _chunk_sizes(p, rows, F, K):
        key, kc = prng.split(key, 2)
        out.append(prng.split(kc, n))
    return torch.cat(out)


def _unported(p: GBMParams) -> str | None:
    """The first option this port does not train, with its ROADMAP item."""
    if p.checkpoint is not None:
        return "checkpoint continuation (ROADMAP Queue 1 item 6b)"
    if p.score_every:
        return "score_every (ROADMAP Queue 1 item 11)"
    for env, what in (("H2O_TPU_GOSS", "GOSS"), ("H2O_TPU_EFB", "EFB"),
                      ("H2O_TPU_OOC", "out-of-core boosting")):
        if os.environ.get(env) == "1":
            return f"{what} ({env}=1; ROADMAP Queue 1 item 9)"
    return None


def _init_margin(y, w, off, dist: str, K: int):
    """(init score, starting margin): bernoulli's intercept MLE given
    the offset (3 Newton steps from logit(ȳ)), multinomial's log class
    priors ([K] init, [rows, K] margin), gaussian's weighted mean of
    y - offset."""
    w_sum = torch.sum(w)
    if dist == "multinomial":
        cls = torch.where(w > 0, y, K).long()
        cls_w = torch.zeros(K + 1, dtype=w.dtype, device=w.device
                            ).index_add_(0, cls, w)[:K]
        init = torch.log(torch.clamp(cls_w / w_sum, min=1e-8))
        return init, init[None, :].expand(y.shape[0], K)
    if dist == "bernoulli":
        p1 = torch.clamp(torch.sum(y * w) / w_sum, 1e-6, 1 - 1e-6)
        init = torch.log(p1 / (1 - p1))
        for _ in range(3):
            pr = torch.sigmoid(init + off)
            num = torch.sum(w * (y - pr))
            den = torch.clamp(torch.sum(w * pr * (1.0 - pr)), min=1e-10)
            init = init + num / den
        return init, init + off
    init = torch.sum((y - off) * w) / w_sum
    return init, init + off


def _margin_metrics(dist: str, margin, y, w) -> dict:
    """Training metrics from the final boosting margin."""
    from .. import metrics as M

    if dist == "bernoulli":
        p1 = torch.sigmoid(margin)
        return {"train_logloss": M.logloss(y, p1, w=w),
                "train_auc": M.roc_auc(y, p1, w=w)}
    if dist == "multinomial":
        return {"train_logloss": M.multinomial_logloss(
            y, torch.softmax(margin, dim=1), w=w)}
    return {"train_rmse": M.rmse(y, margin, w=w)}


def _gain_by_feat(tree: Tree, F: int) -> np.ndarray:
    feat = np.asarray(tree.split_feat)
    gain = np.asarray(tree.gain)
    out = np.zeros(F, dtype=np.float64)
    sel = feat >= 0
    np.add.at(out, feat[sel], gain[sel])
    return out


def _stacked_varimp(trees: Tree, names: list[str]) -> dict[str, float]:
    """Per-feature summed split gain over a stacked Tree, one host copy."""
    flat = Tree(*(a.cpu().numpy().ravel() for a in trees))
    return dict(zip(names, _gain_by_feat(flat, len(names))))


class GBMModel(FlatTreeScorer):
    """A trained GBM: its heap trees, bin spec and params, serving
    through the flattened arrays ``flatten_trees`` makes from them."""

    algo = "gbm"

    def __init__(self, data: TrainData, params: GBMParams,
                 bin_spec: BinSpec, trees: Tree, init_score,
                 offset_column: str | None = None, device=None):
        """``trees``: stacked [T, N], interleaved class-fastest for K > 2
        classes; ``init_score``: a float, or the [K] class priors."""
        flat = flatten_trees(trees, bin_spec.edges_matrix(),
                             np.array(bin_spec.is_enum), params.max_depth)
        arrays = {f"flat_{k}": v for k, v in flat._asdict().items()}
        arrays["flat_cover"] = flatten_cover(trees, params.max_depth)
        arrays["init_score"] = np.asarray(init_score,
                                          dtype=np.float32).reshape(-1)
        arrays["enum_mask"] = np.array(bin_spec.is_enum)
        meta = {"algo": self.algo, "feature_names": data.feature_names,
                "feature_domains": data.feature_domains,
                "nclasses": data.nclasses,
                "response_domain": data.response_domain,
                "distribution": data.distribution,
                "offset_column": offset_column,
                # every tree, all K classes' ([T·K]): the count the
                # scorer divides a DRF's leaf sums by (per class: // K)
                "ntrees": int(trees.value.shape[0]),
                "max_depth": params.max_depth,
                "drf_mode": bool(params._drf_mode)}
        super().__init__(meta, arrays, device=trees.value.device
                         if device is None else device)
        self.params = params
        self.bin_spec = bin_spec
        self.trees = trees
        self.scoring_history: list[dict] = []
        self.validation_metrics: dict | None = None
        self._varimp = _stacked_varimp(trees, data.feature_names)

    def varimp(self) -> dict[str, float]:
        """Relative importance: per-feature summed split gain, scaled."""
        v = self._varimp
        top = max(v.values()) if v else 1.0
        return {k: val / top if top > 0 else 0.0
                for k, val in sorted(v.items(), key=lambda kv: -kv[1])}


class GBM:
    """H2OGradientBoostingEstimator analog."""

    model_cls = GBMModel

    def __init__(self, **kw):
        cv = [k for k in _CV_KEYS if k in kw]
        if cv:
            raise NotImplementedError(
                f"cross-validation ({', '.join(cv)}) is not ported "
                "(ROADMAP Queue 1 item 11)")
        kw.setdefault("nbins", default_nbins())
        self.params = GBMParams(**kw)

    def train(self, y: str, training_frame, x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              weights_column: str | None = None,
              validation_frame=None,
              offset_column: str | None = None) -> GBMModel:
        """Train on ``training_frame``'s device; returns the model."""
        p = self.params
        if p.ntrees < 1:
            raise ValueError(f"ntrees must be >= 1, got {p.ntrees}")
        if not 4 <= p.nbins <= 256:
            raise ValueError(f"n_bins must be in [4, 256] (uint8 bin "
                             f"codes), got {p.nbins}")
        why = _unported(p)
        if why:
            raise NotImplementedError(f"{why} is not ported")
        data = resolve_xy(training_frame, y, x, ignored_columns,
                          weights_column, p.distribution, offset_column)
        if data.distribution not in _DISTRIBUTIONS:
            raise NotImplementedError(
                f"distribution '{data.distribution}' is not ported "
                "(bernoulli, gaussian and multinomial are; the rest: "
                "ROADMAP Queue 1 item 6b)")
        K = data.nclasses if data.nclasses > 2 else 1
        tp = _make_tree_params(p, data.distribution)
        F = len(data.feature_names)
        # the JAX package's validation: K class trees' histograms are
        # live at once while they fit 2^30 bytes (it grows them one by
        # one past that; the port grows them in groups, drf_group_size)
        need, budget = level_hist_bytes(tp, F), hist_bytes_budget()
        if K > 1 and K * need <= 2 ** 30:
            need *= K
        if need > budget:
            raise ValueError(
                f"max_depth={p.max_depth} with {F} histogram columns x "
                f"{p.nbins} bins needs ~{need / 2 ** 20:.0f} MiB of level "
                f"histograms (> budget {budget / 2 ** 20:.0f} MiB). Lower "
                "max_depth or nbins, drop features, or raise "
                "H2O_TPU_HIST_BYTES_BUDGET if the device has room.")
        bin_spec, binned = fused_fit_bins(training_frame, data.feature_names,
                                          p.nbins)
        rows = data.y.shape[0]
        bp = _make_boost_params(p, data.distribution)
        keys = _round_keys(p, rows, F, K, binned.device) \
            if draws_random(tp, bp, F) else None
        G = drf_group_size(K, tp, F)[0]
        if p._drf_mode:
            # no boosting: leaves are in-leaf target means, init 0
            init = np.zeros(K, dtype=np.float32) if K > 1 else 0.0
            if K == 1:
                trees = boost_trees_drf(binned, data.y, data.w, p.ntrees,
                                        tp, bp, keys)
            else:
                trees = boost_trees_multi(
                    binned, data.y, data.w, None, p.ntrees, K, tp, bp, G,
                    keys)[1]
        else:
            off = data.offset if data.offset is not None \
                else torch.zeros_like(data.y)
            init, margin = _init_margin(data.y, data.w, off,
                                        data.distribution, K)
            if K == 1:
                margin, trees = boost_trees(binned, data.y, data.w, margin,
                                            p.ntrees, tp, bp, keys)
            else:
                margin, trees = boost_trees_multi(
                    binned, data.y, data.w, margin, p.ntrees, K, tp, bp, G,
                    keys)
            init = init.cpu().numpy() if K > 1 else float(init)
            if not np.isfinite(init).all():
                raise ValueError("no rows with positive weight and a non-NA "
                                 "response — cannot fit a prior")
        model = self.model_cls(data, p, bin_spec, trees, init, offset_column)
        if p._drf_mode:
            perf = model.model_performance(training_frame, y)
            model.scoring_history = [{"ntrees": p.ntrees, **{
                f"train_{k}": v for k, v in perf.items()}}]
        else:
            model.scoring_history = [{"ntrees": p.ntrees, **_margin_metrics(
                data.distribution, margin, data.y, data.w)}]
        if validation_frame is not None:
            model.validation_metrics = model.model_performance(
                validation_frame, y)
        return model


def gbm_model_from_arrays(trees: dict, edges, is_enum, init_score,
                          feature_names: list[str], distribution: str,
                          nclasses: int, max_depth: int,
                          response_domain: list[str] | None = None,
                          feature_domains: dict | None = None,
                          device=None, **params) -> GBMModel:
    """A port ``GBMModel`` from another package's trained GBM, as numpy:
    ``trees`` maps each ``Tree`` field to its stacked [T, N] array
    (interleaved class-fastest for K > 2 classes), ``edges`` is the
    [F, B-2] bin-edge matrix, ``is_enum`` the per-feature enum flags,
    ``init_score`` the prior (a float, or the [K] class priors).
    ``params`` are GBMParams fields (``max_depth`` is required; it sizes
    the descent)."""
    from ..runtime.backend import resolve_device

    dev = resolve_device(device)
    tree = Tree(*(torch.as_tensor(np.asarray(trees[f]), device=dev)
                  for f in Tree._fields))
    edges = torch.as_tensor(np.asarray(edges, dtype=np.float32), device=dev)
    spec = BinSpec(names=list(feature_names), is_enum=list(is_enum),
                   n_bins=edges.shape[1] + 2, edges=edges)
    data = TrainData(list(feature_names), torch.zeros(0), torch.zeros(0), 0,
                     nclasses, response_domain, distribution,
                     dict(feature_domains or {}))
    gp = GBMParams(max_depth=max_depth, nbins=spec.n_bins,
                   ntrees=int(tree.value.shape[0]), **params)
    return GBMModel(data, gp, spec, tree, init_score, device=dev)
