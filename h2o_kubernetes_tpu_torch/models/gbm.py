"""GBM — gradient boosting on the histogram tree core, on one device.

``GBM(ntrees, max_depth, learn_rate, nbins, seed).train(y=...,
training_frame=...)`` is the JAX package's entry point. It trains where
the frame lives (a frame on the card trains through the CUDA histogram
kernel) and returns a ``GBMModel``, which serves through the scorer
surface of ``FlatTreeScorer`` (``score_numpy``, ``contrib_numpy``,
``warm_up``) over the flattened trees it grew. ``models/drf.py``'s DRF
trains through the same ``train`` in DRF mode.

Ported: every distribution of the JAX package — bernoulli (logit link),
gaussian, poisson, gamma and tweedie (log link), laplace (in
median/MAD-scaled units, ``margin_scale``), quantile, huber (a per-round
δ) and multinomial (K class trees per round); weights, an offset
column, ``sample_rate``, ``col_sample_rate_per_tree``, ``mtries`` and
checkpoint continuation (``checkpoint=<model>``, ``ntrees`` the total).
Every random draw is the JAX package's (``runtime/prng.py``), keyed by
the JAX package's schedule, so a seeded model grows the same trees.
Models add ``predict_leaf_node_assignment`` and the float64 host
``predict_contributions`` on a Frame.

The JAX package's training knobs, read at train time: GOSS
(``H2O_TPU_GOSS``, ``goss_params``), Exclusive Feature Bundling
(``H2O_TPU_EFB``, ``tree/efb.py``; ``auto`` bundles frames of 64
features or more where it shrinks them) and out-of-core boosting
(``H2O_TPU_OOC``, ``_ooc_chunk_rows``, ``tree/ooc.py``). ``score_every``
records the training metrics every that many rounds (the boosting
keys' chunks stop at its boundaries, as the JAX package's dispatches
do), and ``nfolds``/``fold_column`` cross-validate (``models/cv.py``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import default_nbins, hist_bytes_budget
from ..operator.registry import FlatTreeScorer
from ..runtime import mrtask, prng, xla_math
from ..runtime.mesh import n_row_shards, single_process_only
from .base import TrainData, resolve_xy
from .tree import efb as efb_mod
from .tree.binning import BinSpec, fit_bins, fused_fit_bins
from .tree.core import (BoostParams, Tree, TreeParams, boost_trees,
                        boost_trees_drf, boost_trees_multi, descend_trees,
                        draws_random, drf_group_size, flatten_cover,
                        flatten_trees, goss_round_keys, level_hist_bytes,
                        stack_predict)

__all__ = ["GBM", "GBMModel", "GBMParams", "gbm_model_from_arrays"]

_DISTRIBUTIONS = ("bernoulli", "gaussian", "multinomial", "poisson",
                  "gamma", "tweedie", "laplace", "quantile", "huber")
# h ≡ 1 losses: two-channel histograms
_UNIT_HESS_DISTS = ("gaussian", "laplace", "quantile", "huber")
_LOG_LINK_DISTS = ("poisson", "gamma", "tweedie")


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


def goss_params(p: GBMParams, distribution: str) -> tuple[float, float]:
    """(top_a, rand_b) of GOSS, or (0.0, 0.0) when off: on under
    ``H2O_TPU_GOSS=1`` for boosted trees (GBM, pointwise XGBoost); DRF
    stays bagged and rank:* objectives never sample. The knobs are read
    at train time and checked as the JAX package checks them."""
    if p._drf_mode or distribution.startswith("rank:"):
        return 0.0, 0.0
    if os.environ.get("H2O_TPU_GOSS", "0") != "1":
        return 0.0, 0.0
    a = float(os.environ.get("H2O_TPU_GOSS_TOP_A", "0.1"))
    b = float(os.environ.get("H2O_TPU_GOSS_RAND_B", "0.1"))
    if not (0.0 <= a < 1.0 and 0.0 < b <= 1.0 and a + b <= 1.0):
        raise ValueError(
            f"bad GOSS knobs: H2O_TPU_GOSS_TOP_A={a} / "
            f"H2O_TPU_GOSS_RAND_B={b} — need 0 <= a < 1, 0 < b, "
            "a + b <= 1")
    return a, b


def _make_boost_params(p: GBMParams, distribution: str) -> BoostParams:
    goss_a, goss_b = goss_params(p, distribution)
    return BoostParams(distribution=distribution,
                       learn_rate=1.0 if p._drf_mode else p.learn_rate,
                       sample_rate=p.sample_rate,
                       col_sample_rate_per_tree=p.col_sample_rate_per_tree,
                       drf_mode=p._drf_mode, goss_a=goss_a, goss_b=goss_b)


def _score_cadence(p: GBMParams) -> int:
    """Rounds between scoring-history rows (0: only at the end); DRF
    scores once."""
    return p.score_every if (p.score_every and not p._drf_mode) else 0


def _chunk_sizes(p: GBMParams, rows: int, F: int, K: int,
                 start_t: int = 0) -> list[int]:
    """Tree counts of the dispatches the JAX package's in-HBM loop
    makes for this shape (its ``_chunk_sizes``; ``rows`` counts the
    padded rows of every rank), from
    round ``start_t`` (a checkpoint's rounds) to ``ntrees``, stopping
    at ``score_every``'s boundaries: each chunk draws its own key, so
    the port walks the same schedule."""
    per_round = rows * max(F, 1) * p.nbins * (2 ** p.max_depth) * K
    budget_chunk = max(1, int(_DISPATCH_BUDGET // per_round))
    score = _score_cadence(p)
    out, t = [], start_t
    while t < p.ntrees:
        n = min(budget_chunk, p.ntrees - t)
        if score:
            n = min(n, score - (t - start_t) % score)
        out.append(n)
        t += n
    return out


def _round_keys(p: GBMParams, rows: int, F: int, K: int, device,
                start_t: int = 0) -> torch.Tensor:
    """[ntrees - start_t, 2] per-round threefry keys, the JAX package's
    schedule: ``key = key(seed)``, then per dispatch chunk ``key, kc =
    split(key)`` and the chunk's rounds ``split(kc, n)``."""
    key = prng.key(p.seed, device)
    out = []
    for n in _chunk_sizes(p, rows, F, K, start_t):
        key, kc = prng.split(key, 2)
        out.append(prng.split(kc, n))
    return torch.cat(out)


def _ooc_chunk_rows(p: GBMParams, data: TrainData, K: int, F: int,
                    hist_bytes: int, budget: float, ckpt) -> int | None:
    """Rows per chunk when out-of-core boosting engages, else None.
    ``H2O_TPU_OOC=1`` forces it where eligible, ``0`` turns it off, and
    otherwise it engages when the uint8 binned matrix (rows x F, the
    bundled width under EFB) passes the headroom the histogram budget
    leaves after the level histograms. Eligible is pointwise
    single-output boosting: multinomial, DRF, huber, checkpoints,
    score_every, row and column sampling and mtries stay in device
    memory, as in the JAX package."""
    env = os.environ.get("H2O_TPU_OOC", "auto")
    if env == "0":
        return None
    if K != 1 or p._drf_mode or ckpt is not None or \
            data.distribution == "huber" or p.score_every or \
            p.sample_rate < 1.0 or p.col_sample_rate_per_tree < 1.0 \
            or p.mtries > 0:
        return None
    rows = data.y.shape[0]
    if env != "1" and rows * F <= max(budget - hist_bytes, 0):
        return None
    from .tree.ooc import chunk_rows_for

    return chunk_rows_for(rows, F, budget, hist_bytes)


def _warn_goss_overflow(dropped: int) -> None:
    """A loud notice that GOSS compaction dropped selected rows: the
    static buffer is sized for the expected a+b fraction, and a frame
    whose row order follows |g| can select more than that into one
    buffer (an out-of-core chunk). The dropped rows are the high-|g|
    ones GOSS keeps, and the chunked and in-memory paths then differ."""
    if dropped <= 0:
        return
    logging.getLogger("h2o_kubernetes_tpu_torch").warning(
        "GOSS compaction overflow: %d selected row contributions were "
        "dropped because the rows (or an out-of-core chunk) selected "
        "more rows than the static capacity (sized for the expected "
        "a+b fraction). "
        "The row order likely correlates with |gradient| — shuffle "
        "the training frame, or raise H2O_TPU_GOSS_TOP_A/"
        "H2O_TPU_GOSS_RAND_B so the capacity covers the clustering.",
        dropped)


def _init_margin(y, w, off, dist: str, K: int):
    """(init score, starting margin): bernoulli's intercept MLE given
    the offset (3 Newton steps from logit(ȳ)), multinomial's log class
    priors ([K] init, [rows, K] margin), the log-link intercept MLEs
    (poisson/tweedie: e^b = Σwy / Σw·e^off; gamma: e^b = Σw·y·e^-off /
    Σw), and otherwise the weighted mean of y - offset. Every sum runs
    over the row group."""
    def gsum(t):
        return mrtask.allreduce(torch.sum(t), "sum", site="init")

    w_sum = gsum(w)
    if dist == "multinomial":
        cls = torch.where(w > 0, y, K).long()
        cls_w = mrtask.allreduce(torch.zeros(
            K + 1, dtype=w.dtype, device=w.device).index_add_(0, cls, w)[:K],
            "sum", site="init")
        # XLA's CPU log on the CPU: the priors' last bit decides f32
        # near-ties of round 0's zero-information nodes (every row one
        # gradient)
        init = xla_math.cpu_log(torch.clamp(cls_w / w_sum, min=1e-8))
        return init, init[None, :].expand(y.shape[0], K)
    if dist == "bernoulli":
        p1 = torch.clamp(gsum(y * w) / w_sum, 1e-6, 1 - 1e-6)
        init = torch.log(p1 / (1 - p1))
        for _ in range(3):
            pr = torch.sigmoid(init + off)
            num = gsum(w * (y - pr))
            den = torch.clamp(gsum(w * pr * (1.0 - pr)), min=1e-10)
            init = init + num / den
        return init, init + off
    if dist in ("poisson", "tweedie"):
        den = torch.clamp(gsum(w * torch.exp(off)), min=1e-10)
        init = torch.log(torch.clamp(gsum(y * w) / den, min=1e-8))
        return init, init + off
    if dist == "gamma":
        init = torch.log(torch.clamp(
            gsum(y * w * torch.exp(-off)) / w_sum, min=1e-8))
        return init, init + off
    init = gsum((y - off) * w) / w_sum
    return init, init + off


def _laplace_scale(y, w) -> tuple[float, float]:
    """(median, scale) of the live responses, on the host as the JAX
    package computes them: laplace fits in (y - median) / scale units,
    scale = 1.4826 · MAD, or the standard deviation where the MAD is 0
    (zero-inflated data). A row group gathers its ranks' rows first."""
    yv = mrtask.gather_rows(y).cpu().numpy()[
        mrtask.gather_rows(w).cpu().numpy() > 0]
    init = float(np.median(yv)) if len(yv) else 0.0
    mad = float(np.median(np.abs(yv - init))) if len(yv) else 1.0
    if mad * 1.4826 > 1e-8:
        return init, mad * 1.4826
    std = float(np.std(yv)) if len(yv) else 1.0
    return init, max(std, 1e-8)


def _scaled(y, init: float, scale: float):
    """(y - init) / scale in float32, dividing by a device tensor (a
    division by a Python scalar may become a multiplication by its
    reciprocal on the card)."""
    return (y - init) / torch.tensor(scale, dtype=y.dtype, device=y.device)


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
    if dist in _LOG_LINK_DISTS:
        return {"train_rmse": M.rmse(y, torch.exp(margin), w=w)}
    return {"train_rmse": M.rmse(y, margin, w=w)}


def _heap_path(i: int) -> str:
    """Dense-heap index -> 'LRL...' root descent (root itself = '')."""
    bits = []
    while i > 0:
        bits.append("L" if i % 2 == 1 else "R")   # odd = left child
        i = (i - 1) // 2
    return "".join(reversed(bits))


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
                 offset_column: str | None = None, device=None,
                 margin_scale: float = 1.0):
        """``trees``: stacked [T, N], interleaved class-fastest for K > 2
        classes; ``init_score``: a float, or the [K] class priors;
        ``margin_scale``: laplace's response scale (1 elsewhere)."""
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
                "nbins": params.nbins,
                "na_bin": bin_spec.na_bin,
                "drf_mode": bool(params._drf_mode),
                "margin_scale": float(margin_scale)}
        super().__init__(meta, arrays, device=trees.value.device
                         if device is None else device)
        self.params = params
        self.bin_spec = bin_spec
        self.trees = trees
        self.scoring_history: list[dict] = []
        self.validation_metrics: dict | None = None
        # an out-of-core train's stream sums (ooc.BinnedChunks.
        # stream_stats), None when the binned matrix stayed on the device
        self.ooc_stats: dict | None = None
        # GOSS rows dropped past the compaction buffers (None: no GOSS)
        self.goss_dropped: int | None = None
        self._varimp = _stacked_varimp(trees, data.feature_names)

    def varimp(self) -> dict[str, float]:
        """Relative importance: per-feature summed split gain, scaled."""
        v = self._varimp
        top = max(v.values()) if v else 1.0
        return {k: val / top if top > 0 else 0.0
                for k, val in sorted(v.items(), key=lambda kv: -kv[1])}

    def _binned_design(self, frame) -> torch.Tensor:
        """[F, rows] uint8 codes of ``frame`` under this model's bins,
        on the model's device, from the training-space design matrix
        (scoring-frame enum codes remapped to the training domain)."""
        from .tree.binning import apply_bins

        X = self._design_matrix(frame)
        spec = self.bin_spec
        edges = spec.edges_matrix().to(X.device)
        return torch.stack([apply_bins(X[:, j].contiguous(), edges[j],
                                       spec.is_enum[j], spec.na_bin)
                            for j in range(X.shape[1])])

    def predict_leaf_node_assignment(self, frame, type: str = "Path"):
        """Per-row resting leaf of every tree, one column per tree
        (``T1..``, class-suffixed ``T1.C1..`` for multinomial), as a
        CPU Frame: ``Path`` (default) the L/R descent string from the
        root as an enum, ``Node_ID`` the dense-heap index."""
        from ..frame import Frame

        single_process_only("predict_leaf_node_assignment")
        if type not in ("Node_ID", "Path"):
            raise ValueError("type must be 'Node_ID' or 'Path'")
        nodes = descend_trees(self.trees, self._binned_design(frame),
                              self.params.max_depth,
                              self.params.nbins).cpu().numpy()
        K = self.nclasses if self.nclasses > 2 else 1
        cols, doms = {}, {}
        for t in range(nodes.shape[0]):
            name = f"T{t // K + 1}" if K == 1 else \
                f"T{t // K + 1}.C{t % K + 1}"
            if type == "Node_ID":
                cols[name] = nodes[t].astype(np.float32)
                continue
            # only the ~2^depth distinct leaves touch Python
            uniq, inv = np.unique(nodes[t], return_inverse=True)
            paths = [_heap_path(int(i)) for i in uniq]
            dom = sorted(set(paths))
            pos = {p: j for j, p in enumerate(dom)}
            cols[name] = np.array([pos[p] for p in paths],
                                  dtype=np.int32)[inv]
            doms[name] = dom
        return Frame.from_arrays(cols, domains=doms, device="cpu")

    def predict_contributions(self, frame):
        """Per-row TreeSHAP contributions on a Frame, one column per
        feature plus ``BiasTerm``, additive to the raw margin: the
        float64 host recursion over the heap trees (``tree/shap.
        ensemble_shap``), the reference the serving kernel is held to.
        Binomial and regression models without an offset only
        (``contrib_support``)."""
        from ..frame import Frame
        from .tree.shap import ensemble_shap

        single_process_only("predict_contributions")
        reason = self.contrib_support()
        if reason:
            raise ValueError(reason)
        binned = self._binned_design(frame).T.cpu().numpy()
        trees_np = {f: getattr(self.trees, f).cpu().numpy()
                    for f in ("split_feat", "split_bin", "na_left",
                              "is_split", "value", "cover")}
        scale, init = self._contrib_scale_init()
        phi = ensemble_shap(trees_np, binned, len(self.feature_names),
                            self.bin_spec.na_bin, scale=scale)
        phi[:, -1] += init
        cols = {name: phi[:, i].astype(np.float32)
                for i, name in enumerate(self.feature_names)}
        cols["BiasTerm"] = phi[:, -1].astype(np.float32)
        return Frame.from_arrays(cols, device="cpu")


def _check_checkpoint(ckpt, p: GBMParams, data: TrainData, K: int,
                      offset_column: str | None) -> int:
    """The JAX package's checkpoint validation; returns the rounds the
    checkpoint holds (``start_t``)."""
    if list(ckpt.feature_names) != list(data.feature_names):
        raise ValueError(
            "checkpoint model was trained on different features "
            f"({ckpt.feature_names} vs {data.feature_names})")
    if ckpt.distribution != data.distribution:
        raise ValueError("checkpoint distribution mismatch")
    if ckpt.nclasses != data.nclasses or \
            (ckpt.response_domain or []) != (data.response_domain or []):
        raise ValueError(
            "checkpoint response mismatch: "
            f"{ckpt.nclasses} classes {ckpt.response_domain} vs "
            f"{data.nclasses} classes {data.response_domain}")
    n_old = int(ckpt.trees.value.shape[0])
    if p.ntrees * K <= n_old:
        raise ValueError(f"ntrees={p.ntrees} must exceed the checkpoint's "
                         f"{n_old // K} trees")
    if ckpt.params.nbins != p.nbins or \
            ckpt.params.max_depth != p.max_depth:
        raise ValueError(
            "checkpoint nbins/max_depth must match "
            f"({ckpt.params.nbins}/{ckpt.params.max_depth} vs "
            f"{p.nbins}/{p.max_depth})")
    if (ckpt.offset_column or None) != (offset_column or None):
        raise ValueError(
            "checkpoint offset_column mismatch: "
            f"{ckpt.offset_column!r} vs {offset_column!r}")
    return n_old // K


class GBM:
    """H2OGradientBoostingEstimator analog."""

    model_cls = GBMModel

    def __init__(self, **kw):
        from .cv import CVArgs

        self.cv_args = CVArgs.pop(kw)
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
        if offset_column and p._drf_mode:
            raise ValueError("offset_column is not supported for DRF")
        if p.checkpoint is not None and self.cv_args.enabled:
            # fold models would inherit trees that saw their holdout rows
            raise ValueError(
                "checkpoint cannot be combined with cross-validation")
        if self.cv_args.fold_column:
            ignored_columns = list(ignored_columns or []) + \
                [self.cv_args.fold_column]
        if p.checkpoint is not None:
            single_process_only("a checkpoint continuation")
        if self.cv_args.enabled:
            single_process_only("cross-validation")
        data = resolve_xy(training_frame, y, x, ignored_columns,
                          weights_column, p.distribution, offset_column)
        dist = data.distribution
        if dist not in _DISTRIBUTIONS:
            raise ValueError(f"unknown distribution '{dist}' (one of "
                             f"{', '.join(_DISTRIBUTIONS)})")
        if offset_column and dist in ("multinomial", "laplace"):
            raise ValueError("offset_column is not supported for "
                             f"{dist} GBM")
        if dist in _LOG_LINK_DISTS:
            ymin = float(mrtask.allreduce(torch.where(
                data.w > 0, data.y, float("inf")).min(), "min"))
            if dist == "gamma" and ymin <= 0:
                raise ValueError("gamma distribution needs a strictly "
                                 "positive response")
            if ymin < 0:
                raise ValueError(f"{dist} distribution needs a "
                                 "non-negative response")
        K = data.nclasses if data.nclasses > 2 else 1
        ckpt = p.checkpoint
        start_t = 0 if ckpt is None else \
            _check_checkpoint(ckpt, p, data, K, offset_column)
        tp = _make_tree_params(p, dist)
        F = len(data.feature_names)
        dev = training_frame.device
        # GOSS first: a bad knob or a sample_rate < 1 fails before any
        # binning. Its per-round keys come from the seed outside the
        # round-key schedule, indexed by global round.
        bp = _make_boost_params(p, dist)
        if bp.goss_b > 0:
            single_process_only("GOSS")
        if bp.goss_b > 0 and p.sample_rate < 1.0:
            raise ValueError(
                "H2O_TPU_GOSS replaces row subsampling — train with "
                f"sample_rate=1.0 (got {p.sample_rate}) or disable "
                "the GOSS knob")
        goss_keys = None if bp.goss_b <= 0 else goss_round_keys(
            prng.key(p.seed, dev), p.ntrees)[start_t:]
        # then the EFB plan: histograms, the budget and the out-of-core
        # gate run at the bundled width F_eff
        bin_spec = efb_plan = efb = None
        F_eff = F
        if efb_mod.efb_eligible(F, ckpt):
            single_process_only(f"EFB ({F} features; H2O_TPU_EFB=0 "
                                "trains unbundled)")
            bin_spec, efb_plan = efb_mod.fit_plan_cached(
                training_frame, data.feature_names, p.nbins)
            if efb_plan is not None:
                efb = efb_plan.device_luts()
                F_eff = efb_plan.fb
        # the JAX package's validation: K class trees' histograms are
        # live at once while they fit 2^30 bytes (it grows them one by
        # one past that; the port grows them in groups, drf_group_size)
        need, budget = level_hist_bytes(tp, F_eff), hist_bytes_budget()
        if K > 1 and K * need <= 2 ** 30:
            need *= K
        if need > budget:
            raise ValueError(
                f"max_depth={p.max_depth} with {F_eff} histogram columns x "
                f"{p.nbins} bins needs ~{need / 2 ** 20:.0f} MiB of level "
                f"histograms (> budget {budget / 2 ** 20:.0f} MiB). Lower "
                "max_depth or nbins, drop features, or raise "
                "H2O_TPU_HIST_BYTES_BUDGET if the device has room.")
        ooc_chunk = _ooc_chunk_rows(p, data, K, F_eff, need, budget, ckpt)
        if ooc_chunk is not None:
            single_process_only("out-of-core boosting")
        binned = None
        if ckpt is not None:
            # the checkpoint's bins, applied, so old and new trees compose
            spec = ckpt.bin_spec
            bin_spec = BinSpec(list(spec.names), list(spec.is_enum),
                               spec.n_bins, spec.edges_matrix().to(dev))
            binned = training_frame.binned(bin_spec)
        elif efb_plan is not None:
            if ooc_chunk is None:
                binned = efb_plan.binned_device()
        elif bin_spec is None and ooc_chunk is None:
            bin_spec, binned = fused_fit_bins(training_frame,
                                              data.feature_names, p.nbins)
        else:
            if bin_spec is None:
                bin_spec = fit_bins(training_frame, data.feature_names,
                                    p.nbins)
            if ooc_chunk is None:
                binned = training_frame.binned(bin_spec)
        # the padded rows of every rank: the JAX package's dispatch
        # schedule sizes its chunks by the global padded length
        rows = data.y.shape[0] * n_row_shards()
        keys = _round_keys(p, rows, F_eff, K, dev, start_t) \
            if draws_random(tp, bp, F) else None
        n_new = p.ntrees - start_t
        G = drf_group_size(K, tp, F_eff)[0]
        off = data.offset if data.offset is not None \
            else torch.zeros_like(data.y)
        margin_scale = 1.0
        old = None if ckpt is None else \
            Tree(*(a.to(dev) for a in ckpt.trees))
        if p._drf_mode:
            # no boosting: leaves are in-leaf target means, init 0
            init = np.zeros(K, dtype=np.float32) if K > 1 else 0.0
            if K == 1:
                trees = boost_trees_drf(binned, data.y, data.w, n_new, tp,
                                        bp, keys, efb)
            else:
                trees = boost_trees_multi(
                    binned, data.y, data.w, None, n_new, K, tp, bp, G,
                    keys, efb)[1]
        else:
            if ckpt is not None:
                init, margin = self._checkpoint_margin(
                    ckpt, old, binned, off, K, tp)
                if dist == "laplace":
                    # the checkpoint's scaling, so the leaf units compose;
                    # the working margin is in scaled units (leaves only)
                    margin_scale = float(ckpt.margin_scale)
                    data.y = _scaled(data.y, init, margin_scale)
                    margin = margin - init
            elif dist == "laplace":
                init, margin_scale = _laplace_scale(data.y, data.w)
                data.y = _scaled(data.y, init, margin_scale)
                margin = torch.zeros_like(data.y)
            else:
                init, margin = _init_margin(data.y, data.w, off, dist, K)
            history = []
            if ooc_chunk is not None:
                from .tree.ooc import boost_trees_chunked, make_chunks

                cks = make_chunks(training_frame, bin_spec, data.y, data.w,
                                  margin, ooc_chunk, plan=efb_plan)
                margin, trees, dropped, ooc_stats = boost_trees_chunked(
                    cks, n_new, tp, bp, efb, goss_keys)
            else:
                margin, trees, dropped, history = _boost_in_memory(
                    p, binned, data, margin, n_new, K, tp, bp, G, keys,
                    efb, goss_keys, start_t)
            if dropped is not None:
                dropped = int(dropped)
                _warn_goss_overflow(dropped)
            if isinstance(init, torch.Tensor):
                init = init.cpu().numpy() if K > 1 else float(init)
            if not np.isfinite(init).all():
                raise ValueError("no rows with positive weight and a non-NA "
                                 "response — cannot fit a prior")
        if old is not None:
            trees = Tree(*(torch.cat([a, b]) for a, b in zip(old, trees)))
        model = self.model_cls(data, p, bin_spec, trees, init, offset_column,
                               margin_scale=margin_scale)
        if ooc_chunk is not None:
            model.ooc_stats = ooc_stats
        if bp.goss_b > 0 and not p._drf_mode:
            model.goss_dropped = dropped
        if p._drf_mode:
            perf = model.model_performance(training_frame, y)
            history = [{"ntrees": p.ntrees, **{
                f"train_{k}": v for k, v in perf.items()}}]
        elif not (history and history[-1]["ntrees"] == p.ntrees):
            # a cadence dividing ntrees has scored the last round already
            history.append({"ntrees": p.ntrees, **_margin_metrics(
                dist, margin, data.y, data.w)})
        for hrow in history:
            if "train_rmse" in hrow:        # in original units
                hrow["train_rmse"] *= margin_scale
        model.scoring_history = history
        from .cv import finalize_train

        return finalize_train(
            self, model, y, training_frame,
            {"x": x, "ignored_columns": ignored_columns,
             "weights_column": weights_column,
             "offset_column": offset_column},
            validation_frame)

    @staticmethod
    def _checkpoint_margin(ckpt, old: Tree, binned, off, K: int,
                           tp: TreeParams):
        """(init, margin) a continuation starts from: the checkpoint's
        init plus its trees' leaf sums (plus the offset), per class for
        multinomial (trees interleaved class-fastest)."""
        init = np.asarray(ckpt.init_score, dtype=np.float32).reshape(-1)
        d, B = tp.max_depth, tp.n_bins
        if K == 1:
            init = float(init[0])
            return init, init + off + stack_predict(old, binned, d, B)
        margin = torch.stack([
            float(init[k]) + stack_predict(Tree(*(a[k::K] for a in old)),
                                           binned, d, B)
            for k in range(K)], dim=1)
        return init, margin


def _boost_in_memory(p: GBMParams, binned, data: TrainData, margin,
                     n_new: int, K: int, tp: TreeParams, bp, G: int, keys,
                     efb, goss_keys, start_t: int):
    """The boosting rounds on a device-resident binned matrix, in
    segments of ``score_every`` rounds (one segment without a cadence),
    a scoring-history row of the training metrics after each full
    segment. Returns (margin, trees, GOSS rows dropped or None,
    history)."""
    score = _score_cadence(p)
    step = score or n_new
    parts, dropped, history = [], None, []
    for s in range(0, n_new, step):
        e = min(s + step, n_new)
        ks = None if keys is None else keys[s:e]
        gk = None if goss_keys is None else goss_keys[s:e]
        if K == 1:
            margin, t, dr = boost_trees(binned, data.y, data.w, margin,
                                        e - s, tp, bp, ks, efb, gk)
        else:
            margin, t, dr = boost_trees_multi(binned, data.y, data.w,
                                              margin, e - s, K, tp, bp, G,
                                              ks, efb, gk)
        parts.append(t)
        if dr is not None:
            dropped = dr if dropped is None else dropped + dr
        if score and e % score == 0:
            history.append({"ntrees": start_t + e, **_margin_metrics(
                data.distribution, margin, data.y, data.w)})
    trees = parts[0] if len(parts) == 1 else \
        Tree(*(torch.cat(a) for a in zip(*parts)))
    return margin, trees, dropped, history


def gbm_model_from_arrays(trees: dict, edges, is_enum, init_score,
                          feature_names: list[str], distribution: str,
                          nclasses: int, max_depth: int,
                          response_domain: list[str] | None = None,
                          feature_domains: dict | None = None,
                          device=None, offset_column: str | None = None,
                          margin_scale: float = 1.0, model_cls=None,
                          **params) -> GBMModel:
    """A port ``GBMModel`` (``DRFModel`` with ``_drf_mode=True``) from
    another package's trained GBM or DRF, as numpy: ``trees`` maps each
    ``Tree`` field to its stacked [T, N] array (interleaved
    class-fastest for K > 2 classes), ``edges`` is the [F, B-2]
    bin-edge matrix, ``is_enum`` the per-feature enum flags,
    ``init_score`` the prior (a float, or the [K] class priors),
    ``margin_scale`` laplace's response scale, ``model_cls`` the model
    class (default ``GBMModel``, ``DRFModel`` under ``_drf_mode``).
    ``params`` are GBMParams fields (``max_depth`` is required; it
    sizes the descent). The model
    scores, explains and seeds a checkpoint continuation as the source
    model does."""
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
                   ntrees=int(tree.value.shape[0]) // max(
                       1, nclasses if nclasses > 2 else 1), **params)
    cls = model_cls or GBMModel
    if gp._drf_mode:
        from .drf import DRFModel as cls
    return cls(data, gp, spec, tree, init_score, offset_column,
               device=dev, margin_scale=margin_scale)
