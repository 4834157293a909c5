"""Naive Bayes (the JAX package's ``models/naivebayes.py``,
hex/naivebayes's analog): per-class priors, per-(class, numeric
feature) mean and standard deviation, and per-(class, categorical
level) frequencies from one pass over the rows; prediction is the
softmax of the log-prior plus the Gaussian and frequency
log-likelihoods, NA cells dropped. Laplace smoothing for the level
frequencies, a ``min_sdev`` floor for the deviations.

The reference's one-hot matmul map-reduce is, on one device, float64
``index_add_`` by class on the frame's device: the class weights, the
numeric sums and counts, then Σw·(x − mean)² (two passes, as
``Vec.rollups``), and the level counts by (class, level). The tables
are rounded once to float32; scoring sums each row's log-likelihoods
in float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..frame import Frame
from ..runtime.mesh import single_process_only
from .base import LearnerModel, TrainData, resolve_xy
from .datainfo import design

__all__ = ["NaiveBayes", "NaiveBayesModel", "NaiveBayesParams"]


@dataclass
class NaiveBayesParams:
    laplace: float = 0.0
    min_sdev: float = 1e-3
    seed: int = 0


class NaiveBayesModel(LearnerModel):
    algo = "naivebayes"

    def __init__(self, data: TrainData, params: NaiveBayesParams,
                 priors, num_mean, num_sd, enum_tables, enum_cols,
                 num_cols, device):
        self._init_layout(data, device)
        self.params = params
        dev = self.device
        self.priors = torch.as_tensor(priors, device=dev)        # [K]
        self.num_mean = torch.as_tensor(num_mean, device=dev)    # [K, Fn]
        self.num_sd = torch.as_tensor(num_sd, device=dev)        # [K, Fn]
        self.enum_tables = [torch.as_tensor(t, device=dev)       # [K, L]
                            for t in enum_tables]
        self.enum_cols = list(enum_cols)    # X columns of the enums
        self.num_cols = list(num_cols)      # X columns of the numerics

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        """[r, K] class probabilities of raw rows (NA cells drop out).
        The log-likelihoods are summed in float64 (a row's sum over
        dozens of features moves its probabilities by ~1e-5 in float32)
        and the probabilities rounded once to float32."""
        K = self.nclasses
        X = X.double()
        ll = torch.log(self.priors.double())[None, :].expand(X.shape[0],
                                                             K)
        if self.num_cols:
            Xn = X[:, self.num_cols]                            # [r, Fn]
            sd = self.num_sd.double()
            z = (Xn[:, None, :] - self.num_mean.double()[None]) / sd[None]
            lp = -0.5 * z * z - torch.log(sd)[None]
            lp = torch.where(torch.isnan(Xn)[:, None, :], 0.0, lp)
            ll = ll + lp.sum(dim=2)
        for ci, tab in zip(self.enum_cols, self.enum_tables):
            c = X[:, ci]
            L = tab.shape[1]
            code = torch.where(torch.isnan(c), 0.0, c).long() \
                .clamp(0, L - 1)
            lp = torch.log(tab.double().T)[code]                # [r, K]
            ll = ll + torch.where(torch.isnan(c)[:, None], 0.0, lp)
        m = ll.max(dim=1, keepdim=True).values
        p = torch.exp(ll - m)
        return (p / p.sum(dim=1, keepdim=True)).float()

    @property
    def _artifact_meta(self) -> dict:
        return dict(self._meta_common(), num_cols=list(self.num_cols),
                    enum_cols=list(self.enum_cols),
                    n_enum_tables=len(self.enum_tables))

    @property
    def _artifact_arrays(self) -> dict:
        out = {"priors": self.priors.cpu().numpy(),
               "num_mean": self.num_mean.cpu().numpy(),
               "num_sd": self.num_sd.cpu().numpy()}
        for i, t in enumerate(self.enum_tables):
            out[f"nbtab_{i}"] = t.cpu().numpy()
        return out


def _class_stats(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, K: int,
                num_cols: list[int], enum_cols: list[int],
                enum_L: list[int]) -> dict:
    """The per-class sums as float64 numpy: ``class_w`` [K], ``n_cnt``,
    ``n_mean``, ``n_ss`` [K, Fn] (weighted count, mean and Σw(x−mean)²
    of each numeric column's non-NA cells) and ``e{j}`` [K, L] (weighted
    level counts, NA cells left out)."""
    dev = X.device
    cls = torch.where(w > 0, y.long(), K)        # dropped rows -> slot K
    wd = w.double()
    out = {"class_w": torch.zeros(K + 1, dtype=torch.float64, device=dev)
           .index_add_(0, cls, wd)[:K].cpu().numpy()}
    if num_cols:
        Xn = X[:, num_cols].double()
        val = ~torch.isnan(Xn)
        wv = torch.where(val, wd[:, None], 0.0)
        x0 = torch.where(val, Xn, 0.0)
        acc = torch.zeros((K + 1, len(num_cols)), dtype=torch.float64,
                          device=dev)
        cnt = acc.clone().index_add_(0, cls, wv)
        s = acc.clone().index_add_(0, cls, wv * x0)
        mean = s / torch.clamp(cnt, min=1.0)
        d = torch.where(val, x0 - mean[cls], 0.0)
        ss = acc.clone().index_add_(0, cls, wv * d * d)
        out.update(n_cnt=cnt[:K].cpu().numpy(),
                   n_mean=mean[:K].cpu().numpy(), n_ss=ss[:K].cpu().numpy())
    for j, (ci, L) in enumerate(zip(enum_cols, enum_L)):
        c = X[:, ci]
        ok = ~torch.isnan(c)
        seg = torch.where(ok, cls * L + torch.nan_to_num(c).long(),
                          (K + 1) * L)
        tab = torch.zeros((K + 1) * L + 1, dtype=torch.float64, device=dev)
        tab.index_add_(0, seg, wd)
        out[f"e{j}"] = tab[: K * L].reshape(K, L).cpu().numpy()
    return out


class NaiveBayes:
    """H2ONaiveBayesEstimator analog (classification only)."""

    def __init__(self, **kw):
        from .cv import CVArgs

        self.cv_args = CVArgs.pop(kw)
        self.params = NaiveBayesParams(**kw)

    def train(self, y: str, training_frame: Frame,
              x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              weights_column: str | None = None,
              validation_frame: Frame | None = None) -> NaiveBayesModel:
        single_process_only("NaiveBayes")
        p = self.params
        if self.cv_args.fold_column:
            ignored_columns = list(ignored_columns or []) + \
                [self.cv_args.fold_column]
        data = resolve_xy(training_frame, y, x, ignored_columns,
                          weights_column, "auto")
        if data.nclasses < 2:
            raise ValueError("NaiveBayes needs a categorical response")
        K = data.nclasses
        names = data.feature_names
        num_cols = [i for i, n in enumerate(names)
                    if n not in data.feature_domains]
        enum_cols = [i for i, n in enumerate(names)
                     if n in data.feature_domains]
        enum_L = [len(data.feature_domains[names[i]]) for i in enum_cols]
        X = design(training_frame, names)
        st = _class_stats(X, data.y, data.w, K, num_cols, enum_cols, enum_L)
        cw = st["class_w"]
        priors = cw / cw.sum()
        if num_cols:
            cnt = np.maximum(st["n_cnt"], 1.0)
            mean = st["n_mean"]
            sd = np.maximum(np.sqrt(np.maximum(st["n_ss"] / cnt, 0.0)),
                            p.min_sdev)
        else:
            mean = sd = np.zeros((K, 0))
        tables = []
        for j in range(len(enum_cols)):
            t = st[f"e{j}"] + p.laplace
            denom = t.sum(axis=1, keepdims=True)
            denom = np.where(denom > 0, denom, 1.0)
            tables.append(np.maximum(t / denom, 1e-10).astype(np.float32))
        model = NaiveBayesModel(
            data, p, priors.astype(np.float32), mean.astype(np.float32),
            sd.astype(np.float32), tables, enum_cols, num_cols,
            training_frame.device)
        from .cv import finalize_train

        return finalize_train(
            self, model, y, training_frame,
            {"x": x, "ignored_columns": ignored_columns,
             "weights_column": weights_column}, validation_frame)
