"""Model metrics of the training slices: AUC, logloss, multinomial
logloss, accuracy, RMSE, MAE, R².

Inputs may be numpy arrays or tensors; the metric runs on the device
of ``score``/``pred`` when that is a tensor (the CPU otherwise) and
returns a Python float. Rows with weight 0 are excluded, and a NaN on a
live row makes the metric NaN rather than a plausible number.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["roc_auc", "logloss", "multinomial_logloss", "accuracy",
           "rmse", "mae", "r2", "mean_residual_deviance"]

_AUC_BINS = 4096        # score-histogram bins of the AUC's histogram path
_AUC_EXACT_MAX = 65536  # above this many rows the histogram path is used
# the reductions of logloss, RMSE, MAE and R² accumulate in float64: a
# float32 running sum over n rows drifts by up to ~n·2^-24 of the total
# with the summation order
_ACC = torch.float64


def _vec(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(-1)
    return torch.as_tensor(np.asarray(x, dtype=np.float32).reshape(-1),
                           device=device)


def _inputs(y_true, score, w):
    dev = score.device if isinstance(score, torch.Tensor) else "cpu"
    y, s = _vec(y_true, dev), _vec(score, dev)
    wt = torch.ones_like(y) if w is None else _vec(w, dev)
    return y, s, wt


def roc_auc(y_true, score, w=None, exact: bool | None = None) -> float:
    """AUC with average-rank tie handling (Mann-Whitney U). Exact (a
    full sort) up to 65,536 rows or when ``exact``; otherwise from a
    4096-bin score histogram with in-bin pairs tied at 0.5, built by
    ``ops/histogram.build_histogram`` (the CUDA kernel on a card)."""
    y, s, wt = _inputs(y_true, score, w)
    if exact is None:
        exact = y.shape[0] <= _AUC_EXACT_MAX
    return float(_auc_exact(y, s, wt) if exact else _auc_hist(y, s, wt))


def _auc_exact(y, s, wt):
    live = wt > 0
    bad = (live & (torch.isnan(y) | torch.isnan(s))).any()
    wt = torch.where(live, wt, 0.0)
    y = torch.where(live, torch.nan_to_num(y), 0.0)
    s = torch.where(live, torch.nan_to_num(s), float("inf"))  # dead last
    order = torch.argsort(s, stable=True)
    ss, ys, ws = s[order], y[order], wt[order]
    negw = ws * (1.0 - ys)
    posw = ws * ys
    cneg = torch.cumsum(negw, dim=0)
    lo = torch.searchsorted(ss, ss, side="left")
    hi = torch.searchsorted(ss, ss, side="right")
    below = torch.where(lo > 0, cneg[(lo - 1).clamp(min=0)], 0.0)
    tied = cneg[hi - 1] - below
    auc = torch.sum(posw * (below + 0.5 * tied)) / \
        (torch.sum(posw) * torch.sum(negw))
    return torch.where(bad, float("nan"), auc)


def _score_hist(y, s, wt):
    """[NB, 2] (pos, neg) weight per score bin + bad (NaN on a live row).
    NaN scores park at 0 with ``bad`` set; ±inf scores pin to the end
    bins and do not set the bin scale."""
    from .ops.histogram import build_histogram

    live = wt > 0
    bad = (live & (torch.isnan(y) | torch.isnan(s))).any()
    y = torch.where(live, torch.nan_to_num(y), 0.0)
    sx = torch.where(live & ~torch.isnan(s), s, 0.0)
    fin = live & torch.isfinite(sx)
    smin = torch.where(fin, sx, float("inf")).min()
    smax = torch.where(fin, sx, float("-inf")).max()
    scale = (_AUC_BINS - 1) / torch.clamp(smax - smin, min=1e-30)
    idx = ((sx - smin) * scale).clamp(0, _AUC_BINS - 1).to(torch.int32)
    idx = torch.where(sx == float("inf"), _AUC_BINS - 1, idx)
    idx = torch.where(sx == float("-inf"), 0, idx)
    rel = torch.where(live, 0, -1).to(torch.int32)
    codes = idx.to(torch.int16)[None, :]                      # [1, rows]
    hist = build_histogram(codes, rel, y, 1.0 - y, wt, 1, _AUC_BINS)[0, 0]
    return hist[:, :2], bad


def _auc_hist(y, s, wt):
    hist, bad = _score_hist(y, s, wt)
    posb, negb = hist[:, 0], hist[:, 1]
    below = torch.cumsum(negb, dim=0) - negb
    auc = torch.sum(posb * (below + 0.5 * negb)) / \
        (torch.sum(posb) * torch.sum(negb))
    return torch.where(bad, float("nan"), auc)


def logloss(y_true, p, eps: float = 1e-7, w=None) -> float:
    y, p, wt = _inputs(y_true, p, w)
    p = torch.clamp(p, eps, 1 - eps)
    if w is None:
        return float(-torch.mean(y * torch.log(p) + (1 - y) * torch.log1p(-p),
                                 dtype=_ACC))
    live = wt > 0
    bad = (live & torch.isnan(y)).any()
    y = torch.where(live, torch.nan_to_num(y), 0.0)
    ll = y * torch.log(p) + (1 - y) * torch.log1p(-p)
    out = -torch.sum(wt * torch.where(live, ll, 0.0), dtype=_ACC) \
        / torch.sum(wt, dtype=_ACC)
    return float(torch.where(bad, float("nan"), out))


def multinomial_logloss(y_true, probs, eps: float = 1e-7, w=None
                        ) -> float:
    """y_true: [n] class ids; probs: [n, K] -> mean -log p[y] with p
    clamped to [eps, 1]."""
    dev = probs.device if isinstance(probs, torch.Tensor) else "cpu"
    yraw = _vec(y_true, dev)
    y = torch.nan_to_num(yraw).long()
    p = torch.as_tensor(probs, dtype=torch.float32, device=dev)
    ll = torch.log(torch.clamp(p, eps, 1.0).gather(1, y[:, None])[:, 0])
    if w is None:
        return float(-torch.mean(ll, dtype=_ACC))
    wt = _vec(w, dev)
    live = wt > 0
    bad = (live & torch.isnan(yraw)).any()
    out = -torch.sum(wt * torch.where(live, ll, 0.0), dtype=_ACC) \
        / torch.sum(wt, dtype=_ACC)
    return float(torch.where(bad, float("nan"), out))


def accuracy(y_true, label) -> float:
    """Share of rows whose label equals the response."""
    dev = label.device if isinstance(label, torch.Tensor) else "cpu"
    y, lab = _vec(y_true, dev), _vec(label, dev)
    return float(torch.mean((y == lab).to(_ACC)))


def rmse(y_true, pred, w=None) -> float:
    y, p, wt = _inputs(y_true, pred, w)
    if w is None:
        return float(torch.sqrt(torch.mean((y - p) ** 2, dtype=_ACC)))
    live = wt > 0
    bad = (live & torch.isnan(y - p)).any()
    se = torch.where(live, torch.nan_to_num(y - p) ** 2, 0.0)
    out = torch.sqrt(torch.sum(wt * se, dtype=_ACC)
                     / torch.sum(wt, dtype=_ACC))
    return float(torch.where(bad, float("nan"), out))


def mae(y_true, pred) -> float:
    y, p, _ = _inputs(y_true, pred, None)
    return float(torch.mean(torch.abs(y - p), dtype=_ACC))


def r2(y_true, pred) -> float:
    y, p, _ = _inputs(y_true, pred, None)
    ss_res = torch.sum((y - p) ** 2, dtype=_ACC)
    ss_tot = torch.sum((y.double() - torch.mean(y, dtype=_ACC)) ** 2)
    return float(1.0 - ss_res / ss_tot)


def mean_residual_deviance(y_true, pred) -> float:
    """Gaussian deviance: the mean squared error."""
    y, p, _ = _inputs(y_true, pred, None)
    return float(torch.mean((y - p) ** 2, dtype=_ACC))
