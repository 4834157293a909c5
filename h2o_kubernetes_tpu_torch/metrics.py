"""Model metrics: AUC, the binomial threshold table (``binomial_stats``:
precision-recall AUC, Gini, max F1 and its threshold, mean per-class
error, the confusion matrix), logloss, multinomial logloss, accuracy,
RMSE, MAE, R², the gaussian or poisson mean residual deviance, and the
ranking metric NDCG@k (``ndcg``, numpy on the host).

Inputs may be numpy arrays or tensors; the metric runs on the device
of ``score``/``pred`` when that is a tensor (the CPU otherwise) and
returns a Python float. Rows with weight 0 are excluded, and a NaN on a
live row makes the metric NaN rather than a plausible number.

On a row group (``runtime/mesh.py``) the inputs are this rank's rows
and every metric is the global one, the same on every rank: weighted
sums are all-reduced, the AUC's score histogram is built on the local
rows (the CUDA kernel on a card) and all-reduced after a global min and
max fix its bins, and the exact AUC (65,536 rows or fewer in all)
gathers the rows. NDCG stays on the host, single-process.
"""

from __future__ import annotations

import numpy as np
import torch

from .runtime import mrtask
from .runtime.mesh import global_mesh

__all__ = ["roc_auc", "binomial_stats", "binomial_auc_and_stats",
           "confusion_matrix", "logloss", "multinomial_logloss",
           "accuracy", "rmse", "mae", "r2", "mean_residual_deviance",
           "ndcg"]

_AUC_BINS = 4096        # score-histogram bins of the AUC's histogram path
_AUC_EXACT_MAX = 65536  # above this many rows the histogram path is used
# the reductions of logloss, RMSE, MAE and R² accumulate in float64: a
# float32 running sum over n rows drifts by up to ~n·2^-24 of the total
# with the summation order
_ACC = torch.float64


def _grouped() -> bool:
    return global_mesh().world_size > 1


def _gsum(t: torch.Tensor) -> torch.Tensor:
    """A sum over the row group (the identity alone)."""
    return mrtask.allreduce(t, "sum", site="metrics")


def _gmean(t: torch.Tensor) -> torch.Tensor:
    """The float64 mean of ``t``'s rows over the row group (alone,
    ``torch.mean``)."""
    if not _grouped():
        return torch.mean(t, dtype=_ACC)
    n = torch.tensor(float(t.shape[0]), dtype=_ACC, device=t.device)
    return _gsum(torch.sum(t, dtype=_ACC)) / _gsum(n)


def _grows(n: int) -> int:
    """The row count over the row group."""
    return int(_gsum(torch.tensor(n))) if _grouped() else n


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
        exact = _grows(y.shape[0]) <= _AUC_EXACT_MAX
    return float(_auc_exact(y, s, wt) if exact else _auc_hist(y, s, wt))


def _auc_exact(y, s, wt):
    if _grouped():
        y, s, wt = (mrtask.gather_rows(a, site="metrics")
                    for a in (y, s, wt))
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
    """([NB, 2] (pos, neg) weight per score bin, smin, smax, bad): bad
    flags a NaN on a live row.
    NaN scores park at 0 with ``bad`` set; ±inf scores pin to the end
    bins and do not set the bin scale. On a row group the flag, the
    bounds and the histogram are the group's."""
    from .ops.histogram import build_histogram

    live = wt > 0
    bad = mrtask.allreduce(
        (live & (torch.isnan(y) | torch.isnan(s))).any(), "max",
        site="metrics")
    y = torch.where(live, torch.nan_to_num(y), 0.0)
    sx = torch.where(live & ~torch.isnan(s), s, 0.0)
    fin = live & torch.isfinite(sx)
    smin = mrtask.allreduce(torch.where(fin, sx, float("inf")).min(),
                            "min", site="metrics")
    smax = mrtask.allreduce(torch.where(fin, sx, float("-inf")).max(),
                            "max", site="metrics")
    scale = (_AUC_BINS - 1) / torch.clamp(smax - smin, min=1e-30)
    idx = ((sx - smin) * scale).clamp(0, _AUC_BINS - 1).to(torch.int32)
    idx = torch.where(sx == float("inf"), _AUC_BINS - 1, idx)
    idx = torch.where(sx == float("-inf"), 0, idx)
    rel = torch.where(live, 0, -1).to(torch.int32)
    codes = idx.to(torch.int16)[None, :]                      # [1, rows]
    hist = build_histogram(codes, rel, y, 1.0 - y, wt, 1, _AUC_BINS)[0, 0]
    return _gsum(hist[:, :2]), smin, smax, bad


def _auc_hist(y, s, wt):
    hist, _, _, bad = _score_hist(y, s, wt)
    return _auc_of_hist(hist, bad)


def _auc_of_hist(hist, bad):
    posb, negb = hist[:, 0], hist[:, 1]
    below = torch.cumsum(negb, dim=0) - negb
    auc = torch.sum(posb * (below + 0.5 * negb)) / \
        (torch.sum(posb) * torch.sum(negb))
    return torch.where(bad, float("nan"), auc)


def binomial_stats(y_true, p1, w=None) -> dict:
    """The binomial threshold table from one 4096-bin score histogram
    (``_score_hist``: the CUDA kernel's launch on a card), swept on the
    host over the bin-edge thresholds as the JAX package does: auc,
    gini, pr_auc, max F1 and its threshold, the best accuracy, the mean
    per-class error at the F1-optimal threshold and the confusion
    counts there. Raises ValueError when a class is absent."""
    return _stats_of_hist(*_score_hist(*_inputs(y_true, p1, w)))


def binomial_auc_and_stats(y_true, p1) -> tuple[float, dict | None]:
    """``roc_auc(y_true, p1)`` and ``binomial_stats(y_true, p1)`` (None
    when a class is absent), bit for bit, from one score histogram:
    past 65,536 rows the AUC is read from the histogram the threshold
    table is swept over, so a card launches the kernel once."""
    y, s, wt = _inputs(y_true, p1, None)
    sh = _score_hist(y, s, wt)
    auc = _auc_exact(y, s, wt) if _grows(y.shape[0]) <= _AUC_EXACT_MAX \
        else _auc_of_hist(sh[0], sh[3])
    try:
        stats = _stats_of_hist(*sh)
    except ValueError:                      # one class in the holdout
        stats = None
    return float(auc), stats


def _stats_of_hist(hist, smin, smax, bad) -> dict:
    if bool(bad):
        nan = float("nan")
        return {k: nan for k in
                ("auc", "gini", "pr_auc", "f1", "max_f1_threshold",
                 "accuracy", "mean_per_class_error")} | {
                "confusion": np.full((2, 2), nan)}
    hist = hist.cpu().numpy()
    pos, neg = hist[:, 0].astype(np.float64), hist[:, 1].astype(np.float64)
    P, N = pos.sum(), neg.sum()
    if P == 0 or N == 0:
        raise ValueError("binomial metrics need both classes present")
    # threshold k: predict positive when the score bin >= k
    tp = np.cumsum(pos[::-1])[::-1]
    fp = np.cumsum(neg[::-1])[::-1]
    fn = P - tp
    tn = N - fp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 1.0)
        recall = tp / P
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    acc = (tp + tn) / (P + N)
    k_f1 = int(np.argmax(f1))
    span = max(float(smax) - float(smin), 1e-30)
    thr = float(smin) + k_f1 * span / (_AUC_BINS - 1)
    # precision-recall AUC: trapezoid over (recall, precision) with the
    # (0, 1) endpoint of an above-max-score threshold appended
    r_ext = np.append(recall, 0.0)
    p_ext = np.append(precision, 1.0)
    order = np.argsort(r_ext)
    trap = np.trapezoid if hasattr(np, "trapezoid") else np.trapz
    pr_auc = float(trap(p_ext[order], r_ext[order]))
    auc = float(_auc_from_hist(pos, neg))
    return {
        "auc": auc,
        "gini": 2 * auc - 1,
        "pr_auc": pr_auc,
        "f1": float(f1[k_f1]),
        "max_f1_threshold": thr,
        "accuracy": float(acc.max()),
        "mean_per_class_error": float(
            0.5 * (fn[k_f1] / P + fp[k_f1] / N)),
        "confusion": np.array([[tn[k_f1], fp[k_f1]],
                               [fn[k_f1], tp[k_f1]]]),
    }


def _auc_from_hist(pos, neg):
    below = np.cumsum(neg) - neg
    return (pos * (below + 0.5 * neg)).sum() / (pos.sum() * neg.sum())


def confusion_matrix(y_true, p1, threshold: float | None = None,
                     w=None) -> np.ndarray:
    """2x2 [[TN, FP], [FN, TP]] (rows actual, columns predicted) at
    ``threshold``, or at the F1-optimal one when None."""
    if threshold is None:
        return binomial_stats(y_true, p1, w=w)["confusion"]
    y, p, wt = (mrtask.gather_rows(a, site="metrics").cpu().numpy()
                for a in _inputs(y_true, p1, w))
    pred = p >= threshold
    pos = y > 0
    tp = float(wt[pred & pos].sum())
    fp = float(wt[pred & ~pos].sum())
    fn = float(wt[~pred & pos].sum())
    tn = float(wt[~pred & ~pos].sum())
    return np.array([[tn, fp], [fn, tp]])


def logloss(y_true, p, eps: float = 1e-7, w=None) -> float:
    y, p, wt = _inputs(y_true, p, w)
    p = torch.clamp(p, eps, 1 - eps)
    if w is None:
        return float(-_gmean(y * torch.log(p) + (1 - y) * torch.log1p(-p)))
    live = wt > 0
    bad = _gsum((live & torch.isnan(y)).any().to(torch.int32)) > 0
    y = torch.where(live, torch.nan_to_num(y), 0.0)
    ll = y * torch.log(p) + (1 - y) * torch.log1p(-p)
    out = -_gsum(torch.sum(wt * torch.where(live, ll, 0.0), dtype=_ACC)) \
        / _gsum(torch.sum(wt, dtype=_ACC))
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
        return float(-_gmean(ll))
    wt = _vec(w, dev)
    live = wt > 0
    bad = _gsum((live & torch.isnan(yraw)).any().to(torch.int32)) > 0
    out = -_gsum(torch.sum(wt * torch.where(live, ll, 0.0), dtype=_ACC)) \
        / _gsum(torch.sum(wt, dtype=_ACC))
    return float(torch.where(bad, float("nan"), out))


def accuracy(y_true, label) -> float:
    """Share of rows whose label equals the response."""
    dev = label.device if isinstance(label, torch.Tensor) else "cpu"
    y, lab = _vec(y_true, dev), _vec(label, dev)
    return float(_gmean((y == lab).to(_ACC)))


def rmse(y_true, pred, w=None) -> float:
    y, p, wt = _inputs(y_true, pred, w)
    if w is None:
        return float(torch.sqrt(_gmean((y - p) ** 2)))
    live = wt > 0
    bad = _gsum((live & torch.isnan(y - p)).any().to(torch.int32)) > 0
    se = torch.where(live, torch.nan_to_num(y - p) ** 2, 0.0)
    out = torch.sqrt(_gsum(torch.sum(wt * se, dtype=_ACC))
                     / _gsum(torch.sum(wt, dtype=_ACC)))
    return float(torch.where(bad, float("nan"), out))


def mae(y_true, pred) -> float:
    y, p, _ = _inputs(y_true, pred, None)
    return float(_gmean(torch.abs(y - p)))


def r2(y_true, pred) -> float:
    y, p, _ = _inputs(y_true, pred, None)
    ss_res = _gsum(torch.sum((y - p) ** 2, dtype=_ACC))
    ss_tot = _gsum(torch.sum((y.double() - _gmean(y)) ** 2))
    return float(1.0 - ss_res / ss_tot)


def mean_residual_deviance(y_true, pred, distribution: str = "gaussian"
                           ) -> float:
    """Mean residual deviance: gaussian, the mean squared error;
    poisson, 2·mean(y·log(y/p) - (y - p)) with p clamped to 1e-10."""
    y, p, _ = _inputs(y_true, pred, None)
    if distribution == "gaussian":
        return float(_gmean((y - p) ** 2))
    if distribution == "poisson":
        p = torch.clamp(p, min=1e-10)
        yl = torch.where(y > 0, y * torch.log(y / p), 0.0)
        return float(2.0 * _gmean(yl - (y - p)))
    raise ValueError(distribution)


def ndcg(y_true, score, group, k: int = 10) -> float:
    """Mean NDCG@k over query groups, in float64 numpy on the host (the
    JAX package's ``metrics.ndcg``, step for step). ``y_true``: graded
    relevance per row; ``group``: query id per row. Within a group the
    top k rows by score (ties in row order) give the DCG, with gain
    2^rel - 1 and discount 1/log2(rank + 1); groups with no relevant row
    (ideal DCG 0) are left out of the mean."""
    y = np.asarray(y_true).ravel().astype(np.float64)
    s = np.asarray(score).ravel().astype(np.float64)
    g = np.asarray(group).ravel()
    # one argsort by group, then contiguous slices
    order = np.argsort(g, kind="stable")
    y, s, g = y[order], s[order], g[order]
    _, starts = np.unique(g, return_index=True)
    bounds = np.append(starts, len(g))
    total, n = 0.0, 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        yy, ss = y[a:b], s[a:b]
        kk = min(k, b - a)
        disc = 1.0 / np.log2(np.arange(2, kk + 2))
        top = np.argsort(-ss, kind="stable")[:kk]
        dcg = ((2.0 ** yy[top] - 1.0) * disc).sum()
        ideal = np.sort(2.0 ** yy - 1.0)[::-1]
        idcg = (ideal[:kk] * disc).sum()
        if idcg > 0:
            total += dcg / idcg
            n += 1
    return total / max(n, 1)
