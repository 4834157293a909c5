"""XGBoost-hist semantics on the port's histogram tree core, on one
device.

``XGBoost(...).train(y=..., training_frame=...)`` is the JAX package's
entry point. XGBoost is the port's ``GBM`` with XGBoost's defaults and
spellings: eta 0.3, depth 6, ``reg_lambda`` 1 (the regularized gain and
leaf value of ``core.TreeParams``), ``min_child_weight`` 1 on hessian
mass, ``gamma`` as the minimum split gain, and the objective aliases
(``reg:squarederror``, ``binary:logistic``, ``multi:softprob``,
``count:poisson``). A pointwise objective trains through ``GBM.train``
(the histogram kernel at every level; K class trees per launch for
``multi:softprob``) and its model exports and serves like a GBM's, as
``algo="xgboost"``. Pointwise objectives take GOSS, EFB and out-of-core
boosting through ``GBM.train`` under the same knobs; ``rank:*``
objectives take neither GOSS nor EFB, as in the JAX package (the
ranking round grows and re-descends the unbundled matrix).

Learning to rank: ``rank:pairwise`` and ``rank:ndcg`` (LambdaMART) over
a query ``group_column``. Each round computes the pairwise lambda
gradients of every query group in a dense [groups, docs] layout, grows
one tree from them through ``core._grow_trees`` and adds its leaves to
the margin. The JAX package maps fixed batches of ``ndcg_group_batch``
groups, each padded to the largest group; the port sorts the groups by
size and cuts the dense layout into batches of at least that many
groups whose pair tensors [groups, width, width] stay within
``_PAIR_ELEMS`` elements, each as wide as its largest group. A group's
gradients do not depend on its batch (padded slots pair with nothing
and rank last), so they equal the reference's up to f32 summation
order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import metrics as M
from ..runtime import prng
from ..runtime.mesh import single_process_only
from .base import resolve_xy
from .gbm import GBM, GBMModel, gbm_model_from_arrays
from .tree.binning import fused_fit_bins
from .tree.core import Tree, TreeParams, _grow_trees

__all__ = ["XGBoost", "XGBoostModel", "xgboost_model_from_arrays"]

_OBJECTIVE_ALIASES = {
    "reg:squarederror": "gaussian",
    "reg:linear": "gaussian",
    "binary:logistic": "bernoulli",
    "multi:softprob": "multinomial",
    "multi:softmax": "multinomial",
    "count:poisson": "poisson",
    "rank:pairwise": "rank:pairwise",
    "rank:ndcg": "rank:ndcg",
}
# elements of one lambda batch's [groups, width, width] pair tensors:
# about eight of them are live at once (4 bytes each)
_PAIR_ELEMS = 1 << 25


class XGBoostModel(GBMModel):
    """A trained XGBoost model; ranking models score raw margins."""

    algo = "xgboost"
    _group_column: str | None = None

    def model_performance(self, frame, y: str,
                          group_column: str | None = None,
                          k: int = 10) -> dict[str, float]:
        """Ranking models: ``ndcg@k`` over the query groups of
        ``group_column`` (default: the training one); pointwise ones:
        the GBM metrics."""
        if self.distribution.startswith("rank:"):
            gcol = group_column or self._group_column
            score = self.predict_raw(frame)
            yv = frame.vec(y).to_numpy()
            g = frame.vec(gcol).to_numpy()
            return {f"ndcg@{k}": M.ndcg(yv, score, g, k=k)}
        return super().model_performance(frame, y)


# ---------------------------------------------------------------------------
# LambdaMART gradients
# ---------------------------------------------------------------------------

class _GroupLayout:
    """Host-side query-group layout: row order <-> dense [G, M]. ``idx``
    [G, M] is the row of each slot (-1 past the group's end), ``pos``
    [padded_len] each row's flat slot (-1 for none), ``mask`` [G, M]
    the filled slots; rows keep their order within a group."""

    def __init__(self, group_ids: np.ndarray, padded_len: int):
        uniq, inv = np.unique(group_ids, return_inverse=True)
        self.n_groups = len(uniq)
        sizes = np.bincount(inv, minlength=self.n_groups)
        self.sizes = sizes
        self.max_docs = int(sizes.max()) if len(sizes) else 1
        G, Mx = self.n_groups, self.max_docs
        order = np.argsort(inv, kind="stable")       # rows grouped together
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        slot = np.arange(len(inv)) - starts[inv[order]]  # within-group slot
        idx = np.full(G * Mx, -1, dtype=np.int32)
        pos = np.full(padded_len, -1, dtype=np.int32)
        flat = inv[order] * Mx + slot
        idx[flat] = order.astype(np.int32)
        pos[order] = flat.astype(np.int32)
        self.idx = idx.reshape(G, Mx)
        self.pos = pos
        self.mask = self.idx >= 0


def _ideal_dcg(y_dense: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[G] max DCG per group over its whole list (the normalizer)."""
    gains = torch.where(mask, 2.0 ** y_dense - 1.0, 0.0)
    srt = torch.sort(gains, dim=1, descending=True).values
    disc = 1.0 / torch.log2(torch.arange(2, gains.shape[1] + 2,
                                         device=gains.device,
                                         dtype=torch.float32))
    return torch.sum(srt * disc[None, :], dim=1)


def _dense_layout(y: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """Row-order y -> ([G, M] dense y, [G] ideal DCG)."""
    y_dense = torch.where(mask, y[idx.clamp(min=0).long()], 0.0)
    return y_dense, _ideal_dcg(y_dense, mask)


def _lambda_grads_batch(f, y, mask, maxdcg, use_ndcg: bool):
    """Pairwise lambda gradients of a batch of groups: f, y, mask
    [B, M], maxdcg [B] -> (g, h) [B, M]. Each in-group pair with
    y_i > y_j adds the cross-entropy of the score difference, weighted
    by |ΔNDCG| under ``use_ndcg`` (Burges' LambdaRank). Ranks are
    1-based within the group by a stable descending sort of the scores,
    filled slots first."""
    fm = torch.where(mask, f, float("-inf"))
    order = torch.argsort(-fm, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(1, f.shape[1] + 1, device=f.device
                               ).expand_as(order))
    diff = f[:, :, None] - f[:, None, :]                # [B, M, M]
    rho = torch.sigmoid(-diff)
    pair = ((y[:, :, None] - y[:, None, :]) > 0) \
        & mask[:, :, None] & mask[:, None, :]
    if use_ndcg:
        gain = 2.0 ** y - 1.0
        disc = 1.0 / torch.log2(1.0 + rank.to(torch.float32))
        dgain = torch.abs(gain[:, :, None] - gain[:, None, :])
        ddisc = torch.abs(disc[:, :, None] - disc[:, None, :])
        w = dgain * ddisc / torch.clamp(maxdcg, min=1e-10)[:, None, None]
        A = torch.where(pair, w * rho, 0.0)
        Hh = torch.where(pair, w * rho * (1.0 - rho), 0.0)
    else:
        A = torch.where(pair, rho, 0.0)
        Hh = torch.where(pair, rho * (1.0 - rho), 0.0)
    g = -torch.sum(A, dim=2) + torch.sum(A, dim=1)
    h = torch.sum(Hh, dim=2) + torch.sum(Hh, dim=1)
    return g, h


class _RankBatches:
    """The dense layout on the training device, its groups sorted by
    size (largest first) and cut into batches: (first, last group,
    width), each batch's pair tensors within ``_PAIR_ELEMS`` elements
    and holding at least ``min_groups`` groups."""

    def __init__(self, layout: _GroupLayout, y: torch.Tensor,
                 min_groups: int):
        dev = y.device
        perm = np.argsort(-layout.sizes, kind="stable")
        idx = torch.as_tensor(layout.idx[perm], device=dev)
        self.mask = idx >= 0
        self.idx = idx.clamp(min=0).long()
        self.y, self.maxdcg = _dense_layout(y, idx, self.mask)
        # each row's flat slot in the sorted layout
        Mx = layout.max_docs
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        pos = layout.pos.astype(np.int64)
        ok = pos >= 0
        spos = np.where(ok, inv[np.maximum(pos, 0) // Mx] * Mx
                        + np.maximum(pos, 0) % Mx, 0)
        self.pos = torch.as_tensor(spos, device=dev)
        self.ok = torch.as_tensor(ok, device=dev)
        sizes = layout.sizes[perm]
        self.batches = []
        a, G = 0, len(sizes)
        while a < G:
            width = int(max(sizes[a], 1))
            n = max(min_groups, _PAIR_ELEMS // (width * width), 1)
            b = min(G, a + n)
            self.batches.append((a, b, width))
            a = b

    def grads(self, margin: torch.Tensor, use_ndcg: bool):
        """Row-order margins -> row-order (g, h) (the JAX package's
        ``_lambda_grads``); rows in no group (none on one device) get
        0."""
        f = torch.where(self.mask, margin[self.idx], 0.0)
        g = torch.zeros_like(f)
        h = torch.zeros_like(f)
        for a, b, width in self.batches:
            g[a:b, :width], h[a:b, :width] = _lambda_grads_batch(
                f[a:b, :width], self.y[a:b, :width],
                self.mask[a:b, :width], self.maxdcg[a:b], use_ndcg)
        g, h = g.reshape(-1)[self.pos], h.reshape(-1)[self.pos]
        return torch.where(self.ok, g, 0.0), torch.where(self.ok, h, 0.0)


def _rank_keys(seed: int, n: int) -> torch.Tensor:
    """[n, 3, 2] per-round (row, column, tree) keys, the JAX package's
    schedule: ``key = key(seed)``, per round ``key, kt = split(key)``,
    then ``split(kt, 3)``; on the host (a few words)."""
    key = prng.key(seed)
    out = []
    for _ in range(n):
        key, kt = prng.split(key, 2)
        out.append(prng.split(kt, 3))
    return torch.stack(out)


def _rank_round(binned, margin, batches: _RankBatches, w, keys,
                tp: TreeParams, use_ndcg: bool, lr: float,
                sample_rate: float, col_rate: float):
    """One LambdaMART round: lambda gradients -> row and column sample
    (``uniform(k_row, rows) < sample_rate`` and ``uniform(k_col, F) <
    col_rate``, no shard fold) -> one tree -> margin update. ``keys``:
    the round's [3, 2] keys (None when nothing is drawn). Returns
    (margin, tree [1, N])."""
    g, h = batches.grads(margin, use_ndcg)
    F = binned.shape[0]
    w_t, col_mask = w, None
    if sample_rate < 1.0:
        w_t = w * (prng.uniform(keys[0], w.shape) < sample_rate)
    if col_rate < 1.0:
        col_mask = (prng.uniform(keys[1], (F,)) < col_rate)[None]
    tree, leaf = _grow_trees(binned, g, h, w_t, tp,
                             None if keys is None else keys[2:3], col_mask)
    tree = tree._replace(value=lr * tree.value)
    # the grower's resting leaf of every row: predict_tree's descent
    return margin + tree.value[0][leaf[0]], tree


def _rank_tree_params(p) -> TreeParams:
    """The grower's parameters of a LambdaMART round."""
    return TreeParams(max_depth=p.max_depth, n_bins=p.nbins,
                      min_rows=p.min_rows, reg_lambda=p.reg_lambda,
                      reg_alpha=p.reg_alpha, gamma=p.min_split_improvement,
                      mtries=p.mtries, min_child_weight=p.min_child_weight)


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------

class XGBoost(GBM):
    """H2OXGBoostEstimator analog (tree_method=hist).

    XGBoost's defaults differ from GBM's: eta 0.3, depth 6, lambda 1,
    min_child_weight 1 (hessian mass, not rows), min_rows 1."""

    model_cls = XGBoostModel

    def __init__(self, ntrees: int = 50, max_depth: int = 6,
                 learn_rate: float = 0.3, eta: float | None = None,
                 reg_lambda: float = 1.0, reg_alpha: float = 0.0,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 subsample: float = 1.0,
                 colsample_bytree: float = 1.0,
                 nbins: int = 256, objective: str | None = None,
                 booster: str = "gbtree", tree_method: str = "hist",
                 ndcg_group_batch: int = 16, **kw):
        if booster != "gbtree":
            raise ValueError(f"only booster=gbtree is supported: {booster}")
        if tree_method not in ("hist", "gpu_hist", "approx", "auto"):
            raise ValueError(f"unknown tree_method {tree_method}")
        # H2O's spellings map onto XGBoost's (the reference's XGBoostV3
        # schema does the same)
        if "min_rows" in kw:
            min_child_weight = kw.pop("min_rows")
        if "sample_rate" in kw:
            subsample = kw.pop("sample_rate")
        if "col_sample_rate_per_tree" in kw:
            colsample_bytree = kw.pop("col_sample_rate_per_tree")
        dist = kw.pop("distribution", "auto")
        if objective is not None:
            if objective not in _OBJECTIVE_ALIASES:
                raise ValueError(f"unknown objective {objective}")
            dist = _OBJECTIVE_ALIASES[objective]
        super().__init__(
            ntrees=ntrees, max_depth=max_depth,
            learn_rate=eta if eta is not None else learn_rate,
            reg_lambda=reg_lambda, reg_alpha=reg_alpha,
            min_split_improvement=gamma,
            min_child_weight=min_child_weight,
            sample_rate=subsample,
            col_sample_rate_per_tree=colsample_bytree,
            nbins=nbins, min_rows=1.0,
            distribution=dist, **kw)
        self._ndcg_group_batch = ndcg_group_batch

    def train(self, y: str, training_frame, x: Sequence[str] | None = None,
              group_column: str | None = None, **kw) -> XGBoostModel:
        """Train on ``training_frame``'s device. Ranking objectives need
        ``group_column``; a pointwise one ignores it as a feature."""
        single_process_only("XGBoost")
        if self.params.distribution.startswith("rank:"):
            if group_column is None:
                raise ValueError("ranking objectives need group_column")
            if self.cv_args.enabled:
                raise ValueError(
                    "cross-validation with rank:* objectives needs "
                    "group-aware folds; not supported yet")
            return self._train_rank(y, training_frame, x, group_column, **kw)
        ignored = list(kw.pop("ignored_columns", None) or [])
        if group_column:
            ignored.append(group_column)
        model = super().train(y=y, training_frame=training_frame, x=x,
                              ignored_columns=ignored, **kw)
        model._group_column = group_column
        return model

    def _train_rank(self, y: str, frame, x, group_column: str,
                    ignored_columns: Sequence[str] | None = None,
                    weights_column: str | None = None,
                    validation_frame=None,
                    offset_column: str | None = None) -> XGBoostModel:
        p = self.params
        if offset_column:
            # a base margin is meaningful for pointwise objectives only;
            # lambda gradients come from pairwise score differences
            raise ValueError(
                "offset_column is not supported for rank:* objectives")
        ignored = list(ignored_columns or []) + [group_column]
        data = resolve_xy(frame, y, x, ignored, weights_column,
                          distribution="gaussian")
        data.distribution = p.distribution   # rank:* carried through
        # graded relevance stored as an enum: its codes are the grades,
        # scored as a single-output ranker
        data.nclasses = 1
        data.response_domain = None
        use_ndcg = p.distribution == "rank:ndcg"
        gids = frame.vec(group_column).to_numpy()
        layout = _GroupLayout(np.asarray(gids).astype(np.int64),
                              frame.nrows)
        bin_spec, binned = fused_fit_bins(frame, data.feature_names,
                                          p.nbins)
        batches = _RankBatches(layout, data.y, min(self._ndcg_group_batch,
                                                   layout.n_groups))
        tp = _rank_tree_params(p)
        F = len(data.feature_names)
        keys = None
        if p.sample_rate < 1.0 or p.col_sample_rate_per_tree < 1.0 \
                or 0 < p.mtries < F:
            keys = _rank_keys(p.seed, p.ntrees).to(binned.device)
        margin = torch.zeros_like(data.y)
        yt = data.y.cpu().numpy()
        trees, history = [], []
        for t in range(p.ntrees):
            margin, tree = _rank_round(
                binned, margin, batches, data.w,
                None if keys is None else keys[t], tp, use_ndcg,
                p.learn_rate, p.sample_rate, p.col_sample_rate_per_tree)
            trees.append(tree)
            if p.score_every and (t + 1) % p.score_every == 0:
                history.append({"ntrees": t + 1, "train_ndcg@10": M.ndcg(
                    yt, margin.cpu().numpy(), gids, k=10)})
        trees = Tree(*(torch.cat(a) for a in zip(*trees)))
        model = self.model_cls(data, p, bin_spec, trees, 0.0)
        model._group_column = group_column
        history.append({"ntrees": p.ntrees, "train_ndcg@10": M.ndcg(
            yt, margin.cpu().numpy(), gids, k=10)})
        model.scoring_history = history
        if validation_frame is not None:
            vscore = model.predict_raw(validation_frame)
            model.validation_metrics = {"ndcg@10": M.ndcg(
                validation_frame.vec(y).to_numpy(), vscore,
                validation_frame.vec(group_column).to_numpy(), k=10)}
        return model


def xgboost_model_from_arrays(*args, group_column: str | None = None,
                              **kw) -> XGBoostModel:
    """A port ``XGBoostModel`` from another package's trained XGBoost
    model, as numpy: ``gbm_model_from_arrays``' arguments, plus the
    ranking ``group_column``."""
    model = gbm_model_from_arrays(*args, model_cls=XGBoostModel, **kw)
    model._group_column = group_column
    return model
