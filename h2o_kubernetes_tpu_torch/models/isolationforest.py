"""Isolation forest (the JAX package's ``models/isolationforest.py``,
hex/tree/isofor's analog): each tree grows on a row sample
(``sample_size``, default 256); at each node a random feature with
spread and a random threshold within the node's [min, max] of it are
drawn (no histograms, no gain); a row's anomaly score is
2^(−E[h]/c(n)) of its mean path length over the forest (Liu et al.).

The trees are the reference's dense heaps (2^(depth+1) − 1 nodes). The
sample rows are gathered first, so each level's per-(node, feature)
min and max (``scatter_reduce_`` ``amin``/``amax``) and counts run over
the sample only: they are exact, so they equal the reference's
full-row segment reductions. The draws are the threefry twin's
(``split`` per tree, ``fold_in`` of the depth, ``split``, ``uniform``),
made for every tree and level at once before the trees grow
(``tree_draws``: a level's draws are the prefix of the deepest level's
shape, as threefry counters are), and the threshold
``fmin + u·(fmax − fmin)`` is XLA's fused multiply-add
(``xla_math.fma``), so every tree equals the reference's bit for bit. Row
sampling is numpy ``default_rng(seed).choice``, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..frame import Frame
from ..runtime import prng, xla_math
from ..runtime.mesh import single_process_only
from .base import LearnerModel, TrainData, resolve_x
from .datainfo import design

__all__ = ["IsolationForest", "IsolationForestModel",
           "IsolationForestParams", "IsoTree", "grow_tree", "path_length",
           "avg_path", "tree_draws"]


@dataclass(frozen=True)
class IsolationForestParams:
    ntrees: int = 50
    sample_size: int = 256
    max_depth: int = 8              # reference default: ceil(log2(256))
    seed: int = 0


class IsoTree(NamedTuple):
    split_feat: torch.Tensor   # int32 [..., N]
    split_val: torch.Tensor    # f32   [..., N] raw threshold (left if <)
    is_split: torch.Tensor     # bool  [..., N]
    count: torch.Tensor        # f32   [..., N] sample rows at the node


def avg_path(n: torch.Tensor) -> torch.Tensor:
    """c(n): the average unsuccessful-search path length of a BST, with
    XLA's CPU log (``xla_math.log``: the same bits on every device)."""
    n = torch.clamp(n, min=2.0)
    return 2.0 * (xla_math.log(n - 1.0) + 0.5772156649) \
        - 2.0 * (n - 1.0) / n


def tree_draws(keys: torch.Tensor, max_depth: int, F: int):
    """Every tree's per-level draws from its key ([T, 2]): (r [T, D+1,
    2^D·F], the feature draws, and u [T, D+1, 2^D], the threshold
    draws); level d takes the first 2^d·F and 2^d of its row, which are
    ``uniform(kf, (2^d, F))`` and ``uniform(kv, (2^d,))`` of
    ``kf, kv = split(fold_in(key, d))``."""
    lv = torch.stack([prng.fold_in(keys, d) for d in range(max_depth + 1)],
                     dim=1)                                 # [T, D+1, 2]
    kk = prng.split(lv)                                     # [T, D+1, 2, 2]
    n = 2 ** max_depth
    return prng.uniform(kk[..., 0, :], (n * F,)), \
        prng.uniform(kk[..., 1, :], (n,))


def grow_tree(Xs: torch.Tensor, r_all: torch.Tensor, u_all: torch.Tensor,
              max_depth: int) -> IsoTree:
    """One isolation tree on the sample rows Xs [S, F] (NaN -> 0) with
    its draws (``tree_draws``' rows for this tree)."""
    dev = Xs.device
    S, F = Xs.shape
    N = 2 ** (max_depth + 1) - 1
    split_feat = torch.full((N,), -1, dtype=torch.int32, device=dev)
    split_val = torch.zeros(N, dtype=torch.float32, device=dev)
    is_split = torch.zeros(N, dtype=torch.bool, device=dev)
    count = torch.zeros(N, dtype=torch.float32, device=dev)
    Xf = torch.nan_to_num(Xs, nan=0.0)
    rel = torch.zeros(S, dtype=torch.int64, device=dev)
    rows = torch.arange(S, device=dev)
    for d in range(max_depth + 1):
        n_nodes = 2 ** d
        off = n_nodes - 1
        live = rel >= 0
        seg = torch.where(live, rel, n_nodes)[:, None].expand(S, F)
        vmin = torch.full((n_nodes + 1, F), float("inf"), device=dev) \
            .scatter_reduce_(0, seg, Xf, "amin")[:n_nodes]
        vmax = torch.full((n_nodes + 1, F), float("-inf"), device=dev) \
            .scatter_reduce_(0, seg, Xf, "amax")[:n_nodes]
        cnt = torch.zeros(n_nodes + 1, device=dev).index_add_(
            0, seg[:, 0], live.float())[:n_nodes]
        spread_ok = vmax > vmin                               # [n, F]
        r = torch.where(spread_ok,
                        r_all[d, : n_nodes * F].reshape(n_nodes, F), -1.0)
        feat = torch.argmax(r, dim=1)
        u = u_all[d, :n_nodes]
        fmin = vmin.gather(1, feat[:, None])[:, 0]
        fmax = vmax.gather(1, feat[:, None])[:, 0]
        val = xla_math.fma(u, fmax - fmin, fmin)     # XLA fuses this
        can = spread_ok.any(dim=1) & (cnt > 1.0)
        if d == max_depth:
            can = torch.zeros_like(can)
        sl = slice(off, off + n_nodes)
        split_feat[sl] = torch.where(can, feat.to(torch.int32), -1)
        split_val[sl] = val
        is_split[sl] = can
        count[sl] = cnt
        if d == max_depth:
            break
        safe = torch.where(live, rel, 0)
        rowval = Xf[rows, feat[safe]]
        child = 2 * rel + (rowval >= val[safe]).long()
        rel = torch.where(live & can[safe], child, -1)
    return IsoTree(split_feat, split_val, is_split, count)


def path_length(tree: IsoTree, Xf: torch.Tensor, max_depth: int
                ) -> torch.Tensor:
    """Per-row path length h(x) of one tree, with the c(leaf count)
    adjustment; Xf has NaN -> 0."""
    n = Xf.shape[0]
    rows = torch.arange(n, device=Xf.device)
    node = torch.zeros(n, dtype=torch.int64, device=Xf.device)
    depth = torch.zeros(n, dtype=torch.float32, device=Xf.device)
    for _ in range(max_depth):
        f = tree.split_feat[node].long()
        sp = tree.is_split[node]
        rowval = Xf[rows, torch.clamp(f, min=0)]
        child = 2 * node + 1 + (rowval >= tree.split_val[node]).long()
        node = torch.where(sp, child, node)
        depth = depth + sp.float()
    leaf_n = tree.count[node]
    return depth + torch.where(leaf_n > 1.0, avg_path(leaf_n), 0.0)


class IsolationForestModel(LearnerModel):
    algo = "isolationforest"

    def __init__(self, data: TrainData, params: IsolationForestParams,
                 trees: IsoTree, sample_size_effective: int):
        self._init_layout(data, trees.count.device)
        self.params = params
        self.trees = trees                       # stacked [T, N]
        self.ntrees = int(trees.count.shape[0])
        # the normalizer uses the sample actually drawn (clamped to the
        # valid rows), not the requested one
        self.sample_size_effective = sample_size_effective

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        """[n, 2]: (anomaly score, mean path length)."""
        Xf = torch.nan_to_num(X, nan=0.0)
        total = torch.zeros(X.shape[0], dtype=torch.float32,
                            device=X.device)
        for t in range(self.ntrees):             # the reference's scan order
            tree = IsoTree(*(a[t] for a in self.trees))
            total = total + path_length(tree, Xf, self.params.max_depth)
        mean_len = total / self.ntrees
        c = avg_path(torch.tensor(float(self.sample_size_effective),
                                  device=X.device))
        return torch.stack([torch.exp2(-mean_len / c), mean_len], dim=1)

    def predict(self, frame: Frame) -> Frame:
        out = self.predict_raw(frame)
        return Frame.from_arrays({"predict": out[:, 0],
                                  "mean_length": out[:, 1]}, device="cpu")

    def model_performance(self, frame=None, y=None) -> dict:
        return {"ntrees": self.ntrees}

    @property
    def _artifact_meta(self) -> dict:
        return dict(self._meta_common(), max_depth=self.params.max_depth,
                    ntrees=self.ntrees,
                    sample_size_effective=int(self.sample_size_effective))

    @property
    def _artifact_arrays(self) -> dict:
        return {f"iso_{f}": getattr(self.trees, f).cpu().numpy()
                for f in IsoTree._fields}


class IsolationForest:
    """H2OIsolationForestEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        CVArgs.pop(kw)
        self.params = IsolationForestParams(**kw)

    def train(self, training_frame: Frame,
              x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              y: str | None = None) -> IsolationForestModel:
        single_process_only("IsolationForest")
        p = self.params
        ignored = list(ignored_columns or []) + ([y] if y else [])
        data = resolve_x(training_frame, x, ignored)
        X = design(training_frame, data.feature_names)
        key = prng.key(p.seed, device=X.device)
        keys = []
        for _ in range(p.ntrees):
            key, kt = prng.split(key)
            keys.append(kt)
        r_all, u_all = tree_draws(torch.stack(keys), p.max_depth,
                                  X.shape[1])
        rng = np.random.default_rng(p.seed)
        valid_idx = np.flatnonzero(data.w.cpu().numpy() > 0)
        sample = min(p.sample_size, len(valid_idx))
        trees = []
        for t in range(p.ntrees):
            pick = rng.choice(valid_idx, size=sample, replace=False)
            Xs = X[torch.as_tensor(np.sort(pick), device=X.device)]
            trees.append(grow_tree(Xs, r_all[t], u_all[t], p.max_depth))
        stacked = IsoTree(*(torch.stack(f) for f in zip(*trees)))
        return IsolationForestModel(data, p, stacked, sample)
