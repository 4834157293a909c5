"""KMeans (the JAX package's ``models/kmeans.py``, hex/kmeans's
analog): k-means++ ("PlusPlus"), Random or Furthest seeding, then
Lloyd's iterations on the expanded, by default standardized, design
(categoricals one-hot through ``DataInfo``, all levels kept).

Seeding is the reference's host numpy on the expanded matrix, line for
line (``rng.choice(p=...)`` needs its float64 distances bit for bit).
Lloyd's loop runs on the frame's device in the reference's form: the
squared distances ‖x‖² − 2x·c + ‖c‖² as one [r, F]·[F, k] product, the
per-cluster sums as a one-hot [k, r]·[r, F] product, and the same stop
(at most ``max_iterations`` moves, or the largest squared centre move at
most 1e-6). The products are float64 and the centres rounded once to
float32: a float32 product decides a row's nearest centre by its
summation order, which differs between devices, and on data without
clusters one such row moves the next iteration's centres. The loop is
on the host: one sync an iteration, to read the move.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..frame import Frame
from ..runtime.mesh import single_process_only
from .base import LearnerModel, TrainData, resolve_x
from .datainfo import DataInfo, build_datainfo, design

__all__ = ["KMeans", "KMeansModel", "KMeansParams"]

_TOL = np.float32(1e-6)


@dataclass
class KMeansParams:
    k: int = 8
    max_iterations: int = 10
    init: str = "PlusPlus"            # PlusPlus | Random | Furthest
    standardize: bool = True
    seed: int = 0
    estimate_k: bool = False          # reserved (reference feature)


def pairwise_sqdist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """[r, F], [k, F] -> [r, k] float64 squared distances through one
    product."""
    X, C = X.double(), C.double()
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(C * C, dim=1)[None, :]
    return x2 - 2.0 * (X @ C.T) + c2


def _assign_stats(Xe, w, C):
    """(assignments, per-cluster sums [k, F], weighted counts [k],
    within-cluster sum of squares) for centres C."""
    k = C.shape[0]
    d = pairwise_sqdist(Xe, C)
    a = torch.argmin(d, dim=1)
    onehot = (a[:, None] == torch.arange(k, device=Xe.device)[None, :]
              ).double() * w.double()[:, None]              # [r, k]
    sums = onehot.T @ Xe.double()
    cnts = torch.sum(onehot, dim=0)
    wss = torch.sum(torch.min(d, dim=1).values * w.double())
    return a, sums, cnts, wss


def lloyd(Xe: torch.Tensor, w: torch.Tensor, C0: torch.Tensor,
          max_iter: int):
    """Lloyd's iterations from C0 -> (C, assignments, counts, withinss,
    iterations)."""
    C = C0
    it = 0
    while it < max_iter:
        _, sums, cnts, _ = _assign_stats(Xe, w, C)
        newC = torch.where(cnts[:, None] > 0,
                           (sums / torch.clamp(cnts[:, None], min=1.0))
                           .float(), C)
        move = torch.max(torch.sum((newC.double() - C.double()) ** 2,
                                   dim=1))
        C = newC
        it += 1
        if not bool(move > float(_TOL)):     # the iteration's one sync
            break
    a, _, cnts, wss = _assign_stats(Xe, w, C)
    return C, a, cnts, wss, it


def _plusplus_init(Xe_np, w_np, k, rng):
    """k-means++ seeding on the host over the (valid-row) matrix."""
    valid = np.flatnonzero(w_np > 0)
    X = Xe_np[valid]
    n = X.shape[0]
    centers = [X[rng.integers(n)]]
    d2 = np.full(n, np.inf, dtype=np.float64)
    for _ in range(1, k):
        c = centers[-1]
        d2 = np.minimum(d2, ((X - c) ** 2).sum(axis=1))
        tot = d2.sum()
        probs = d2 / tot if tot > 0 else np.full(n, 1.0 / n)
        centers.append(X[rng.choice(n, p=probs)])
    return np.stack(centers).astype(np.float32)


def _furthest_init(Xe_np, w_np, k, rng):
    valid = np.flatnonzero(w_np > 0)
    X = Xe_np[valid]
    centers = [X[rng.integers(X.shape[0])]]
    d2 = np.full(X.shape[0], np.inf)
    for _ in range(1, k):
        d2 = np.minimum(d2, ((X - centers[-1]) ** 2).sum(axis=1))
        centers.append(X[int(d2.argmax())])
    return np.stack(centers).astype(np.float32)


def initial_centers(Xe_np: np.ndarray, w_np: np.ndarray,
                    p: KMeansParams) -> np.ndarray:
    """The reference's seeding: [k, F] float32."""
    rng = np.random.default_rng(p.seed)
    init = p.init.lower()
    if init in ("plusplus", "kmeans++", "auto"):
        return _plusplus_init(Xe_np, w_np, p.k, rng)
    if init == "random":
        valid = np.flatnonzero(w_np > 0)
        return Xe_np[rng.choice(valid, size=p.k, replace=False)]
    if init == "furthest":
        return _furthest_init(Xe_np, w_np, p.k, rng)
    raise ValueError(f"unknown init '{p.init}'")


class KMeansModel(LearnerModel):
    algo = "kmeans"

    def __init__(self, data: TrainData, params: KMeansParams,
                 dinfo: DataInfo, centers: torch.Tensor, counts: np.ndarray,
                 withinss: float, iterations: int):
        self._init_layout(data, centers.device)
        self.params = params
        self.dinfo = dinfo
        self.centers_std = centers           # [k, F] standardized space
        self.size = counts
        self.tot_withinss = withinss
        self.iterations = iterations

    def centers(self) -> np.ndarray:
        """Centres in the original feature space (numerics
        de-standardized; one-hot coordinates stay level frequencies)."""
        C = self.centers_std.cpu().double().numpy().copy()
        nn = len(self.dinfo.numeric_idx)
        C[:, :nn] = C[:, :nn] * self.dinfo.stds[None, :] + \
            self.dinfo.means[None, :]
        return C

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        d = pairwise_sqdist(self._expand(X), self.centers_std)
        return torch.argmin(d, dim=1).to(torch.float32)

    def predict(self, frame: Frame) -> Frame:
        return Frame.from_arrays(
            {"predict": self.predict_raw(frame).astype(np.int32)},
            device="cpu")

    def model_performance(self, frame=None, y=None) -> dict:
        return {"tot_withinss": float(self.tot_withinss),
                "iterations": int(self.iterations)}

    @property
    def _artifact_meta(self) -> dict:
        return self._meta_common()

    @property
    def _artifact_arrays(self) -> dict:
        return dict(self._arrays_common(),
                    centers=self.centers_std.cpu().numpy())


class KMeans:
    """H2OKMeansEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        CVArgs.pop(kw)                 # accepted, unused (no CV for kmeans)
        self.params = KMeansParams(**kw)

    def train(self, training_frame: Frame, x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              y: str | None = None) -> KMeansModel:
        single_process_only("KMeans")
        p = self.params
        if p.k < 1:
            raise ValueError(f"k must be >= 1, got {p.k}")
        ignored = list(ignored_columns or []) + ([y] if y else [])
        data = resolve_x(training_frame, x, ignored)
        dinfo = build_datainfo(data, training_frame, p.standardize,
                               drop_first=False)
        Xe = dinfo.expand(design(training_frame, data.feature_names))[:, :-1]
        C0 = initial_centers(Xe.cpu().numpy(), data.w.cpu().numpy(), p)
        C, _, cnts, wss, iters = lloyd(
            Xe, data.w, torch.as_tensor(C0, device=Xe.device),
            p.max_iterations)
        return KMeansModel(data, p, dinfo, C, cnts.cpu().numpy(),
                           float(wss), int(iters))
