"""PCA by GramSVD (the JAX package's ``models/pca.py``, hex/pca's
analog): the weighted Gram matrix of the expanded design, one
``Xeᵀ(w·Xe)`` product on the frame's device, summed in float64 and
rounded once to float32 (a float32 product over a million rows parts
the card's eigenvalues from the CPU's by ~5e-5), then its
eigendecomposition (``torch.linalg.eigh`` in float32, as the reference
computes it), the
``k`` largest components with the largest-|loading| coordinate of each
made positive. Scores are ``Xe·V``. The transforms NONE, DEMEAN,
DESCALE and STANDARDIZE adjust ``DataInfo``'s means and deviations;
categoricals expand one-hot (numerics only are centred, as in the
reference).
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

__all__ = ["PCA", "PCAModel", "PCAParams", "TRANSFORMS"]


@dataclass
class PCAParams:
    k: int = 3
    transform: str = "STANDARDIZE"   # NONE | DEMEAN | DESCALE | STANDARDIZE
    pca_method: str = "GramSVD"
    use_all_factor_levels: bool = False
    seed: int = 0


# transform -> (demean, descale)
TRANSFORMS = {"NONE": (False, False), "DEMEAN": (True, False),
              "DESCALE": (False, True), "STANDARDIZE": (True, True)}


def transformed_datainfo(data: TrainData, frame, transform: str,
                         drop_first: bool) -> DataInfo:
    """``DataInfo`` under one of ``TRANSFORMS`` (shared with GLRM):
    standardized when it descales, zero means when it does not
    demean."""
    t = transform.upper()
    if t not in TRANSFORMS:
        raise ValueError(f"unknown transform '{transform}'")
    demean, descale = TRANSFORMS[t]
    dinfo = build_datainfo(data, frame, standardize=descale,
                           drop_first=drop_first)
    if not demean:
        dinfo.means = np.zeros_like(dinfo.means)
    return dinfo


class PCAModel(LearnerModel):
    algo = "pca"

    def __init__(self, data: TrainData, params: PCAParams, dinfo: DataInfo,
                 eigvec: torch.Tensor, eigval: torch.Tensor, n_obs: float,
                 total_var: float):
        self._init_layout(data, eigvec.device)
        self.params = params
        self.dinfo = dinfo
        self.eigenvectors = eigvec       # [P, k] (expanded space)
        self.eigenvalues = eigval        # [k] variances
        self.n_obs = n_obs
        self._total_var = total_var

    @property
    def std_deviation(self) -> np.ndarray:
        return np.sqrt(np.maximum(self.eigenvalues.cpu().numpy(), 0.0))

    def pve(self) -> np.ndarray:
        """Proportion of variance explained per component."""
        return np.maximum(self.eigenvalues.cpu().numpy(), 0.0) \
            / self._total_var

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        return self._expand(X) @ self.eigenvectors

    def predict(self, frame: Frame) -> Frame:
        out = self.predict_raw(frame)
        return Frame.from_arrays(
            {f"PC{i + 1}": out[:, i] for i in range(out.shape[1])},
            device="cpu")

    def model_performance(self, frame=None, y=None) -> dict:
        return {"std_deviation": self.std_deviation.tolist(),
                "pve": self.pve().tolist()}

    @property
    def _artifact_meta(self) -> dict:
        return self._meta_common()

    @property
    def _artifact_arrays(self) -> dict:
        return dict(self._arrays_common(),
                    eigenvectors=self.eigenvectors.cpu().numpy(),
                    eigenvalues=self.eigenvalues.cpu().numpy())


class PCA:
    """H2OPrincipalComponentAnalysisEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        CVArgs.pop(kw)
        self.params = PCAParams(**kw)

    def train(self, training_frame: Frame, x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              y: str | None = None) -> PCAModel:
        single_process_only("PCA")
        p = self.params
        ignored = list(ignored_columns or []) + ([y] if y else [])
        data = resolve_x(training_frame, x, ignored)
        dinfo = transformed_datainfo(data, training_frame, p.transform,
                                     not p.use_all_factor_levels)
        Xe = dinfo.expand(design(training_frame, data.feature_names))[:, :-1]
        if p.k > Xe.shape[1]:
            raise ValueError(f"k={p.k} > {Xe.shape[1]} expanded features")
        w = data.w.double()
        X64 = Xe.double()
        G = X64.T @ (X64 * w[:, None])                       # [P, P]
        del X64
        n_obs = torch.sum(w)
        denom = torch.clamp(n_obs - 1.0, min=1.0)
        vals, vecs = torch.linalg.eigh((G / denom).float())
        order = torch.argsort(-vals, stable=True)[: p.k]
        vals, vecs = vals[order], vecs[:, order]
        # sign convention: the largest-|loading| coordinate positive
        top = torch.argmax(torch.abs(vecs), dim=0)
        sign = torch.sign(vecs[top, torch.arange(p.k, device=vecs.device)])
        vecs = vecs * sign[None, :]
        total = float(torch.trace(G.float()) / denom)
        return PCAModel(data, p, dinfo, vecs, vals, float(n_obs), total)
