"""GLRM, generalized low-rank models (the JAX package's
``models/glrm.py``, hex/glrm's analog): X ≈ U·Vᵀ (U the [n, k] row
representation, V the [d, k] archetypes) by alternating proximal
gradient steps on the quadratic loss over the observed cells (missing
cells drop out of the loss: GLRM imputes), with l2, l1 or non-negative
regularizers.

U0 and V0 are the threefry twin's ``normal`` draws through ``key`` and
``split``, so they are the reference's bit for bit. The alternating loop
runs on the frame's device with the reference's operations (the U step
per row given V, then the V step with its [d, k] gradient and the
global ‖U‖² bound); there is no sync inside it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..frame import Frame
from ..runtime import prng
from ..runtime.mesh import single_process_only
from .base import LearnerModel, TrainData, resolve_x
from .datainfo import DataInfo, design
from .pca import transformed_datainfo

__all__ = ["GLRM", "GLRMModel", "GLRMParams", "expand_mask"]


@dataclass(frozen=True)
class GLRMParams:
    k: int = 2
    loss: str = "quadratic"            # quadratic (per-column losses TBD)
    regularization_x: str = "none"     # none | l2 | l1 | non_negative
    regularization_y: str = "none"
    gamma_x: float = 0.0
    gamma_y: float = 0.0
    max_iterations: int = 100
    learn_rate: float = 1.0   # prox-grad step scale over the Frobenius
    #                           Lipschitz bounds below
    transform: str = "STANDARDIZE"     # NONE | DEMEAN | DESCALE | STANDARDIZE
    seed: int = 0


def expand_mask(dinfo: DataInfo, X: torch.Tensor) -> torch.Tensor:
    """The observed-cell mask in the expanded layout (without the
    intercept), from the RAW matrix: NaN numeric cells and NA enum cells
    are unobserved (``expand`` mean-imputes, so the mask cannot come from
    the expanded values)."""
    out = []
    if dinfo.numeric_idx:
        out.append(~torch.isnan(X[:, list(dinfo.numeric_idx)]))
    for (i, L, has_na, mode) in dinfo.enum_specs:
        width = L - (1 if dinfo.drop_first else 0) + (1 if has_na else 0)
        out.append((~torch.isnan(X[:, i]))[:, None].expand(X.shape[0],
                                                            width))
    return torch.cat(out, dim=1).to(torch.float32)


def _prox(Z: torch.Tensor, reg: str, step_gamma: float) -> torch.Tensor:
    if reg == "l2":
        return Z / (1.0 + 2.0 * step_gamma)
    if reg == "l1":
        return torch.sign(Z) * torch.clamp(torch.abs(Z) - step_gamma,
                                           min=0.0)
    if reg == "non_negative":
        return torch.clamp(Z, min=0.0)
    return Z


def fit(A: torch.Tensor, M: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
        p: GLRMParams):
    """The alternating prox-gradient loop -> (U, V, objective tensor)."""
    n_tot = torch.sum(M) + 1e-10
    lr = p.learn_rate
    for _ in range(p.max_iterations):
        R = (U @ V.T - A) * M                        # [n, d] masked resid
        LU = torch.sum(V * V) + 1e-6
        U = _prox(U - (lr / LU) * (R @ V), p.regularization_x,
                  p.gamma_x * lr / LU)
        R = (U @ V.T - A) * M
        LV = torch.sum(U * U) + 1e-6
        V = _prox(V - (lr / LV) * (R.T @ U), p.regularization_y,
                  p.gamma_y * lr / LV)
    obj = torch.sum(((U @ V.T - A) * M) ** 2) / n_tot
    return U, V, obj


class GLRMModel(LearnerModel):
    algo = "glrm"

    def __init__(self, data: TrainData, params: GLRMParams,
                 dinfo: DataInfo, U: torch.Tensor, V: torch.Tensor,
                 objective: float, nrows: int):
        self._init_layout(data, V.device)
        self.params = params
        self.dinfo = dinfo
        self.U = U                       # [n, k] row factors
        self.V = V                       # [d, k] archetypes
        self.objective = objective
        self._nrows = nrows

    def archetypes(self) -> np.ndarray:
        """[k, d] archetypes in the transformed space."""
        return self.V.T.cpu().numpy()

    def x_frame(self) -> Frame:
        """The U factors as a Frame (h2o's representation frame)."""
        U = self.U[: self._nrows].cpu().numpy()
        return Frame.from_arrays(
            {f"Arch{i + 1}": U[:, i] for i in range(U.shape[1])},
            device="cpu")

    def _solve_u(self, X: torch.Tensor) -> torch.Tensor:
        """Per-row ridge solve of U for fixed V on fresh rows."""
        Xz = torch.nan_to_num(self._expand(X)) * expand_mask(self.dinfo, X)
        V = self.V
        G = V.T @ V + 1e-6 * torch.eye(V.shape[1], device=V.device)
        return Xz @ V @ torch.linalg.inv(G)

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        return self._solve_u(X)

    def reconstruct(self, frame: Frame) -> Frame:
        """A frame imputed/reconstructed through the low-rank model
        (``reconstr_<coefficient>`` columns, on the CPU)."""
        rec = (self._solve_u(self._design_matrix(frame)) @ self.V.T) \
            .cpu().numpy()
        names = self.dinfo.coef_names[:-1]
        return Frame.from_arrays(
            {f"reconstr_{n}": rec[:, i] for i, n in enumerate(names)},
            device="cpu")

    @property
    def _artifact_meta(self) -> dict:
        return dict(self._meta_common(),
                    coef_names=list(self.dinfo.coef_names[:-1]))

    @property
    def _artifact_arrays(self) -> dict:
        return dict(self._arrays_common(), V=self.V.cpu().numpy())


class GLRM:
    """H2OGeneralizedLowRankEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        CVArgs.pop(kw)
        self.params = GLRMParams(**kw)

    def train(self, training_frame: Frame, x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              y: str | None = None) -> GLRMModel:
        single_process_only("GLRM")
        p = self.params
        if p.loss != "quadratic":
            raise ValueError("only loss='quadratic' is implemented")
        ignored = list(ignored_columns or []) + ([y] if y else [])
        data = resolve_x(training_frame, x, ignored)
        dinfo = transformed_datainfo(data, training_frame, p.transform,
                                     drop_first=False)
        X = design(training_frame, data.feature_names)
        Xe = dinfo.expand(X)[:, :-1]
        M = expand_mask(dinfo, X)
        A = torch.nan_to_num(Xe)
        n, d = Xe.shape
        if p.k > min(n, d):
            raise ValueError(f"k={p.k} exceeds min(rows, cols)="
                             f"{min(n, d)}")
        U0, V0 = self.initial_factors(n, d, p.k, p.seed, Xe.device)
        U, V, obj = fit(A, M, U0, V0, p)
        return GLRMModel(data, p, dinfo, U, V, float(obj), n)

    @staticmethod
    def initial_factors(n: int, d: int, k: int, seed: int, device=None):
        """(U0, V0) as ``train`` draws them."""
        k1, k2 = prng.split(prng.key(seed, device=device))
        return prng.normal(k1, (n, k)) * 0.1, prng.normal(k2, (d, k)) * 0.1
