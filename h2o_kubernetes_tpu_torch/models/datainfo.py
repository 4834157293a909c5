"""DataInfo: the expanded design matrix of GLM (the JAX package's
``models/datainfo.py``, hex/DataInfo.java's analog).

Numeric features are mean-imputed and optionally standardized;
categorical features expand to one-hot columns (an NA level when the
training column had NAs; otherwise an NA or unseen level takes the
modal level; ``drop_first`` drops level 0); the intercept column comes
last. The expansion is elementwise float32 on the input's device, the
same operations as the JAX package's, so the same ``DataInfo`` and rows
give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DataInfo", "build_datainfo", "expand"]


def expand(X: torch.Tensor, means: torch.Tensor, stds: torch.Tensor,
           numeric_idx: tuple, enum_specs: tuple,
           drop_first: bool) -> torch.Tensor:
    """[R, F] raw float32 matrix (enum codes, NaN NAs) -> [R, P]
    expanded matrix: the numeric columns ``(x - mean) / std`` with NaN
    -> mean, each enum's one-hot levels, then the intercept."""
    out = []
    if numeric_idx:
        c = X[:, list(numeric_idx)]
        c = torch.where(torch.isnan(c), means[None, :], c)
        out.append((c - means[None, :]) / stds[None, :])
    for (i, L, has_na, mode) in enum_specs:
        c = X[:, i]
        code = torch.where(torch.isnan(c), float(L), c).to(torch.int32)
        if not has_na:
            # no NA level was trained: NA and unseen levels take the
            # modal level (categorical mean imputation), not the
            # dropped base level
            code = torch.where(code >= L, mode, code)
        lo = 1 if drop_first else 0
        width = L - lo + (1 if has_na else 0)
        levels = torch.arange(lo, lo + width, device=X.device,
                              dtype=torch.int32)
        out.append((code[:, None] == levels[None, :]).to(torch.float32))
    out.append(torch.ones((X.shape[0], 1), dtype=torch.float32,
                          device=X.device))     # intercept last
    return torch.cat(out, dim=1)


@dataclass
class DataInfo:
    """Expanded design layout (hex/DataInfo.java's analog)."""

    coef_names: list[str]
    numeric_idx: list[int]            # columns of X that are numeric
    # per enum: (X col, n_levels, has_na, mode_level)
    enum_specs: list[tuple[int, int, bool, int]]
    means: np.ndarray                 # per numeric column, float32
    stds: np.ndarray
    n_expanded: int
    drop_first: bool

    def expand(self, X: torch.Tensor) -> torch.Tensor:
        """[R, F] raw matrix -> [R, P] expanded matrix on X's device."""
        return expand(X, torch.as_tensor(self.means, device=X.device),
                      torch.as_tensor(self.stds, device=X.device),
                      tuple(self.numeric_idx),
                      tuple(tuple(s) for s in self.enum_specs),
                      self.drop_first)


def build_datainfo(data, frame, standardize: bool,
                   drop_first: bool) -> DataInfo:
    """The layout of ``data``'s features on ``frame``: numeric columns
    first (mean and, when ``standardize``, the sample standard
    deviation from the column rollups), then each enum's levels (the
    ``.missing(NA)`` level when the column has NAs), then the
    intercept."""
    numeric_idx, enum_specs, coef_names = [], [], []
    means, stds = [], []
    for i, name in enumerate(data.feature_names):
        if data.feature_domains.get(name) is None:
            numeric_idx.append(i)
            r = frame.vec(name).rollups()
            mu = 0.0 if np.isnan(r["mean"]) else r["mean"]
            sd = r["sigma"] if standardize and r["sigma"] > 0 else 1.0
            means.append(mu)
            stds.append(sd)
            coef_names.append(name)
    for i, name in enumerate(data.feature_names):
        dom = data.feature_domains.get(name)
        if dom is not None:
            has_na = frame.vec(name).nacnt() > 0
            L = len(dom)
            codes = frame.vec(name).to_numpy()
            mode = int(np.bincount(codes[codes >= 0],
                                   minlength=L).argmax()) if L else 0
            enum_specs.append((i, L, has_na, mode))
            lo = 1 if drop_first else 0
            coef_names += [f"{name}.{d}" for d in dom[lo:]]
            if has_na:
                coef_names.append(f"{name}.missing(NA)")
    coef_names.append("Intercept")
    return DataInfo(coef_names, numeric_idx, enum_specs,
                    np.array(means, dtype=np.float32),
                    np.array(stds, dtype=np.float32),
                    len(coef_names), drop_first)
