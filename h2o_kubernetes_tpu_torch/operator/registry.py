"""The scorer replica's model: a MOJO-v2 tree artifact on a device.

A scorer replica never sees the training stack: it gets an artifact
over ``POST /3/ModelRegistry/load`` and wraps its flat arrays in a
``FlatTreeScorer`` — a ``Model`` whose ``_score_matrix`` descends
``flat_margin`` over the artifact's ``flat_*`` arrays, and whose
contributions come from the TreeSHAP tables built from the same arrays
plus ``flat_cover``. Format-v1 artifacts (heap trees + bin edges) are
rejected: they have no serving arrays.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..models.base import Model
from ..mojo import MOJO_FORMAT, read_mojo_parts
from ..runtime.backend import resolve_device

__all__ = ["FlatTreeScorer", "load_artifact", "SERVABLE_ALGOS"]

SERVABLE_ALGOS = ("gbm", "drf", "xgboost")

_FLAT_PARTS = ("split_feat", "thresh", "left", "na_left", "value")


def _check_flat_arrays(arrays: dict, n_features: int) -> None:
    """Reject flat arrays whose indices leave their tables. Artifacts
    arrive over REST; on a CUDA device an out-of-range split feature or
    child pointer is an unchecked gather in the descent and an
    unchecked write into φ in the TreeSHAP kernel."""
    sf = arrays["flat_split_feat"]
    if sf.ndim != 2 or sf.shape[1] < 1:
        raise ValueError(f"flat_split_feat must be [trees, nodes], got "
                         f"{sf.shape}")
    for k, a in arrays.items():
        if k.startswith("flat_") and a.shape != sf.shape:
            raise ValueError(f"{k} has shape {a.shape}, flat_split_feat "
                             f"{sf.shape}")
    if arrays["enum_mask"].shape != (n_features,):
        raise ValueError(f"enum_mask has shape {arrays['enum_mask'].shape}"
                         f" for {n_features} features")
    split = sf >= 0
    if (sf[split] >= n_features).any():
        raise ValueError(f"flat_split_feat names a feature >= "
                         f"{n_features} — corrupt or tampered")
    left = arrays["flat_left"][split].astype(np.int64)
    if ((left < 1) | (left + 1 >= sf.shape[1])).any():
        raise ValueError(f"flat_left points outside the {sf.shape[1]} "
                         "nodes of a tree — corrupt or tampered")


class FlatTreeScorer(Model):
    """Servable model built from a MOJO-v2 tree artifact's numpy
    arrays and ``model.json`` meta, on ``device`` (None = the CUDA
    card; raises without one unless ``device="cpu"``)."""

    def __init__(self, meta: dict, arrays: dict, device=None):
        self.device = resolve_device(device)
        self._artifact_meta = dict(meta)
        keep = ["init_score", "enum_mask"] + [f"flat_{f}"
                                              for f in _FLAT_PARTS]
        if "flat_cover" in arrays:
            # optional cover part: enables serving contributions
            keep.append("flat_cover")
        self._artifact_arrays = {k: np.asarray(arrays[k]) for k in keep}
        _check_flat_arrays(self._artifact_arrays,
                           len(meta["feature_names"]))
        self.algo = meta["algo"]
        self.feature_names = list(meta["feature_names"])
        self.feature_domains = dict(meta.get("feature_domains") or {})
        self.nclasses = int(meta["nclasses"])
        self.response_domain = meta.get("response_domain")
        self.distribution = meta.get("distribution")
        self.offset_column = meta.get("offset_column")
        self.ntrees = int(meta["ntrees"])
        self.max_depth = int(meta["max_depth"])
        self.drf_mode = bool(meta["drf_mode"])
        self.margin_scale = float(meta.get("margin_scale", 1.0))
        self.init_score = np.asarray(self._artifact_arrays["init_score"])

    def _serving_prepare(self):
        """Build (or fetch) the device arrays; returns (FlatTrees,
        enum mask, init score)."""
        ft = self.__dict__.get("_flat_trees")
        if ft is not None:
            return ft, self._enum_mask, self._init_t
        from ..models.tree.core import FlatTrees

        a = self._artifact_arrays
        dev = self.device
        self._enum_mask = torch.as_tensor(
            np.asarray(a["enum_mask"]).astype(bool), device=dev)
        self._init_t = torch.as_tensor(
            np.asarray(a["init_score"], dtype=np.float32).reshape(-1),
            device=dev)
        ft = FlatTrees(*(torch.as_tensor(a[f"flat_{f}"], device=dev)
                         for f in _FLAT_PARTS))
        self._flat_trees = ft
        return ft, self._enum_mask, self._init_t

    # -- TreeSHAP contributions ---------------------------------------------

    def contrib_support(self) -> "str | None":
        if int(self.nclasses) > 2:
            return ("predict_contributions supports binomial "
                    "and regression models only")
        if self.offset_column:
            return ("predict_contributions is not supported "
                    "for models trained with an offset")
        if "flat_cover" not in self._artifact_arrays:
            return (
                "this artifact was exported without per-node cover; "
                "TreeSHAP needs it — re-export the model")
        return None

    def _shap_sources(self):
        from ..models.tree.core import FlatTrees

        a = self._artifact_arrays
        flat = FlatTrees(*(np.asarray(a[f"flat_{f}"]) for f in _FLAT_PARTS))
        return flat, np.asarray(a["flat_cover"])

    def _contrib_enum_mask(self) -> torch.Tensor:
        return self._serving_prepare()[1]

    def _contrib_scale_init(self) -> tuple[float, float]:
        scale = float(self.margin_scale)
        if self.drf_mode:
            scale /= self.ntrees
        return scale, float(np.asarray(self.init_score).ravel()[0])

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        from ..models.tree.core import flat_margin

        ft, em, init = self._serving_prepare()
        K = self.nclasses if self.nclasses > 2 else 1
        lv = flat_margin(ft, X, em, self.max_depth, K)      # [K, rows]
        if K == 1:
            m = lv[0]
            if self.drf_mode:
                m = m / self.ntrees
            base = init if offset is None else init + offset
            m = base + self.margin_scale * m
        else:
            if self.drf_mode:
                lv = lv / (self.ntrees // K)
            m = (init[:, None] + lv).T
        d = self.distribution
        if d == "bernoulli":
            p1 = torch.clamp(m, 0.0, 1.0) if self.drf_mode \
                else torch.sigmoid(m)
            return torch.stack([1.0 - p1, p1], dim=1)
        if d == "multinomial":
            if self.drf_mode:
                m = torch.clamp(m, min=0.0)
                return m / (torch.sum(m, dim=1, keepdim=True) + 1e-10)
            return torch.softmax(m, dim=1)
        if d in ("poisson", "gamma", "tweedie"):
            return torch.exp(m)
        return m


def load_artifact(blob: bytes, device=None) -> FlatTreeScorer:
    """MOJO-v2 artifact bytes -> a servable FlatTreeScorer on
    ``device``. Rejects format-v1 artifacts and non-tree algos."""
    meta, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    if meta.get("format") != MOJO_FORMAT:
        raise ValueError(
            f"artifact format {meta.get('format')!r} is not servable "
            f"by a scorer replica (need {MOJO_FORMAT}): format-v1 "
            "artifacts carry heap trees + bin edges, not the flattened "
            "serving arrays — re-export the model")
    if meta.get("algo") not in SERVABLE_ALGOS:
        raise ValueError(
            f"algo '{meta.get('algo')}' is not servable by a scorer "
            f"replica (supported: {', '.join(SERVABLE_ALGOS)})")
    if "flat_split_feat" not in arrays:
        raise ValueError("artifact claims MOJO-v2 but lacks the flat_* "
                         "serving arrays — corrupt or tampered")
    return FlatTreeScorer(meta, arrays, device=device)
