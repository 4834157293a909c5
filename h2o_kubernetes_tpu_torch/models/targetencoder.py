"""Target encoding, the H2OTargetEncoderEstimator analog (the JAX
package's ``models/targetencoder.py``, copied and rewired).

A categorical column is replaced by the per-level mean of the response,
with three leakage-handling modes (``none``, ``leave_one_out``,
``k_fold``), optional blending toward the global prior (λ(n) =
1/(1 + exp(−(n − k)/f))) and optional uniform noise on training
transforms.

The per-level sums and counts (and, for ``k_fold``, per fold) are one
float64 ``index_add_`` each on the frame's device, as ``GroupBy`` sums;
the tables are kept as float64 numpy arrays. Encodings are formed on
the host in float64 from the tables, and the noise is numpy
``default_rng(seed)``'s, so both match the JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..frame import Frame, Vec
from ..runtime.mesh import single_process_only

__all__ = ["TargetEncoder", "TargetEncoderModel", "TargetEncoderParams"]

_MODES = ("none", "leave_one_out", "k_fold")


@dataclass
class TargetEncoderParams:
    data_leakage_handling: str = "none"   # see _MODES
    blending: bool = False
    inflection_point: float = 10.0        # k in λ(n) = σ((n − k)/f)
    smoothing: float = 20.0               # f
    noise: float = 0.01                   # uniform(±noise) on as_training
    fold_column: str | None = None        # required for k_fold
    seed: int = 0


def _level_sums(codes: torch.Tensor, y: torch.Tensor, live: torch.Tensor,
                n_seg: int) -> tuple[np.ndarray, np.ndarray]:
    """(Σy, count) per segment id in [0, n_seg) over the ``live`` rows:
    float64 ``index_add_`` on the codes' device."""
    seg = torch.where(live, codes, n_seg).long()
    s = torch.zeros(n_seg + 1, dtype=torch.float64, device=codes.device)
    c = torch.zeros_like(s)
    s.index_add_(0, seg, torch.where(live, y, 0.0))
    c.index_add_(0, seg, live.double())
    return s[:n_seg].cpu().numpy(), c[:n_seg].cpu().numpy()


class TargetEncoderModel:
    """A fitted encoder: per-column level -> encoding tables."""

    algo = "targetencoder"

    def __init__(self, params: TargetEncoderParams, y: str,
                 columns: list[str], prior: float, tables: dict[str, dict]):
        self.params = params
        self.y = y
        self.columns = columns
        self.prior = prior
        # per column: {"domain": [...], "sum": [card], "cnt": [card],
        #              "fold_sum": [F, card] | None, "fold_cnt": ...}
        self.tables = tables

    def _encode(self, sums: np.ndarray, cnts: np.ndarray) -> np.ndarray:
        mean = sums / np.maximum(cnts, 1.0)
        if self.params.blending:
            lam = 1.0 / (1.0 + np.exp(
                -(cnts - self.params.inflection_point)
                / max(self.params.smoothing, 1e-12)))
            enc = lam * mean + (1.0 - lam) * self.prior
        else:
            enc = mean
        return np.where(cnts > 0, enc, self.prior)

    def transform(self, frame: Frame, as_training: bool = False,
                  noise: float | None = None) -> Frame:
        """``frame`` with ``<col>_te`` columns appended (float32, on the
        frame's device). ``as_training=True`` applies the fitted leakage
        handling (fold-out or leave-one-out statistics) and the noise;
        False (scoring) uses the full-data encoding, no noise."""
        p = self.params
        rng = np.random.default_rng(p.seed)
        noise = p.noise if noise is None else noise
        out = Frame({n: frame.vec(n) for n in frame.names})
        mode = p.data_leakage_handling if as_training else "none"
        fold = None
        if mode == "k_fold":
            fold = np.nan_to_num(frame.vec(p.fold_column).to_numpy()) \
                .astype(np.int64)
        yv = None
        if mode == "leave_one_out":
            if self.y not in frame.names:
                raise ValueError(
                    "leave_one_out training transform needs the "
                    f"response column '{self.y}' in the frame")
            yraw = frame.vec(self.y)
            if yraw.is_enum():
                c = yraw.to_numpy()
                yv = np.where(c < 0, np.nan, (c == 1).astype(np.float64))
            else:
                yv = yraw.to_numpy().astype(np.float64)
        for col in self.columns:
            t = self.tables[col]
            codes = self._codes_for(frame.vec(col), t["domain"])
            sums = np.asarray(t["sum"], dtype=np.float64)
            cnts = np.asarray(t["cnt"], dtype=np.float64)
            safe = np.maximum(codes, 0)
            if mode == "k_fold":
                fs, fc = np.asarray(t["fold_sum"]), np.asarray(t["fold_cnt"])
                nf = fs.shape[0]
                enc_tab = np.stack([self._encode(sums - fs[f], cnts - fc[f])
                                    for f in range(nf)])      # [F, card]
                enc = enc_tab[np.clip(fold, 0, nf - 1), safe]
            elif mode == "leave_one_out":
                ok = ~np.isnan(yv)
                enc = self._encode(sums[safe] - np.where(ok, yv, 0.0),
                                   cnts[safe] - ok.astype(np.float64))
            else:
                enc = self._encode(sums, cnts)[safe]
            enc = np.where(codes >= 0, enc, self.prior)
            if as_training and noise > 0:
                enc = enc + rng.uniform(-noise, noise, size=enc.shape)
            out[f"{col}_te"] = Vec.from_numpy(
                enc.astype(np.float32), f"{col}_te", device=frame.device)
        return out

    @staticmethod
    def _codes_for(v: Vec, domain: list[str]) -> np.ndarray:
        """A column's codes on the TRAINING domain (unseen -> -1)."""
        if not v.is_enum():
            raise ValueError(f"'{v.name}' is not categorical")
        codes = v.to_numpy().astype(np.int64)
        if list(v.domain or []) == list(domain):
            return codes
        pos = {d: i for i, d in enumerate(domain)}
        lut = np.array([pos.get(d, -1) for d in (v.domain or [])] + [-1],
                       dtype=np.int64)
        return lut[np.where(codes < 0, len(lut) - 1, codes)]

    @property
    def _artifact_meta(self) -> dict:
        """The MOJO-v2 meta (the scoring transform: full-data tables)."""
        p = self.params
        return {"algo": "targetencoder", "feature_names": [],
                "feature_domains": {}, "nclasses": 1,
                "response_domain": None, "distribution": None,
                "offset_column": None, "te_columns": list(self.columns),
                "prior": float(self.prior), "blending": bool(p.blending),
                "inflection_point": float(p.inflection_point),
                "smoothing": float(p.smoothing),
                "te_domains": {c: list(self.tables[c]["domain"])
                               for c in self.columns}}

    @property
    def _artifact_arrays(self) -> dict:
        out = {}
        for i, c in enumerate(self.columns):
            out[f"te_sum_{i}"] = np.asarray(self.tables[c]["sum"])
            out[f"te_cnt_{i}"] = np.asarray(self.tables[c]["cnt"])
        return out


class TargetEncoder:
    """H2OTargetEncoderEstimator analog (fit on train, then transform)."""

    def __init__(self, **kw):
        self.params = TargetEncoderParams(**kw)
        if self.params.data_leakage_handling not in _MODES:
            raise ValueError(
                f"unknown data_leakage_handling "
                f"'{self.params.data_leakage_handling}' "
                f"(supported: {', '.join(_MODES)})")

    def train(self, y: str, training_frame: Frame,
              x: Sequence[str] | None = None) -> TargetEncoderModel:
        single_process_only("TargetEncoder")
        p = self.params
        if p.data_leakage_handling == "k_fold" and not p.fold_column:
            raise ValueError("k_fold leakage handling needs fold_column")
        fr = training_frame
        yv = fr.vec(y)
        if yv.is_enum():
            if yv.cardinality() != 2:
                raise ValueError("target encoding needs a numeric or "
                                 "binary response")
            yn = (yv.data == 1).double()
            ok = yv.data >= 0
        else:
            raw = yv.as_float().double()
            ok = ~torch.isnan(raw)
            yn = torch.nan_to_num(raw)
        cols = list(x) if x is not None else [
            n for n in fr.names
            if n not in (y, p.fold_column) and fr.vec(n).is_enum()]
        if not cols:
            raise ValueError("no categorical columns to encode")
        # the prior as numpy sums it (pairwise), so it is the reference's
        yn_np, ok_np = yn.cpu().numpy(), ok.cpu().numpy()
        prior = float(yn_np[ok_np].mean()) if ok_np.any() else 0.0
        fold, nf = None, 0
        if p.data_leakage_handling == "k_fold":
            fv = fr.vec(p.fold_column).as_float()
            fold = torch.nan_to_num(fv).long()
            nf = int(fold.max()) + 1 if fold.numel() else 1
        tables: dict[str, dict] = {}
        for col in cols:
            v = fr.vec(col)
            if not v.is_enum():
                raise ValueError(f"column '{col}' is not categorical")
            card = v.cardinality()
            codes = v.data.long()
            live = ok & (codes >= 0)
            s, c = _level_sums(codes, yn, live, card)
            t = {"domain": list(v.domain or []), "sum": s, "cnt": c,
                 "fold_sum": None, "fold_cnt": None}
            if fold is not None:
                fs, fc = _level_sums(fold * card + codes, yn, live,
                                     nf * card)
                t["fold_sum"] = fs.reshape(nf, card)
                t["fold_cnt"] = fc.reshape(nf, card)
            tables[col] = t
        return TargetEncoderModel(p, y, cols, prior, tables)
