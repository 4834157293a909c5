"""Aggregator, exemplar-based reduction of a frame (the JAX package's
``models/aggregator.py``, hex/aggregator's analog): one pass admits
each row to the first exemplar within a radius or makes it a new
exemplar; exemplars carry member counts, and the radius is bisected
until the exemplar count lands within ``rel_tol_num_exemplars`` of the
target. The output is the exemplar rows plus a ``counts`` column.

Admission is sequential, so its loop is the reference's, on the host,
over 4,096-row batches. The batch-by-exemplar squared distances are one
float64 product on the frame's device (a float32 one decides a row at
the radius by its summation order, which differs between devices), at
the reference's power-of-two padded exemplar capacities; the device
returns each row's nearest exemplar and its distance (one sync a
batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..frame import Frame, Vec
from ..runtime.mesh import single_process_only
from .base import resolve_x
from .datainfo import build_datainfo, design

__all__ = ["Aggregator", "AggregatorModel", "AggregatorParams",
           "aggregate"]

_BATCH = 4096


@dataclass
class AggregatorParams:
    target_num_exemplars: int = 100
    rel_tol_num_exemplars: float = 0.5
    transform: str = "STANDARDIZE"
    seed: int = 0


def _dist2(B: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """float64 squared distances [b, cap] between batch rows and
    exemplars."""
    B, E = B.double(), E.double()
    return ((B * B).sum(1)[:, None] - 2.0 * B @ E.T
            + (E * E).sum(1)[None, :])


def _capacity(m: int) -> int:
    """The power-of-two exemplar capacity the distances run at."""
    cap = 1
    while cap < m:
        cap *= 2
    return cap


def aggregate(Xs: torch.Tensor, radius2: float,
              batch: int = _BATCH) -> tuple[np.ndarray, np.ndarray]:
    """One pass -> (exemplar row indices, member counts)."""
    n, F = Xs.shape
    ex_idx: list[int] = [0]
    counts = np.ones(1, dtype=np.int64)
    E = torch.full((1, F), float("inf"), device=Xs.device)
    E[0] = Xs[0]
    i = 1
    while i < n:
        m = len(ex_idx)
        cap = _capacity(m)
        if E.shape[0] < cap:    # padding rows sit at +inf, past [:m]
            E = torch.cat([E, torch.full((cap - E.shape[0], F),
                                         float("inf"), device=Xs.device)])
        d2 = _dist2(Xs[i: i + batch], E)[:, :m]
        dmin, assign = torch.min(d2, dim=1)
        near = (dmin <= radius2).cpu().numpy()          # the batch's sync
        assign = assign.cpu().numpy()
        # rows inside the radius of an exemplar join it; the FIRST row
        # outside becomes a new exemplar, then the batch is examined
        # again against the grown set
        out = np.flatnonzero(~near)
        upto = out[0] if len(out) else len(near)
        np.add.at(counts, assign[:upto], 1)
        if len(out):
            new = i + int(out[0])
            ex_idx.append(new)
            counts = np.append(counts, 1)
            if E.shape[0] == m:
                E = torch.cat([E, Xs[new: new + 1]])
            else:
                E[m] = Xs[new]
            i = new + 1
        else:
            i += len(near)
    return np.asarray(ex_idx), counts


class AggregatorModel:
    algo = "aggregator"

    def __init__(self, data, params: AggregatorParams, frame: Frame,
                 ex_idx: np.ndarray, counts: np.ndarray):
        self.feature_names = list(data.feature_names)
        self.params = params
        self._frame = frame
        self._ex_idx = ex_idx
        self._counts = counts

    @property
    def aggregated_frame(self) -> Frame:
        out = self._frame.select_rows(self._ex_idx)
        out["counts"] = Vec.from_numpy(self._counts.astype(np.float32),
                                       "counts", device=out.device)
        return out

    def num_exemplars(self) -> int:
        return len(self._ex_idx)


class Aggregator:
    """H2OAggregatorEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        CVArgs.pop(kw)
        self.params = AggregatorParams(**kw)

    def train(self, training_frame: Frame,
              x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              y: str | None = None) -> AggregatorModel:
        single_process_only("Aggregator")
        p = self.params
        if p.target_num_exemplars < 1:
            raise ValueError("target_num_exemplars must be >= 1")
        ignored = list(ignored_columns or []) + ([y] if y else [])
        data = resolve_x(training_frame, x, ignored)
        dinfo = build_datainfo(data, training_frame,
                               standardize=p.transform == "STANDARDIZE",
                               drop_first=False)
        Xe = dinfo.expand(design(training_frame, data.feature_names))[:, :-1]
        n, F = Xe.shape
        target = min(p.target_num_exemplars, n)
        lo_ok = max(1, int(target * (1 - p.rel_tol_num_exemplars)))
        hi_ok = int(np.ceil(target * (1 + p.rel_tol_num_exemplars)))
        # bisect the radius until the exemplar count lands in tolerance
        lo, hi = 0.0, float(4.0 * F)
        best, best_gap = None, np.inf
        for _ in range(20):
            mid = (lo + hi) / 2
            ex_idx, counts = aggregate(Xe, mid)
            m = len(ex_idx)
            gap = abs(m - target)
            if gap < best_gap:          # keep the closest attempt
                best, best_gap = (ex_idx, counts), gap
            if lo_ok <= m <= hi_ok:
                break
            if m > hi_ok:      # too many exemplars: widen the radius
                lo = mid
            else:
                hi = mid
        return AggregatorModel(data, p, training_frame, *best)
