"""CoxPH, Cox proportional hazards with Efron or Breslow ties (the JAX
package's ``models/coxph.py``, hex/coxph's analog): Newton-Raphson on
the partial log-likelihood.

Rows are sorted by stop time once on the host (descending, stable), so
each Newton step's risk-set sums are prefix sums in that order: S0, S1
and the [P, P] second moment S2 at each tie group's last row (the
prefix sums over groups of the per-group sums), and the event-only
sums per tie group, then Efron's
correction over the group's tied events (at most ``L_CAP = 32``, which
``train`` checks; each of its slots visits only the groups with that
many events) or Breslow's single denominator. The step runs on the
frame's device; the per-row terms (η, r = exp(η − max η)) are float32
as in the reference and the sums accumulate in float64 (a float32
prefix sum over a million rows keeps only a few digits of the risk
set), as do the gradient, the Hessian and the Newton solve. The host
loop reads the log-likelihood once a step, to stop.
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

__all__ = ["CoxPH", "CoxPHModel", "CoxPHParams", "L_CAP", "cox_step",
           "tie_slots"]

L_CAP = 32          # Efron's tied events per group the step handles


@dataclass
class CoxPHParams:
    stop_column: str = ""              # event/censoring time
    event_column: str = ""             # 1 = event, 0 = censored
    ties: str = "efron"                # efron | breslow
    max_iterations: int = 20
    tolerance: float = 1e-8
    seed: int = 0


def _seg(v: torch.Tensor, grp: torch.Tensor, ngrp: int) -> torch.Tensor:
    """Per-group float64 sums of [n, ...] rows."""
    out = torch.zeros((ngrp,) + tuple(v.shape[1:]), dtype=torch.float64,
                      device=v.device)
    return out.index_add_(0, grp, v)


def tie_slots(d_g: np.ndarray, ties: str) -> list[np.ndarray]:
    """The groups each denominator slot visits: Efron's slot l the
    groups of more than l tied events (l < the largest group), Breslow's
    one slot every group with an event. The reference scans all
    ``L_CAP`` slots over every group; a group's slots past its events
    add exactly zero there."""
    if ties == "breslow":
        return [np.flatnonzero(d_g > 0)]
    return [np.flatnonzero(d_g > l) for l in range(int(d_g.max()))]


def cox_step(X: torch.Tensor, ev: torch.Tensor, grp: torch.Tensor,
             ngrp: int, slots: list[torch.Tensor], beta: torch.Tensor,
             ties: str):
    """One Newton step's (log-likelihood, gradient, Hessian), float64.

    X: [n, P] float32 covariates in time-DESCENDING order; ev: [n] event
    flags; grp: [n] tie-group ids in the same order (0 = the latest
    time); ``slots``: ``tie_slots``' groups, on X's device. A group's
    risk set is every row up to its last one, so its risk-set sums are
    the prefix sums, over groups, of the per-group sums (a scan over the
    groups, not the rows)."""
    eta = X @ beta                                          # float32
    mx = torch.max(eta)
    r = torch.exp(eta - mx).double()
    Xd, evd = X.double(), ev.double()
    n, P = X.shape
    # per row: r, r·x, r·xxᵀ; per group their sums, all rows and events
    rows = torch.cat([r[:, None], r[:, None] * Xd,
                      ((r[:, None] * Xd)[:, :, None] * Xd[:, None, :])
                      .reshape(n, P * P)], dim=1)
    S = torch.cumsum(_seg(rows, grp, ngrp).T.contiguous(), dim=1).T
    E = _seg(rows * evd[:, None], grp, ngrp)
    del rows
    S0_g, S1_g = S[:, 0], S[:, 1: 1 + P]
    S2_g = S[:, 1 + P:].reshape(ngrp, P, P)
    s0e_g, s1e_g = E[:, 0], E[:, 1: 1 + P]
    s2e_g = E[:, 1 + P:].reshape(ngrp, P, P)
    d_g = _seg(evd, grp, ngrp)                              # events/group
    xe = (evd[:, None] * Xd).sum(0)
    eta_e = (evd * eta.double()).sum()
    ll_den = torch.zeros((), dtype=torch.float64, device=X.device)
    g_den = torch.zeros(P, dtype=torch.float64, device=X.device)
    H = torch.zeros((P, P), dtype=torch.float64, device=X.device)
    for l_idx, g in enumerate(slots):
        d = d_g[g]
        if ties == "efron":
            frac, weight = l_idx / d, torch.ones_like(d)
        else:
            frac, weight = torch.zeros_like(d), d
        phi0 = torch.clamp(S0_g[g] - frac * s0e_g[g], min=1e-30)
        mean = (S1_g[g] - frac[:, None] * s1e_g[g]) / phi0[:, None]
        phi2 = S2_g[g] - frac[:, None, None] * s2e_g[g]
        ll_den = ll_den - (weight * torch.log(phi0)).sum()
        g_den = g_den - (weight[:, None] * mean).sum(0)
        H = H + (weight[:, None, None] * (phi2 / phi0[:, None, None]
                                          - mean[:, :, None]
                                          * mean[:, None, :])).sum(0)
    # each of the Σd denominator terms carries a -mx from the scaling
    ll = eta_e + ll_den - mx.double() * d_g.sum()
    return ll, xe + g_den, H


class CoxPHModel(LearnerModel):
    algo = "coxph"

    def __init__(self, data: TrainData, params: CoxPHParams,
                 dinfo: DataInfo, beta: torch.Tensor, names: list[str],
                 loglik: float, loglik_null: float, n_events: int,
                 iterations: int):
        self._init_layout(data, beta.device)
        self.params = params
        self.dinfo = dinfo
        self.beta = beta                    # [P] float32, original units
        self._names = names
        self.loglik = loglik
        self.loglik_null = loglik_null
        self.n_events = n_events
        self.iterations = iterations

    def coef(self) -> dict[str, float]:
        return dict(zip(self._names, self.beta.cpu().double().numpy()))

    def hazard_ratios(self) -> dict[str, float]:
        return {k: float(np.exp(v)) for k, v in self.coef().items()}

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        """The linear predictor (log partial hazard), h2o's predict."""
        return self._expand(X) @ self.beta

    def concordance(self, frame: Frame) -> float:
        """Harrell's c-index on (stop, event) against the risk score."""
        p = self.params
        risk = self.predict_raw(frame)
        t = frame.vec(p.stop_column).to_numpy()
        e = frame.vec(p.event_column).to_numpy()
        conc = disc = 0
        for i in np.flatnonzero(e > 0):
            later = t > t[i]
            conc += int(np.sum(risk[i] > risk[later]))
            disc += int(np.sum(risk[i] < risk[later]))
        return conc / max(conc + disc, 1)

    @property
    def _artifact_meta(self) -> dict:
        return self._meta_common()

    @property
    def _artifact_arrays(self) -> dict:
        return dict(self._arrays_common(), beta=self.beta.cpu().numpy())


class CoxPH:
    """H2OCoxProportionalHazardsEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        CVArgs.pop(kw)
        self.params = CoxPHParams(**kw)

    def train(self, training_frame: Frame,
              x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              y: str | None = None) -> CoxPHModel:
        single_process_only("CoxPH")
        p = self.params
        if not p.stop_column or not p.event_column:
            raise ValueError("CoxPH needs stop_column and event_column")
        if p.ties not in ("efron", "breslow"):
            raise ValueError(f"unknown ties '{p.ties}'")
        ignored = list(ignored_columns or []) + [p.stop_column,
                                                p.event_column]
        fr = training_frame
        data = resolve_x(fr, x, ignored)
        dinfo = build_datainfo(data, fr, standardize=False, drop_first=True)
        dev = fr.device
        t = fr.vec(p.stop_column).to_numpy().astype(np.float64)
        e = fr.vec(p.event_column).to_numpy().astype(np.float64)
        Xraw = design(fr, data.feature_names)
        ok = ~(np.isnan(t) | np.isnan(e)
               | torch.isnan(Xraw).any(dim=1).cpu().numpy())
        t, e = t[ok], e[ok]
        okt = torch.as_tensor(ok, device=dev)
        X = dinfo.expand(Xraw[okt])[:, :-1].cpu().numpy().astype(np.float64)
        coef_names = dinfo.coef_names[:-1]
        # standardize for conditioning; de-standardize beta at the end
        mu, sd = X.mean(axis=0), X.std(axis=0) + 1e-12
        order = np.argsort(-t, kind="stable")      # time-descending
        Xs, e_o, t_o = ((X - mu) / sd)[order], e[order], t[order]
        grp = np.zeros(len(t_o), dtype=np.int64)
        if len(t_o) > 1:
            grp[1:] = np.cumsum(t_o[1:] != t_o[:-1])
        ngrp = int(grp.max()) + 1 if len(grp) else 1
        if e_o.sum() == 0:
            raise ValueError("no events in the training frame")
        d_g = np.bincount(grp, weights=e_o, minlength=ngrp)
        d_max = int(d_g.max())
        if d_max > L_CAP and p.ties == "efron":
            raise ValueError(
                f"{d_max} tied events exceed the Efron cap ({L_CAP}); use "
                "ties='breslow'")
        slots = [torch.as_tensor(g, device=dev)
                 for g in tie_slots(d_g, p.ties)]
        Xj = torch.as_tensor(Xs, dtype=torch.float32, device=dev)
        ej = torch.as_tensor(e_o, dtype=torch.float32, device=dev)
        gj = torch.as_tensor(grp, device=dev)
        P = Xj.shape[1]
        beta = torch.zeros(P, dtype=torch.float32, device=dev)
        eye = torch.eye(P, dtype=torch.float64, device=dev)
        ll_prev, ll0, it = -np.inf, None, 0
        for it in range(1, p.max_iterations + 1):
            ll, g, H = cox_step(Xj, ej, gj, ngrp, slots, beta, p.ties)
            llf = float(ll)                        # the step's one sync
            if ll0 is None:
                ll0 = llf       # beta starts at 0: the null likelihood
            beta = beta + torch.linalg.solve(H + 1e-8 * eye, g).float()
            if abs(llf - ll_prev) < p.tolerance * (abs(llf) + 1e-10):
                break
            ll_prev = llf
        ll_final = float(cox_step(Xj, ej, gj, ngrp, slots, beta,
                                  p.ties)[0])
        beta_orig = torch.as_tensor(beta.cpu().double().numpy() / sd,
                                    dtype=torch.float32, device=dev)
        return CoxPHModel(data, p, dinfo, beta_orig, coef_names, ll_final,
                          ll0, int(e.sum()), it)
