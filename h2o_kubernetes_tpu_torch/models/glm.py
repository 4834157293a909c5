"""GLM — generalized linear models (IRLSM, L-BFGS, coordinate descent)
on one device, or on the rows of a row group.

``GLM(family=..., solver=...).train(y=..., training_frame=...)`` is the
JAX package's entry point; it trains where the frame lives (the card by
default). Each IRLS iteration forms the working weights and response
from the current linear predictor, accumulates the weighted Gram XᵀWX
and XᵀWz of the expanded design (``models/datainfo.py``) as ONE float32
product on the device, and solves the [P, P] system there: a Cholesky
solve (``torch.linalg.cholesky``/``cholesky_solve``), ADMM around it when
an L1 penalty is active, or cyclic coordinate descent. The intercept is
the last coefficient and is never penalized. The arithmetic is float32,
as the JAX package's.

Families (with their links): gaussian (identity), binomial (logit),
poisson (log), gamma (inverse or log), tweedie (log, variance power in
(1, 2)), negativebinomial (log, ``theta``) and multinomial (softmax; IRLSM
cycles the classes with per-class Fisher scoring, L_BFGS runs on the
whole [P, K] matrix). L_BFGS minimizes the penalized half-deviance over
the weight sum with a plain L-BFGS (memory 10, a line search that meets
the strong Wolfe conditions, gradients from ``torch.autograd``); the JAX
package uses optax's, so the two meet at the optimum, not along the
way. ``lambda_search`` fits a warm-started descending λ path;
``compute_p_values`` gives standard errors, z and p values from the
inverse Fisher information (λ = 0, IRLSM only). ``nfolds``/
``fold_column`` cross-validate (``models/cv.py``).

On a row group (``runtime/mesh.py``) each rank accumulates G, b and the
deviance over its own rows and all-reduces them, as the JAX package
psums them over its ROWS axis; the L-BFGS objective's value and
gradient are all-reduced the same way. Every rank then solves the same
[P, P] system. The JAX package's COLS axis (a feature-sharded Gram) is
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import erfc, sqrt
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..runtime import mrtask
from ..runtime.mesh import n_row_shards, single_process_only
from .base import Model, TrainData, resolve_xy
from .datainfo import DataInfo, build_datainfo, design, expand

__all__ = ["GLM", "GLMModel", "GLMParams", "glm_model_from_arrays"]

_FAMILIES = ("gaussian", "binomial", "poisson", "gamma", "tweedie",
             "negativebinomial", "multinomial")
_SOLVERS = ("IRLSM", "L_BFGS", "COORDINATE_DESCENT")
_DEFAULT_LINK = {"gaussian": "identity", "binomial": "logit",
                 "poisson": "log", "gamma": "inverse", "tweedie": "log",
                 "negativebinomial": "log", "multinomial": "multinomial"}
# the distribution a family's response resolves as (and its model
# reports), the JAX package's mapping
_FAMILY_DIST = {"binomial": "bernoulli", "gamma": "gaussian",
                "tweedie": "gaussian", "negativebinomial": "poisson"}
_LBFGS_MEMORY = 10
_WOLFE_C1, _WOLFE_C2 = 1e-4, 0.9
_APPROX_DEC_RTOL = 1e-6
_LINESEARCH_STEPS = 20


@dataclass
class GLMParams:
    family: str = "gaussian"          # see _FAMILIES
    solver: str = "IRLSM"             # see _SOLVERS
    link: str | None = None           # None -> the family's default
    alpha: float = 0.5                # elastic-net mixing (1 = lasso)
    lambda_: float | None = None      # None -> 0 unless lambda_search
    lambda_search: bool = False
    nlambdas: int = 30
    lambda_min_ratio: float = 1e-4
    standardize: bool = True
    use_all_factor_levels: bool = False
    max_iterations: int = 50
    objective_epsilon: float = 1e-6
    beta_epsilon: float = 1e-4
    tweedie_variance_power: float = 1.5   # p in (1, 2)
    theta: float = 1.0                    # negativebinomial dispersion
    compute_p_values: bool = False
    seed: int = 0


# -- link/family math --------------------------------------------------------

class FamSpec(NamedTuple):
    """(family, link, tweedie variance power, negativebinomial theta)."""

    family: str
    link: str
    tvp: float = 1.5
    theta: float = 1.0


def _famspec(p: GLMParams) -> FamSpec:
    return FamSpec(p.family, p.link or _DEFAULT_LINK[p.family],
                   p.tweedie_variance_power, p.theta)


def _linkinv(fam: FamSpec, eta):
    if fam.link == "logit":
        return torch.sigmoid(eta)
    if fam.link == "log":
        return torch.exp(torch.clamp(eta, -30, 30))
    if fam.link == "inverse":
        # keep eta away from 0, keeping its sign
        e = torch.where(torch.abs(eta) < 1e-6,
                        torch.where(eta < 0, -1e-6, 1e-6), eta)
        return 1.0 / e
    return eta


def _linkfun(fam: FamSpec, mu):
    if fam.link == "logit":
        return torch.log(mu / (1.0 - mu))
    if fam.link == "log":
        return torch.log(mu)
    if fam.link == "inverse":
        return 1.0 / mu
    return mu


def _dmu_deta(fam: FamSpec, eta, mu):
    if fam.link == "logit":
        return mu * (1.0 - mu)
    if fam.link == "log":
        return mu
    if fam.link == "inverse":
        return -(mu * mu)
    return torch.ones_like(eta)


def _variance_fn(fam: FamSpec, mu):
    f = fam.family
    if f == "binomial":
        return mu * (1.0 - mu)
    if f == "poisson":
        return mu
    if f == "gamma":
        return mu * mu
    if f == "tweedie":
        return torch.pow(torch.clamp(mu, min=1e-10), fam.tvp)
    if f == "negativebinomial":
        return mu + fam.theta * mu * mu
    return torch.ones_like(mu)


def _family_deviance(fam: FamSpec, y, mu, w):
    """Σ w·deviance (a 0-dim float32 tensor)."""
    f = fam.family
    if f == "binomial":
        mu = torch.clamp(mu, 1e-7, 1 - 1e-7)
        ll = y * torch.log(mu) + (1 - y) * torch.log1p(-mu)
        return -2.0 * torch.sum(w * ll)
    if f == "poisson":
        mu = torch.clamp(mu, min=1e-10)
        t = torch.where(y > 0, y * torch.log(y / mu), 0.0)
        return 2.0 * torch.sum(w * (t - (y - mu)))
    if f == "gamma":
        mu = torch.clamp(mu, min=1e-10)
        ys = torch.clamp(y, min=1e-10)
        return 2.0 * torch.sum(w * ((y - mu) / mu - torch.log(ys / mu)))
    if f == "tweedie":
        p_ = fam.tvp
        mu = torch.clamp(mu, min=1e-10)
        ys = torch.clamp(y, min=0.0)
        t1 = torch.where(ys > 0,
                         torch.pow(torch.clamp(ys, min=1e-10), 2 - p_) /
                         ((1 - p_) * (2 - p_)), 0.0)
        return 2.0 * torch.sum(w * (
            t1 - ys * torch.pow(mu, 1 - p_) / (1 - p_)
            + torch.pow(mu, 2 - p_) / (2 - p_)))
    if f == "negativebinomial":
        th = fam.theta
        mu = torch.clamp(mu, min=1e-10)
        t1 = torch.where(y > 0,
                         y * torch.log(torch.clamp(y, min=1e-10) / mu), 0.0)
        t2 = (y + 1.0 / th) * torch.log((1 + th * y) / (1 + th * mu))
        return 2.0 * torch.sum(w * (t1 - t2))
    return torch.sum(w * (y - mu) ** 2)


def _irls_weights(fam: FamSpec, eta, mu, y):
    """(working weight, working response) of one IRLS step: wk =
    (dμ/dη)²/V(μ), z = η + (y - μ)/(dμ/dη), Fisher scoring."""
    if fam.family == "gaussian" and fam.link == "identity":
        return torch.ones_like(eta), y
    d = _dmu_deta(fam, eta, mu)
    V = _variance_fn(fam, mu)
    safe_d = torch.where(torch.abs(d) < 1e-10,
                         torch.where(d < 0, -1e-10, 1e-10), d)
    wk = torch.clamp(d * d / torch.clamp(V, min=1e-10), min=1e-10)
    z = eta + (y - mu) / safe_d
    return wk, z


# -- the per-iteration passes over the rows ----------------------------------

def _gram_task(Xe, wk, z, w):
    """(G = XeᵀWXe [P, P], b = XeᵀWz [P]), W = wk·w: one product,
    Xeᵀ(W·[Xe | z]), on this rank's rows, then one all-reduce over the
    row group (the JAX package's ``psum`` of G and b)."""
    P = Xe.shape[1]
    Gb = Xe.T @ ((wk * w)[:, None] * torch.cat([Xe, z[:, None]], dim=1))
    Gb = mrtask.allreduce(Gb, "sum", site="gram")
    return Gb[:, :P], Gb[:, P]


def _softmax_irls_task(Xe, B, y, k: int):
    """Class k's working (wk, z) from the softmax at the [P, K]
    coefficients: the class-k block of the block-diagonal Fisher
    update."""
    eta = Xe @ B
    pk = torch.clamp(torch.softmax(eta, dim=1)[:, k], 1e-10, 1.0 - 1e-10)
    wk = torch.clamp(pk * (1.0 - pk), min=1e-10)
    yk = (y == k).to(torch.float32)
    return wk, eta[:, k] + (yk - pk) / wk


def _eta_dev_task(Xe, beta, y, w, off, fam: FamSpec, reduce: bool = True):
    """(Σ w·deviance over the row group — this rank's alone with
    ``reduce=False`` — and this rank's linear predictor Xe·β +
    offset)."""
    eta = Xe @ beta + off
    dev = _family_deviance(fam, y, _linkinv(fam, eta), w)
    if reduce:
        dev = mrtask.allreduce(dev, "sum", site="deviance")
    return dev, eta


def _pen_mask(P: int, device) -> torch.Tensor:
    """1 per penalized coefficient: all but the intercept (last)."""
    m = torch.ones(P, device=device)
    m[P - 1] = 0.0
    return m


def _soft(x, k):
    return torch.sign(x) * torch.clamp(torch.abs(x) - k, min=0.0)


def _admm_solve(G, b, lam_l1: float, lam_l2: float, n_iter: int = 100):
    """argmin ½βᵀGβ - bᵀβ + λ₁|β|₁ + ½λ₂|β|², intercept unpenalized:
    ``n_iter`` ADMM steps around one Cholesky factor."""
    P = G.shape[0]
    pen = _pen_mask(P, G.device)
    rho = max(lam_l1, 1e-3)
    eye = torch.eye(P, device=G.device)
    A = G + (lam_l2 * pen + rho * pen)[:, None] * eye + 1e-6 * eye
    L = torch.linalg.cholesky(A)
    zb = torch.zeros(P, device=G.device)
    u = torch.zeros(P, device=G.device)
    for _ in range(n_iter):
        beta = torch.cholesky_solve((b + rho * pen * (zb - u))[:, None],
                                    L)[:, 0]
        zb_new = _soft(beta + u, lam_l1 / rho) * pen + \
            (beta + u) * (1 - pen)
        u = u + beta - zb_new
        zb = zb_new
    return zb


def _chol_solve(G, b, lam_l2: float):
    P = G.shape[0]
    pen = _pen_mask(P, G.device) * lam_l2
    A = G + torch.diag(pen) + 1e-6 * torch.eye(P, device=G.device)
    return torch.cholesky_solve(b[:, None], torch.linalg.cholesky(A))[:, 0]


def _cd_solve(G, b, beta0, lam_l1: float, lam_l2: float,
              n_sweeps: int = 50):
    """Cyclic coordinate descent on ½βᵀGβ - bᵀβ + λ₁|β|₁ + ½λ₂|β|²
    (glmnet's covariance updates), intercept unpenalized."""
    P = G.shape[0]
    pen = _pen_mask(P, G.device)
    diag = torch.diagonal(G)
    beta = beta0.clone()
    for _ in range(n_sweeps):
        for j in range(P):
            gj = b[j] - G[j] @ beta + diag[j] * beta[j]
            beta[j] = _soft(gj, lam_l1 * pen[j]) / \
                (diag[j] + lam_l2 * pen[j] + 1e-10)
    return beta


def _solve_gram(G, b, beta0, lam_l1: float, lam_l2: float, solver: str):
    """The solver policy of every IRLS loop: coordinate descent when
    asked, ADMM when L1 is active, else the Cholesky solve."""
    if solver == "COORDINATE_DESCENT":
        return _cd_solve(G, b, beta0, lam_l1, lam_l2)
    if lam_l1 > 0:
        return _admm_solve(G, b, lam_l1, lam_l2)
    return _chol_solve(G, b, lam_l2)


# -- L-BFGS ------------------------------------------------------------------

def _value_grad(obj, x):
    """(obj(x) as a float, ∇obj(x)) by ``torch.autograd``. On a row
    group ``obj`` is this rank's share of the objective (its rows'
    term plus its 1/n of the penalty) and the value and gradient are
    all-reduced together (the JAX package's ``psum`` of them)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        v = obj(x)
        (g,) = torch.autograd.grad(v, x)
    v, g = v.detach(), g.detach()
    if n_row_shards() > 1:
        vg = mrtask.allreduce(torch.cat([v.reshape(1).to(g.dtype), g]),
                              "sum", site="lbfgs")
        v, g = vg[0], vg[1:]
    return float(v), g


def _cubicmin(a, fa, ga, b, fb, c, fc):
    """The critical point of the cubic through (a, fa) with slope ga at
    a, (b, fb) and (c, fc); None where there is none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    if denom == 0:
        return None
    rb, rc = fb - fa - ga * db, fc - fa - ga * dc
    A = (dc ** 2 * rb - db ** 2 * rc) / denom
    B = (-dc ** 3 * rb + db ** 3 * rc) / denom
    radical = B * B - 3.0 * A * ga
    if A == 0 or radical < 0:
        return None
    return a + (-B + sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, ga, b, fb):
    """The critical point of the quadratic through (a, fa) with slope ga
    at a and (b, fb); None where there is none."""
    db = b - a
    B = (fb - fa - ga * db) / (db * db) if db else 0.0
    return None if B == 0 else a - ga / (2.0 * B)


def _wolfe_step(obj, x, f0: float, g0, d):
    """A step along ``d`` meeting the strong Wolfe conditions (c1 =
    1e-4, c2 = 0.9), as optax's default zoom line search takes it:
    doubling from a unit step until an interval is bracketed, then
    zooming by cubic, else quadratic, else bisection steps, with
    Hager and Zhang's approximate decrease accepted near the minimum;
    at most ``_LINESEARCH_STEPS`` evaluations each way. Returns (x, f,
    g) of the step taken: the lowest point seen when no step meets the
    conditions, the start when none decreases."""
    gd0 = float(g0 @ d)
    best = (x, f0, g0)

    def phi(a):
        nonlocal best
        xa = x + a * d
        fa, ga = _value_grad(obj, xa)
        if fa < best[1]:
            best = (xa, fa, ga)
        return fa, float(ga @ d), (xa, fa, ga)

    def decrease_fails(a, fa, gda):
        # Armijo, or near the minimum (fa within _APPROX_DEC_RTOL of f0)
        # Hager and Zhang's approximate decrease on the slope, which
        # float32 values there still resolve
        armijo = fa - f0 - _WOLFE_C1 * a * gd0
        approx = max(gda - (2 * _WOLFE_C1 - 1) * gd0,
                     fa - f0 - _APPROX_DEC_RTOL * abs(f0))
        return min(armijo, approx) > 0

    def zoom(lo, flo, glo, hi, fhi, ref, fref):
        for _ in range(_LINESEARCH_STEPS):
            left, right = min(lo, hi), max(lo, hi)
            delta = right - left
            a = _cubicmin(lo, flo, glo, hi, fhi, ref, fref)
            if a is None or not left + 0.2 * delta < a < right - 0.2 * delta:
                a = _quadmin(lo, flo, glo, hi, fhi)
                if a is None or not (left + 0.1 * delta < a
                                     < right - 0.1 * delta):
                    a = 0.5 * (lo + hi)
            fa, gda, pt = phi(a)
            if not decrease_fails(a, fa, gda) and \
                    abs(gda) <= -_WOLFE_C2 * gd0:
                return pt
            if decrease_fails(a, fa, gda) or fa >= flo:
                ref, fref = hi, fhi
                hi, fhi = a, fa
            else:
                if gda * (hi - lo) >= 0:
                    ref, fref = hi, fhi
                    hi, fhi = lo, flo
                else:
                    ref, fref = lo, flo
                lo, flo, glo = a, fa, gda
        return best

    a_prev, f_prev, g_prev = 0.0, f0, gd0
    a = 1.0
    for i in range(_LINESEARCH_STEPS):
        fa, gda, pt = phi(a)
        if decrease_fails(a, fa, gda) or (i > 0 and fa >= f_prev):
            return zoom(a_prev, f_prev, g_prev, a, fa, a_prev, f_prev)
        if abs(gda) <= -_WOLFE_C2 * gd0:
            return pt
        if gda >= 0:
            return zoom(a, fa, gda, a_prev, f_prev, a, fa)
        a_prev, f_prev, g_prev = a, fa, gda
        a *= 2.0
    return best


def _lbfgs(obj, x0, max_iterations: int, objective_epsilon: float,
           record=None):
    """Minimize ``obj`` (a function of a flat tensor) from ``x0`` by
    L-BFGS (memory ``_LBFGS_MEMORY``, two-loop recursion, a strong-Wolfe
    line search), one step per iteration. As in the reference's loop,
    each iteration takes the objective at its start, steps, and then
    stops when that objective moved less than ``objective_epsilon``
    relative from the previous iteration's. ``record(it, v)`` sees the
    objective at the start of each iteration. Returns (x,
    iterations)."""
    x = x0.detach().clone()
    f, g = _value_grad(obj, x)
    mem: list[tuple] = []
    prev, it = float("inf"), 0
    for it in range(1, max_iterations + 1):
        v = f
        if record is not None:
            record(it, v)
        # two-loop recursion: d = -H g
        q, alphas = g.clone(), []
        for s, yv, rho in reversed(mem):
            a = rho * float(s @ q)
            alphas.append(a)
            q = q - a * yv
        if mem:
            s, yv, _ = mem[-1]
            q = q * (float(s @ yv) / float(yv @ yv))
        else:
            q = q / max(float(torch.linalg.vector_norm(q)), 1.0)
        for (s, yv, rho), a in zip(mem, reversed(alphas)):
            q = q + (a - rho * float(yv @ q)) * s
        d = -q
        if float(g @ d) >= 0:            # not a descent direction
            mem.clear()
            d = -g / max(float(torch.linalg.vector_norm(g)), 1.0)
        x_new, f_new, g_new = _wolfe_step(obj, x, f, g, d)
        s, yv = x_new - x, g_new - g
        sy = float(s @ yv)
        if sy > 1e-10:
            mem.append((s, yv, 1.0 / sy))
            del mem[:-_LBFGS_MEMORY]
        x, f, g = x_new, f_new, g_new
        if abs(prev - v) < objective_epsilon * (abs(prev) + 1e-10):
            break
        prev = v
    return x, it


# -- model -------------------------------------------------------------------

class GLMModel(Model):
    """A trained GLM: coefficients on the standardized scale (``beta``,
    [P] or [P, K] for multinomial) and the design layout."""

    algo = "glm"
    _score_state = "_glm_state"
    _serving_rows = True

    def __init__(self, data: TrainData, params: GLMParams, dinfo: DataInfo,
                 beta: torch.Tensor, lambda_used: float,
                 null_deviance: float, residual_deviance: float,
                 n_iterations: int):
        self.feature_names = list(data.feature_names)
        self.feature_domains = dict(data.feature_domains)
        self.nclasses = data.nclasses
        self.response_domain = data.response_domain
        self.distribution = data.distribution
        self.offset_column: str | None = None
        self.params = params
        self.dinfo = dinfo
        self.beta = beta
        self.device = beta.device
        self.lambda_used = lambda_used
        self.null_deviance = null_deviance
        self.residual_deviance = residual_deviance
        self.n_iterations = n_iterations
        self.scoring_history: list[dict] = []
        self.validation_metrics: dict | None = None

    def coef(self) -> dict:
        """De-standardized coefficients in original units; multinomial:
        {class label: {name: value}}."""
        b = self.beta.detach().cpu().double().numpy()
        if b.ndim == 2:
            doms = self.response_domain or [str(k)
                                            for k in range(b.shape[1])]
            return {lbl: self._coef_of(b[:, k]) for k, lbl in
                    enumerate(doms)}
        return self._coef_of(b)

    def _coef_of(self, b: np.ndarray) -> dict:
        names = self.dinfo.coef_names
        out = dict(zip(names, b))
        icpt = out["Intercept"]
        for j in range(len(self.dinfo.numeric_idx)):
            out[names[j]] = b[j] / self.dinfo.stds[j]
            icpt -= b[j] * self.dinfo.means[j] / self.dinfo.stds[j]
        out["Intercept"] = icpt
        return out

    def coef_norm(self) -> dict[str, float]:
        """Coefficients on the standardized scale (as solved)."""
        return dict(zip(self.dinfo.coef_names,
                        self.beta.detach().cpu().double().numpy()))

    def _serving_prepare(self):
        """(β, means, stds) on the model's device, built once."""
        st = self.__dict__.get("_glm_state")
        if st is None:
            dev = self.device
            st = (self.beta.detach(),
                  torch.as_tensor(self.dinfo.means, device=dev),
                  torch.as_tensor(self.dinfo.stds, device=dev))
            self._glm_state = st
        return st

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        beta, means, stds = self._serving_prepare()
        d = self.dinfo
        Xe = expand(X, means, stds, tuple(d.numeric_idx),
                    tuple(tuple(s) for s in d.enum_specs), d.drop_first)
        eta = Xe @ beta
        if offset is not None:
            eta = eta + offset
        if self.params.family == "multinomial":
            return torch.softmax(eta, dim=1)
        mu = _linkinv(_famspec(self.params), eta)
        if self.params.family == "binomial":
            return torch.stack([1 - mu, mu], dim=1)
        return mu

    @property
    def _artifact_meta(self) -> dict:
        """The MOJO-v2 meta of this model (the JAX package's GLM
        fields)."""
        d = self.dinfo
        return {"algo": "glm", "feature_names": self.feature_names,
                "feature_domains": self.feature_domains,
                "nclasses": self.nclasses,
                "response_domain": self.response_domain,
                "distribution": self.distribution,
                "offset_column": self.offset_column,
                "family": self.params.family,
                "link": _famspec(self.params).link,
                "numeric_idx": [int(i) for i in d.numeric_idx],
                "enum_specs": [[int(i), int(L), bool(na), int(m)]
                               for i, L, na, m in d.enum_specs],
                "drop_first": bool(d.drop_first)}

    @property
    def _artifact_arrays(self) -> dict:
        return {"beta": self.beta.detach().cpu().numpy(),
                "means": np.asarray(self.dinfo.means),
                "stds": np.asarray(self.dinfo.stds)}

    # -- inference statistics (compute_p_values) ----------------------------

    def _fit_inference(self, Xe, data: TrainData, fam: FamSpec) -> None:
        """Std errors, z and p values from the inverse Fisher
        information (XᵀWX)⁻¹·φ at the fitted β, in float64 on the host,
        de-standardized through the same affine map as ``coef``."""
        eta = Xe @ self.beta
        if data.offset is not None:
            eta = eta + data.offset
        mu = _linkinv(fam, eta)
        wk, _ = _irls_weights(fam, eta, mu, data.y)
        G, _ = _gram_task(Xe, wk, torch.zeros_like(eta), data.w)
        n = float(mrtask.allreduce(torch.sum(data.w), "sum"))
        Pn = G.shape[0]
        if fam.family in ("gaussian", "gamma", "tweedie"):
            # the dispersion's moment estimate (Pearson X²/(n - P))
            V = _variance_fn(fam, mu)
            pearson = float(mrtask.allreduce(torch.sum(
                data.w * (data.y - mu) ** 2 / torch.clamp(V, min=1e-10)),
                "sum"))
            phi = pearson / max(n - Pn, 1.0)
        else:
            phi = 1.0
        cov = np.linalg.inv(G.cpu().double().numpy()
                            + 1e-10 * np.eye(Pn)) * phi
        A = np.eye(Pn)
        for j in range(len(self.dinfo.numeric_idx)):
            A[j, j] = 1.0 / self.dinfo.stds[j]
            A[Pn - 1, j] = -self.dinfo.means[j] / self.dinfo.stds[j]
        se = np.sqrt(np.clip(np.diag(A @ cov @ A.T), 0, None))
        names = self.dinfo.coef_names
        coefs = self.coef()
        b = np.array([coefs[nm] for nm in names])
        with np.errstate(invalid="ignore", divide="ignore"):
            z = b / se
        # the normal two-sided tail
        pv = np.array([erfc(abs(zz) / np.sqrt(2.0)) if zz == zz else
                       np.nan for zz in z])
        self._std_errs = dict(zip(names, se))
        self._z_values = dict(zip(names, z))
        self._p_values = dict(zip(names, pv))

    def std_errs(self) -> dict[str, float]:
        return self._require_inference("_std_errs")

    def zvalues(self) -> dict[str, float]:
        return self._require_inference("_z_values")

    def pvalues(self) -> dict[str, float]:
        return self._require_inference("_p_values")

    def _require_inference(self, attr):
        if not hasattr(self, attr):
            raise ValueError(
                "train with compute_p_values=True to get inference stats")
        return getattr(self, attr)


class GLM:
    """H2OGeneralizedLinearEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        self.cv_args = CVArgs.pop(kw)
        self.params = GLMParams(**kw)

    def _fit_beta(self, Xe, data: TrainData, lam: float, beta0,
                  history=None):
        """IRLS from ``beta0`` at penalty ``lam`` -> (β, deviance,
        iterations); ``history`` collects {iteration, lambda,
        deviance} per iteration."""
        p = self.params
        fam = _famspec(p)
        lam_l1, lam_l2 = lam * p.alpha, lam * (1 - p.alpha)
        n_obs = mrtask.allreduce(torch.sum(data.w), "sum")
        off = _offset(data)
        beta = beta0
        dev0, eta = _eta_dev_task(Xe, beta, data.y, data.w, off, fam)
        dev_prev = float(dev0)
        it = 0
        for it in range(1, p.max_iterations + 1):
            mu = _linkinv(fam, eta)
            wk, z = _irls_weights(fam, eta, mu, data.y)
            # eta carries the fixed offset; the Gram solves for the
            # linear part, so the working response is z - offset
            G, b = _gram_task(Xe, wk, z - off, data.w)
            beta_new = _solve_gram(G / n_obs, b / n_obs, beta, lam_l1,
                                   lam_l2, p.solver)
            dev_new, eta = _eta_dev_task(Xe, beta_new, data.y, data.w, off,
                                         fam)
            dev = float(dev_new)
            db = float(torch.max(torch.abs(beta_new - beta)))
            beta = beta_new
            if history is not None:
                history.append({"iteration": len(history) + 1,
                                "lambda": lam, "deviance": dev})
            if fam.family == "gaussian" and fam.link == "identity" \
                    and lam_l1 == 0 and p.solver == "IRLSM":
                break                      # the exact one-shot solve
            if abs(dev_prev - dev) < p.objective_epsilon * \
                    (abs(dev_prev) + 1e-10) or db < p.beta_epsilon:
                dev_prev = dev
                break
            dev_prev = dev
        return beta, dev_prev, it

    def _validate(self, data: TrainData) -> None:
        p = self.params
        if p.family == "binomial" and data.nclasses != 2:
            raise ValueError("binomial family needs a 2-class response")
        if p.family == "multinomial" and data.nclasses < 2:
            raise ValueError(
                "multinomial family needs a categorical response")
        if p.family not in ("binomial", "multinomial") and data.nclasses > 1:
            raise ValueError(
                f"family='{p.family}' needs a numeric response; the "
                "response is categorical")
        if p.family in ("gamma", "tweedie", "poisson", "negativebinomial"):
            y = data.y if n_row_shards() == 1 else torch.where(
                data.w > 0, data.y, float("inf"))    # not a shard's pad
            ymin = float(mrtask.allreduce(torch.min(y), "min"))
            if p.family == "gamma" and ymin <= 0:
                raise ValueError("gamma family needs a strictly positive "
                                 "response")
            if ymin < 0:
                raise ValueError(f"{p.family} family needs a non-negative "
                                 "response")

    def train(self, y: str, training_frame, x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              weights_column: str | None = None,
              validation_frame=None,
              offset_column: str | None = None) -> GLMModel:
        """Train on ``training_frame``'s device; returns the model."""
        p = self.params
        if offset_column and p.family == "multinomial":
            # a per-row offset shared by every class is
            # softmax-invariant: it would train the same model
            raise ValueError(
                "offset_column is not supported for multinomial")
        if self.cv_args.enabled:
            single_process_only("cross-validation")
        if self.cv_args.fold_column:
            ignored_columns = list(ignored_columns or []) + \
                [self.cv_args.fold_column]
        if p.family not in _FAMILIES:
            raise ValueError(f"unknown family '{p.family}' (supported: "
                             f"{', '.join(_FAMILIES)})")
        if p.solver not in _SOLVERS:
            raise ValueError(f"unknown solver '{p.solver}' (supported: "
                             f"{', '.join(_SOLVERS)})")
        fam = _famspec(p)
        if p.family == "tweedie" and not 1.0 < p.tweedie_variance_power < 2.0:
            raise ValueError("tweedie_variance_power must be in (1, 2)")
        if p.compute_p_values:
            # the exact information matrix: IRLSM, no regularization
            if p.solver != "IRLSM":
                raise ValueError("compute_p_values requires solver='IRLSM'")
            if p.lambda_search or (p.lambda_ or 0.0) > 0:
                raise ValueError("compute_p_values requires lambda=0")
            if p.family == "multinomial":
                raise ValueError(
                    "compute_p_values is not supported for multinomial")
        if p.family == "multinomial" and p.lambda_search:
            raise ValueError(
                "lambda_search is not supported for multinomial; pass "
                "an explicit lambda_")
        data = resolve_xy(training_frame, y, x, ignored_columns,
                          weights_column,
                          _FAMILY_DIST.get(p.family, p.family),
                          offset_column)
        self._validate(data)
        dinfo = build_datainfo(data, training_frame, p.standardize,
                               drop_first=not p.use_all_factor_levels)
        Xe = dinfo.expand(design(training_frame, data.feature_names))
        if p.family == "multinomial":
            model = self._train_multinomial(data, dinfo, Xe)
        else:
            model = self._train_single(data, dinfo, Xe, fam)
            model.offset_column = offset_column
        from .cv import finalize_train

        return finalize_train(
            self, model, y, training_frame,
            {"x": x, "ignored_columns": ignored_columns,
             "weights_column": weights_column,
             "offset_column": offset_column},
            validation_frame)

    def _train_single(self, data: TrainData, dinfo: DataInfo, Xe,
                      fam: FamSpec) -> GLMModel:
        p = self.params
        Pn = dinfo.n_expanded
        dev = Xe.device
        n_obs = float(mrtask.allreduce(torch.sum(data.w), "sum"))
        off = _offset(data)
        # the null model: intercept = link(ȳ)
        ybar = float(mrtask.allreduce(torch.sum(data.y * data.w),
                                      "sum")) / n_obs
        if p.family == "binomial":
            ybar = min(max(ybar, 1e-7), 1 - 1e-7)
        elif fam.link in ("log", "inverse"):
            ybar = max(ybar, 1e-10)
        b0 = float(_linkfun(fam, torch.tensor(ybar, dtype=torch.float32)))
        if data.offset is not None:
            # with an offset link(ȳ) is not the intercept's MLE: fit the
            # intercept-only model through the same IRLS on a ones design
            ones = torch.ones((Xe.shape[0], 1), device=dev)
            b_null, _, _ = self._fit_beta(
                ones, data, 0.0, torch.tensor([b0], device=dev))
            b0 = float(b_null[0])
        beta_null = torch.zeros(Pn, device=dev)
        beta_null[Pn - 1] = b0
        null_dev = float(_eta_dev_task(Xe, beta_null, data.y, data.w, off,
                                       fam)[0])
        if p.lambda_search:
            # λ_max: the smallest λ zeroing every coefficient, from the
            # null model's gradient
            mu0 = _linkinv(fam, Xe @ beta_null + off)
            grad = torch.abs(mrtask.allreduce(
                Xe.T @ ((mu0 - data.y) * data.w), "sum")
                ).cpu().numpy() / n_obs
            lam_max = float(grad[:-1].max()) / max(p.alpha, 1e-3)
            lams = np.logspace(np.log10(lam_max),
                               np.log10(lam_max * p.lambda_min_ratio),
                               p.nlambdas)
        else:
            lams = [p.lambda_ if p.lambda_ is not None else 0.0]
        history: list[dict] = []
        if p.solver == "L_BFGS":
            beta, dev_, iters = self._fit_lbfgs(Xe, data, float(lams[-1]),
                                                beta_null, history)
        else:
            beta, dev_, iters = beta_null, null_dev, 0
            for lam in lams:               # the warm-started λ path
                beta, dev_, its = self._fit_beta(Xe, data, float(lam), beta,
                                                 history)
                iters += its
        model = GLMModel(data, p, dinfo, beta, float(lams[-1]), null_dev,
                         dev_, iters)
        model.scoring_history = history
        if p.compute_p_values:
            model._fit_inference(Xe, data, fam)
        return model

    def _fit_lbfgs(self, Xe, data: TrainData, lam: float, beta0,
                   history=None):
        p = self.params
        fam = _famspec(p)
        n_obs = mrtask.allreduce(torch.sum(data.w), "sum")
        lam_l1, lam_l2 = lam * p.alpha, lam * (1 - p.alpha)
        pen = _pen_mask(Xe.shape[1], Xe.device)
        off = _offset(data)
        share = 1.0 / n_row_shards()     # this rank's part of the penalty

        def obj(beta):
            dev = _eta_dev_task(Xe, beta, data.y, data.w, off, fam,
                                reduce=False)[0]
            return 0.5 * dev / n_obs + share * (0.5 * lam_l2 * torch.sum(
                (pen * beta) ** 2) + lam_l1 * torch.sum(torch.abs(pen * beta)))

        def record(it, v):
            if history is not None:
                history.append({"iteration": len(history) + 1,
                                "lambda": lam, "objective": v})

        beta, it = _lbfgs(obj, beta0, p.max_iterations, p.objective_epsilon,
                          record)
        dev = float(_eta_dev_task(Xe, beta, data.y, data.w, off, fam)[0])
        return beta, dev, it

    def _train_multinomial(self, data: TrainData, dinfo: DataInfo,
                           Xe) -> GLMModel:
        """Softmax regression, β [P, K]: IRLSM and COORDINATE_DESCENT
        cycle the classes with per-class Fisher scoring (the reference's
        block-diagonal approximation), L_BFGS runs on the whole matrix."""
        p = self.params
        K, Pn = data.nclasses, dinfo.n_expanded
        dev = Xe.device
        n_obs = mrtask.allreduce(torch.sum(data.w), "sum")
        pen = _pen_mask(Pn, dev)[:, None]
        lam = p.lambda_ if p.lambda_ is not None else 0.0
        lam_l1, lam_l2 = lam * p.alpha, lam * (1 - p.alpha)
        yc = data.y.long()
        history: list[dict] = []

        def dev_fn(B, reduce=True):
            logp = torch.log_softmax(Xe @ B, dim=1)
            ll = logp.gather(1, yc[:, None])[:, 0]
            d = -2.0 * torch.sum(data.w * ll)
            return mrtask.allreduce(d, "sum", site="deviance") \
                if reduce else d

        # the null model: the log class priors as intercepts
        pri = mrtask.allreduce(torch.zeros(K + 1, device=dev).index_add_(
            0, torch.where(data.w > 0, yc, K), data.w)[:K], "sum") / n_obs
        B = torch.zeros((Pn, K), device=dev)
        B[Pn - 1] = torch.log(torch.clamp(pri, min=1e-8))
        null_dev = float(dev_fn(B))
        if p.solver in ("IRLSM", "COORDINATE_DESCENT"):
            prev, it = null_dev, 0
            for it in range(1, p.max_iterations + 1):
                for k in range(K):
                    wk, z = _softmax_irls_task(Xe, B, data.y, k)
                    G, b = _gram_task(Xe, wk, z, data.w)
                    B[:, k] = _solve_gram(G / n_obs, b / n_obs, B[:, k],
                                          lam_l1, lam_l2, p.solver)
                v = float(dev_fn(B))
                history.append({"iteration": it, "lambda": lam,
                                "deviance": v})
                if abs(prev - v) < p.objective_epsilon * \
                        (abs(prev) + 1e-10):
                    prev = v
                    break
                prev = v
            dev_ = prev
        else:
            share = 1.0 / n_row_shards()

            def obj(flat):
                Bf = flat.reshape(Pn, K)
                return 0.5 * dev_fn(Bf, reduce=False) / n_obs + share * (
                    0.5 * lam_l2 * torch.sum((pen * Bf) ** 2)
                    + lam_l1 * torch.sum(torch.abs(pen * Bf)))

            def record(i, v):
                history.append({"iteration": i, "lambda": lam,
                                "objective": v})

            flat, it = _lbfgs(obj, B.reshape(-1), p.max_iterations,
                              p.objective_epsilon, record)
            B = flat.reshape(Pn, K)
            dev_ = float(dev_fn(B))
        model = GLMModel(data, p, dinfo, B, lam, null_dev, dev_, it)
        model.scoring_history = history
        return model


def _offset(data: TrainData) -> torch.Tensor:
    return data.offset if data.offset is not None else \
        torch.zeros_like(data.y)


def glm_model_from_arrays(beta, coef_names: list[str], numeric_idx,
                          enum_specs, means, stds, drop_first: bool,
                          feature_names: list[str], family: str,
                          link: str | None = None,
                          response_domain: list[str] | None = None,
                          feature_domains: dict | None = None,
                          nclasses: int | None = None,
                          offset_column: str | None = None,
                          device=None, **params) -> GLMModel:
    """A port ``GLMModel`` from another package's trained GLM, as numpy:
    ``beta`` ([P], or [P, K] for multinomial), the ``DataInfo`` arrays
    (``coef_names``, ``numeric_idx``, ``enum_specs``, ``means``,
    ``stds``, ``drop_first``), ``family`` and ``link``. ``params`` are
    GLMParams fields. The model scores and exports as the source model
    does."""
    from ..runtime.backend import resolve_device

    dev = resolve_device(device)
    b = torch.as_tensor(np.array(beta, dtype=np.float32), device=dev)
    dinfo = DataInfo(list(coef_names), [int(i) for i in numeric_idx],
                     [tuple(int(v) if j != 2 else bool(v)
                            for j, v in enumerate(s)) for s in enum_specs],
                     np.asarray(means, dtype=np.float32),
                     np.asarray(stds, dtype=np.float32),
                     len(coef_names), bool(drop_first))
    if nclasses is None:
        nclasses = b.shape[1] if b.dim() == 2 else (
            2 if family == "binomial" else 1)
    data = TrainData(list(feature_names), torch.zeros(0), torch.zeros(0), 0,
                     nclasses, response_domain,
                     _FAMILY_DIST.get(family, family),
                     dict(feature_domains or {}))
    gp = GLMParams(family=family, link=link, **params)
    model = GLMModel(data, gp, dinfo, b, 0.0, float("nan"), float("nan"),
                     0)
    model.offset_column = offset_column
    return model
