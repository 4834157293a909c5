"""The port's eight other learners at chip_smoke.py phase 28's shapes,
with no JAX: their frames, one train of each, the card against the CPU
at the parity tests' tolerances, and each artifact against ``predict``.

    from tools.torch_learners import frames, train, compare, artifact_gap

``chip_smoke.py`` phase 28, ``tools/torch_rehearse_phases.py --phases
learners`` and the card cases of ``tests/test_torch_train_device.py``
share it. The shapes (each learner's JAX defaults unless stated):

- KMeans: HIGGS-shaped rows × 28 (``tools/datasets.higgs_arrays``),
  k = 8, 10 iterations, PlusPlus, standardized;
- PCA: airlines rows (``airlines_arrays``), every predictor (Origin and
  Dest one-hot at 300 levels), k = 3, STANDARDIZE;
- GLRM: the HIGGS-shaped rows with 5% of the cells NaN (a seeded mask),
  k = 2, 100 iterations;
- NaiveBayes: the airlines rows, response IsDepDelayed;
- IsolationForest: the HIGGS-shaped rows, 50 trees, sample 256, depth 8;
- CoxPH (Efron): ``survival_arrays``, 10 normal covariates, Weibull
  event times (shape 1.5) on a grid of ``SURV_GRID`` (1e-5: at
  1,000,000 rows no time carries more than 32 events), about 30%
  censored;
- Aggregator: the HIGGS-shaped rows, 100 target exemplars;
- TargetEncoder: the airlines rows, Origin and Dest, ``k_fold`` on a
  5-fold column (row mod 5), blending on; its unit of work is the fit
  and ``transform(as_training=True)``.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o_kubernetes_tpu_torch import (GLRM, PCA, Aggregator, CoxPH, Frame,
                                      IsolationForest, KMeans, MojoModel,
                                      NaiveBayes, TargetEncoder,
                                      export_mojo)
from h2o_kubernetes_tpu_torch.models import kmeans as tkm
from h2o_kubernetes_tpu_torch.models.isolationforest import IsoTree
from tools.datasets import airlines_arrays, higgs_arrays

NAMES = ("kmeans", "pca", "glrm", "naivebayes", "isolationforest", "coxph",
         "aggregator", "targetencoder")
SURV_GRID = 1e-5
SURV_COVARIATES = 10
_NA_FRAC = 0.05
_AIR_Y = "IsDepDelayed"


def survival_arrays(rows: int, seed: int = 4) -> dict:
    """10 normal covariates, Weibull(1.5) event times scaled by the
    proportional-hazards risk exp(x·β), exponential censoring (~30%),
    times on a grid of ``SURV_GRID``; ``t`` the stop time, ``e`` 1 for an
    event."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, SURV_COVARIATES)).astype(np.float32)
    beta = np.linspace(-0.5, 0.5, SURV_COVARIATES)
    t = rng.weibull(1.5, rows) * np.exp(-(X @ beta) / 1.5)
    c = rng.exponential(2.2, rows)
    cols = {f"z{i}": X[:, i] for i in range(SURV_COVARIATES)}
    cols["t"] = (np.ceil(np.minimum(t, c) / SURV_GRID) * SURV_GRID
                 ).astype(np.float32)
    cols["e"] = (t <= c).astype(np.float32)
    return cols


def max_tied_events(cols: dict) -> int:
    """The most events any stop time carries."""
    return int(np.unique(cols["t"][cols["e"] > 0],
                         return_counts=True)[1].max())


def arrays(rows: int) -> dict[str, tuple[dict, dict]]:
    """The four tables as (columns, domains), numpy."""
    hc, hd = higgs_arrays(rows, seed=3)
    rng = np.random.default_rng(5)
    na = {k: np.where(rng.random(rows) < _NA_FRAC, np.float32(np.nan), v)
          .astype(np.float32) for k, v in hc.items() if k != "y"}
    ac, ad = airlines_arrays(rows, seed=0)
    ac = dict(ac, fold=(np.arange(rows) % 5).astype(np.float32))
    return {"higgs": (hc, hd), "higgs_na": (na, {}), "airlines": (ac, ad),
            "surv": (survival_arrays(rows), {})}


def head(tables: dict, rows: int) -> dict:
    """The first ``rows`` rows of every table."""
    return {k: ({n: v[:rows] for n, v in c.items()}, d)
            for k, (c, d) in tables.items()}


def frames(tables: dict, device) -> dict[str, Frame]:
    return {k: Frame.from_arrays(c, domains=d, device=device)
            for k, (c, d) in tables.items()}


def _spec(name: str):
    """(table, estimator, train kwargs)."""
    return {
        "kmeans": ("higgs", KMeans(k=8, max_iterations=10, init="PlusPlus",
                                   standardize=True, seed=1),
                   {"ignored_columns": ["y"]}),
        "pca": ("airlines", PCA(k=3, transform="STANDARDIZE"),
                {"ignored_columns": [_AIR_Y, "fold"]}),
        "glrm": ("higgs_na", GLRM(k=2, max_iterations=100, seed=1), {}),
        "naivebayes": ("airlines", NaiveBayes(),
                       {"y": _AIR_Y, "ignored_columns": ["fold"]}),
        "isolationforest": ("higgs", IsolationForest(
            ntrees=50, sample_size=256, max_depth=8, seed=1),
            {"ignored_columns": ["y"]}),
        "coxph": ("surv", CoxPH(stop_column="t", event_column="e",
                                ties="efron"), {}),
        "aggregator": ("higgs", Aggregator(target_num_exemplars=100),
                       {"ignored_columns": ["y"]}),
        "targetencoder": ("airlines", TargetEncoder(
            data_leakage_handling="k_fold", fold_column="fold",
            blending=True, seed=1), {"y": _AIR_Y, "x": ["Origin", "Dest"]}),
    }[name]


def table_of(name: str) -> str:
    return _spec(name)[0]


def train(name: str, fr: dict[str, Frame]):
    """One train of ``name`` on its frame (the target encoder's fit and
    its training transform) -> (model, the transform or None)."""
    table, est, kw = _spec(name)
    model = est.train(training_frame=fr[table], **kw)
    if name == "targetencoder":
        return model, model.transform(fr[table], as_training=True)
    return model, None


def units(name: str, model, rows: int) -> tuple[float, str]:
    """(the work one train did, its unit): rows, or CoxPH's Newton
    iterations."""
    if name == "coxph":
        return float(model.iterations), "Newton iterations"
    return float(rows), "rows"


def _rel(a, b, floor: float = 1.0) -> float:
    """max |a − b| / max(|b|, floor) over NaN-free cells (NaN positions
    must agree, else inf)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    ok = ~np.isnan(b)
    if not ok.any():
        return 0.0
    return float((np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]),
                                                     floor)).max())


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _same_bytes(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def compare(name: str, mc, mh, fc: dict[str, Frame],
            fh: dict[str, Frame], tc=None, th=None) -> dict:
    """The card model ``mc`` (on frames ``fc``) against the CPU model
    ``mh`` (on ``fh``): each gap beside its limit, and ``ok``."""
    table = table_of(name)
    gaps: dict[str, tuple[float, float]] = {}   # name -> (gap, limit)
    exact: dict[str, bool] = {}
    if name == "kmeans":
        Xc = mc._expand(mc._design_matrix(fc[table]))
        Xh = mh._expand(mh._design_matrix(fh[table]))
        exact["expanded matrix"] = _same_bytes(Xc, Xh)
        ones = np.ones(Xh.shape[0])
        exact["initial centres"] = _same_bytes(
            tkm.initial_centers(_np(Xc), ones, mc.params),
            tkm.initial_centers(_np(Xh), ones, mh.params))
        cc, ch = _np(mc.centers_std), _np(mh.centers_std)
        gaps["centres"] = (float(np.abs(cc - ch).max()
                                 / np.abs(ch).max()), 1e-5)
        gaps["tot_withinss"] = (abs(mc.tot_withinss - mh.tot_withinss)
                                / mh.tot_withinss, 1e-5)
        ac = mc.predict_raw(fc[table]).astype(np.int64)
        ah = mh.predict_raw(fh[table]).astype(np.int64)
        diff = np.flatnonzero(ac != ah)
        X = _np(Xh)[diff].astype(np.float64)
        c64 = ch.astype(np.float64)
        d_c = ((X - c64[ac[diff]]) ** 2).sum(1)
        d_h = ((X - c64[ah[diff]]) ** 2).sum(1)
        scale = (X * X).sum(1) + (c64 * c64).sum(1).max()
        gaps["assignments apart, uncertified"] = (
            float(np.sum(np.abs(d_c - d_h) > 1e-5 * scale)), 0.0)
        exact["iterations"] = mc.iterations == mh.iterations
        extra = {"rows_apart": int(len(diff))}
    elif name == "pca":
        gaps["eigenvalues"] = (_rel(_np(mc.eigenvalues),
                                    _np(mh.eigenvalues), 0.0), 1e-5)
        gaps["loadings"] = (float(np.abs(_np(mc.eigenvectors)
                                         - _np(mh.eigenvectors)).max()), 1e-4)
        extra = {"eigenvalues": _np(mh.eigenvalues).tolist()}
    elif name == "glrm":
        n, (d, k) = fh[table].nrows, tuple(mh.V.shape)
        u0c = GLRM.initial_factors(n, d, k, mc.params.seed, mc.device)
        u0h = GLRM.initial_factors(n, d, k, mh.params.seed, mh.device)
        exact["U0"] = _same_bytes(u0c[0], u0h[0])
        exact["V0"] = _same_bytes(u0c[1], u0h[1])
        gaps["objective"] = (abs(mc.objective - mh.objective)
                             / abs(mh.objective), 1e-4)
        V = _np(mh.V)
        gaps["archetypes"] = (float(np.abs(_np(mc.V) - V).max()
                                    / np.abs(V).max()), 1e-4)
        extra = {"objective": mh.objective}
    elif name == "naivebayes":
        for f in ("priors", "num_mean", "num_sd"):
            gaps[f] = (_rel(_np(getattr(mc, f)), _np(getattr(mh, f))), 1e-6)
        gaps["level tables"] = (max(_rel(_np(a), _np(b)) for a, b in
                                    zip(mc.enum_tables, mh.enum_tables)),
                                1e-6)
        gaps["probabilities"] = (float(np.abs(
            mc.predict_raw(fc[table]) - mh.predict_raw(fh[table])).max()),
            1e-6)
        extra = {}
    elif name == "isolationforest":
        for f in IsoTree._fields:
            exact[f"trees' {f}"] = _same_bytes(getattr(mc.trees, f),
                                               getattr(mh.trees, f))
        gaps["scores"] = (_rel(mc.predict_raw(fc[table]),
                               mh.predict_raw(fh[table])), 1e-6)
        extra = {}
    elif name == "coxph":
        bc, bh = _np(mc.beta), _np(mh.beta)
        gaps["coefficients"] = (float(np.abs(bc - bh).max()
                                      / np.abs(bh).max()), 1e-4)
        gaps["loglik"] = (abs(mc.loglik - mh.loglik) / abs(mh.loglik), 1e-5)
        exact["events"] = mc.n_events == mh.n_events
        extra = {"loglik": mh.loglik, "iterations": mh.iterations,
                 "max_tied_events": max_tied_events(
                     {k: fh[table].vec(k).to_numpy() for k in ("t", "e")})}
    elif name == "aggregator":
        exact["exemplar ids"] = np.array_equal(mc._ex_idx, mh._ex_idx)
        exact["member counts"] = np.array_equal(mc._counts, mh._counts)
        extra = {"exemplars": mh.num_exemplars()}
    else:
        gaps["tables"] = (max(
            _rel(mc.tables[c][f], mh.tables[c][f]) for c in mh.columns
            for f in ("sum", "cnt", "fold_sum", "fold_cnt")), 1e-12)
        exact["training transform"] = all(
            _same_bytes(tc[f"{c}_te"].to_numpy(), th[f"{c}_te"].to_numpy())
            for c in mh.columns)
        extra = {"prior": mh.prior}
    ok = all(exact.values()) and all(g <= lim for g, lim in gaps.values())
    return {"ok": ok, "exact": exact,
            "gaps": {k: {"gap": g, "limit": lim} for k, (g, lim) in
                     gaps.items()}, **extra}


def artifact_gap(name: str, model, fr: dict[str, Frame],
                 rows: int) -> float:
    """The model's ``predict`` (or scoring ``transform``) on the first
    ``rows`` rows of its frame against its artifact in ``MojoModel``
    (numpy): the largest gap, relative past 1."""
    import io

    sub = fr[table_of(name)].select_rows(np.arange(
        min(rows, fr[table_of(name)].nrows)))
    buf = io.BytesIO()
    export_mojo(model, buf)
    mm = MojoModel(io.BytesIO(buf.getvalue()))
    if name == "targetencoder":
        got, want = mm.transform(sub), model.transform(sub)
        return max(_rel(got[f"{c}_te"], want[f"{c}_te"].to_numpy())
                   for c in model.columns)
    return _rel(mm.predict(sub), model.predict_raw(sub))
