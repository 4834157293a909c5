"""PyTorch port, GLM and its design expansion: ``GLM(...).train`` in
both packages on the same seeded frame (numerics with NAs, an enum
with an NA level), on the CPU, and GLM artifacts both ways.

Both packages solve in float32 (the JAX package's Gram is summed over 8
row shards, the port's on one device), so coefficients agree to f32
rounding of well-conditioned systems. Held here:
- ``DataInfo``: the layout (names, numeric columns, enum specs) equal,
  the port's means and standard deviations equal to a numpy float64
  two-pass computation rounded once to float32 (``x3`` is Year-like,
  mean 1997 and sigma 6.3, where the reference's one float32 pass
  drifts), and, with the reference given the same statistics
  (``tests/torch_f64_rollups.py``, for every reference train of this
  file), its means and standard deviations and the expanded matrix
  BITWISE equal, with NAs and unseen levels, ``drop_first`` on and
  off;
- IRLSM for the seven families (gamma with its inverse and its log
  link): coefficients within 1e-4 of the largest, residual and null
  deviance within 1e-5 relative, the same iteration count;
  COORDINATE_DESCENT and ADMM (λ > 0): coefficients within 1e-4;
  ``lambda_search``: the λ path's last λ and coefficients within 1e-4;
  weights and an offset (poisson): within 1e-4;
- L_BFGS (binomial, multinomial; λ = 0) at the default
  ``objective_epsilon``: the objective within 1e-5 relative of the
  reference's optimum (its IRLSM train of the same objective; binomial:
  the better of that and its L_BFGS train's), and, binomial, the
  reference L_BFGS train's iteration count and coefficients within
  1e-3 (its multinomial L_BFGS, the same ``_lbfgs`` loop, is left out
  for the file's time); run on to ``objective_epsilon=1e-8``, the
  port's coefficients within 1e-3 of the IRLSM optimum (multinomial:
  the class contrasts, the identifiable part);
- ``compute_p_values``: standard errors, z and p values within 1e-4
  relative (p values below 1e-300 compared as 0);
- the validation errors of the reference, with its messages;
- a JAX model's coefficients carried across as numpy arrays score
  within 1e-6 of the JAX package's predictions; a port artifact
  predicts in the JAX package's ``MojoModel`` within 1e-6 of the port,
  and a JAX one in the port's ``MojoModel`` as in the JAX package's.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models import GLM as JGLM
from h2o_kubernetes_tpu.models import datainfo as jdi
from h2o_kubernetes_tpu.models.base import resolve_xy as jresolve
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import GLM, Frame, MojoModel, export_mojo
from h2o_kubernetes_tpu_torch.models import datainfo as tdi
from h2o_kubernetes_tpu_torch.models import glm as tglm
from h2o_kubernetes_tpu_torch.models.base import resolve_xy as tresolve
from torch_f64_rollups import f64_rollups, two_pass

_MESH1 = make_mesh(n_rows=1)
_RESP = ("yb", "yg", "yc", "yinv", "ypos", "ym", "w", "off")
# name: (family, response, GLM kwargs, train kwargs)
CASES = {
    "gaussian": ("gaussian", "yg", {}, {}),
    "binomial": ("binomial", "yb", {}, {}),
    "poisson": ("poisson", "yc", {}, {}),
    "gamma": ("gamma", "yinv", {}, {}),
    "gamma_log": ("gamma", "ypos", {"link": "log"}, {}),
    "tweedie": ("tweedie", "yc", {"tweedie_variance_power": 1.3}, {}),
    "negativebinomial": ("negativebinomial", "yc", {"theta": 0.5}, {}),
    "multinomial": ("multinomial", "ym", {}, {}),
    "cd": ("binomial", "yb", {"solver": "COORDINATE_DESCENT",
                              "lambda_": 0.01}, {}),
    "admm": ("gaussian", "yg", {"lambda_": 0.05, "alpha": 0.7}, {}),
    "lambda_search": ("binomial", "yb", {"lambda_search": True,
                                         "nlambdas": 5}, {}),
    "weights_offset": ("poisson", "yc", {}, {"weights_column": "w",
                                             "offset_column": "off"}),
    "p_values": ("gaussian", "yg", {"compute_p_values": True,
                                    "lambda_": 0.0}, {}),
}
# the port's L_BFGS trains, each held to the reference's L_BFGS train
# and to its optimum of the same objective (λ = 0: its IRLSM train
# converges to the same minimum)
_LBFGS = {"lbfgs": "binomial", "lbfgs_multinomial": "multinomial"}


def glm_cols(rows, seed=0):
    """Four normals (NaNs in x2), a 4-level enum with NAs, and a response
    per family: binary, gaussian, count, inverse-link gamma, log-link
    gamma, 3-class; weights in (0.5, 2) and a small offset."""
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(4)}
    X["x3"] = (1997.0 + 6.3 * X["x3"]).astype(np.float32)   # Year-like
    X["c1"] = np.array(list("abcd"), dtype=object)[
        rng.integers(0, 4, size=rows)]
    lin = 0.5 * X["x0"] - 0.3 * X["x1"] + 0.2 * (X["c1"] == "b")
    X["x2"][::13] = np.nan
    X["c1"][::29] = None
    X["yb"] = np.where(lin + rng.logistic(size=rows) > 0, "y", "n")
    X["yg"] = (lin + rng.normal(size=rows)).astype(np.float32)
    X["yc"] = rng.poisson(np.exp(lin)).astype(np.float32)
    mu_inv = 1.0 / (1.0 + 0.3 * np.tanh(lin))
    X["yinv"] = rng.gamma(2.0, mu_inv / 2.0).astype(np.float32)
    X["ypos"] = (np.exp(lin) * rng.gamma(2.0, 0.5, rows)).astype(np.float32)
    X["ym"] = np.array(list("pqr"))[np.digitize(
        lin + rng.normal(scale=0.5, size=rows), [-0.4, 0.4])]
    X["w"] = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    X["off"] = (0.1 * rng.normal(size=rows)).astype(np.float32)
    return X


def _args(name):
    fam, y, kw, tkw = CASES[name]
    used = {y} | set(tkw.values())
    return fam, y, kw, dict(tkw, ignored_columns=[c for c in _RESP
                                                  if c not in used])


@pytest.fixture(scope="module")
def trained():
    cols = glm_cols(1024)
    hold = glm_cols(300, seed=9)
    hold["c1"][5:9] = "zz"                      # a level unseen in training
    tf = Frame.from_arrays(cols, device="cpu")
    out = {}
    with use_mesh(_MESH1), f64_rollups():
        jf, jh = h2o.Frame.from_arrays(cols), h2o.Frame.from_arrays(hold)
        for name in CASES:
            fam, y, kw, tkw = _args(name)
            jm = JGLM(family=fam, **kw).train(y=y, training_frame=jf, **tkw)
            tm = GLM(family=fam, **kw).train(y=y, training_frame=tf, **tkw)
            out[name] = (jm, tm)
        # L_BFGS: (reference IRLSM, reference L_BFGS (binomial) or None,
        # port L_BFGS at the default objective_epsilon, port L_BFGS at
        # 1e-8)
        for name, ref_name in _LBFGS.items():
            fam, y, kw, tkw = _args(ref_name)
            jl = JGLM(family=fam, solver="L_BFGS", **kw).train(
                y=y, training_frame=jf, **tkw) if fam == "binomial" else None
            tl, tl8 = (GLM(family=fam, solver="L_BFGS", **kw, **eps).train(
                y=y, training_frame=tf, **tkw)
                for eps in ({}, {"objective_epsilon": 1e-8}))
            out[name] = (out[ref_name][0], jl, tl, tl8)
        # the reference's scores on the holdout (binomial; the others
        # through its numpy MojoModel, which compiles nothing)
        X = np.asarray(out["binomial"][0]._design_matrix(jh))[: jh.nrows]
        ref = {"binomial": np.asarray(out["binomial"][0].predict_raw(jh))}
    return out, cols, jf, tf, hold, X, ref


def _beta(m):
    return np.asarray(m.beta, np.float64) if not isinstance(
        m.beta, torch.Tensor) else m.beta.double().numpy()


@pytest.mark.parametrize("drop_first", [True, False])
def test_datainfo_layout_and_bitwise_expansion(trained, drop_first):
    with use_mesh(_MESH1), f64_rollups():
        _datainfo_case(trained, drop_first)


def test_reference_float32_rollups_drift_on_the_fixture(trained):
    """Without the patch the reference's one float32 pass parts from the
    float64 two-pass sigma of the Year-like column: the fixture shows
    the drift the like-for-like statistics remove."""
    cols = trained[1]
    jsig = h2o.Frame.from_arrays({"x3": cols["x3"]})["x3"].rollups()["sigma"]
    sig = two_pass(cols["x3"])[2]
    assert abs(jsig - sig) > 1e-5 * sig, (jsig, sig)
    tsig = Frame.from_arrays({"x3": cols["x3"]}, device="cpu")["x3"] \
        .rollups()["sigma"]
    assert np.float32(tsig) == np.float32(sig)


def _datainfo_case(trained, drop_first):
    _, cols, jf, tf, hold = trained[:5]
    jd = jresolve(jf, "yg", ignored=[c for c in _RESP if c != "yg"])
    td = tresolve(tf, "yg", ignored=[c for c in _RESP if c != "yg"])
    ji = jdi.build_datainfo(jd, jf, True, drop_first)
    ti = tdi.build_datainfo(td, tf, True, drop_first)
    assert ti.coef_names == ji.coef_names
    assert ti.numeric_idx == ji.numeric_idx
    assert [tuple(s) for s in ti.enum_specs] == \
        [tuple(s) for s in ji.enum_specs]
    assert (ti.n_expanded, ti.drop_first) == (ji.n_expanded, ji.drop_first)
    # the port's statistics: float64 two-pass, rounded once
    want = [two_pass(cols[td.feature_names[i]])[1:] for i in ti.numeric_idx]
    assert ti.means.tobytes() == np.float32([m for m, _ in want]).tobytes()
    assert ti.stds.tobytes() == np.float32([s for _, s in want]).tobytes()
    # the reference given the same statistics: equal, and the expansion
    # bitwise, on the training rows and on a holdout with an unseen
    # level and NAs
    assert np.asarray(ji.means).tobytes() == ti.means.tobytes()
    assert np.asarray(ji.stds).tobytes() == ti.stds.tobytes()
    for frame_cols in (cols, hold):
        X = np.stack([_codes(frame_cols[n]) if n == "c1" else
                      frame_cols[n] for n in jd.feature_names],
                     axis=1).astype(np.float32)
        want = np.asarray(ji.expand(jnp.asarray(X)))
        got = ti.expand(torch.as_tensor(X)).numpy()
        assert got.tobytes() == want.tobytes()
    # no NA level trained: NA and unseen levels take the modal level
    no_na = dict(cols, c1=np.where(cols["c1"] == None, "a",  # noqa: E711
                                   cols["c1"]))
    td2 = tresolve(Frame.from_arrays(no_na, device="cpu"), "yg",
                   ignored=[c for c in _RESP if c != "yg"])
    ti2 = tdi.build_datainfo(td2, Frame.from_arrays(no_na, device="cpu"),
                             True, drop_first)
    jd2 = jresolve(h2o.Frame.from_arrays(no_na), "yg",
                   ignored=[c for c in _RESP if c != "yg"])
    ji2 = jdi.build_datainfo(jd2, h2o.Frame.from_arrays(no_na), True,
                             drop_first)
    assert [tuple(s) for s in ti2.enum_specs] == \
        [tuple(s) for s in ji2.enum_specs]
    assert (ti2.means.tobytes(), ti2.stds.tobytes()) == \
        (np.asarray(ji2.means).tobytes(), np.asarray(ji2.stds).tobytes())
    X[:, jd.feature_names.index("c1")] = np.nan
    assert ti2.expand(torch.as_tensor(X)).numpy().tobytes() == \
        np.asarray(ji2.expand(jnp.asarray(X))).tobytes()


def _codes(col):
    """Training-domain codes of an enum column (None and unseen: NaN)."""
    lut = {d: i for i, d in enumerate("abcd")}
    return np.array([lut.get(v, np.nan) if v is not None else np.nan
                     for v in col], dtype=np.float32)


@pytest.mark.parametrize("name", [n for n in CASES if n not in _LBFGS])
def test_irls_solvers_match_the_reference(trained, name):
    jm, tm = trained[0][name]
    jb, tb = _beta(jm), _beta(tm)
    assert tb.shape == jb.shape
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4 * np.abs(jb).max())
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-5)
    assert tm.null_deviance == pytest.approx(jm.null_deviance, rel=1e-5)
    assert tm.n_iterations == jm.n_iterations
    assert tm.lambda_used == pytest.approx(jm.lambda_used, rel=1e-6)
    assert len(tm.scoring_history) == len(jm.scoring_history)
    assert tm.distribution == jm.distribution
    if name in ("cd", "admm", "lambda_search"):
        assert (np.abs(tb) < 1e-6).sum() == (np.abs(jb) < 1e-6).sum()
    if tm.nclasses < 3:
        jc, tc = jm.coef(), tm.coef()
        assert jc.keys() == tc.keys()
        for k in jc:
            assert tc[k] == pytest.approx(jc[k], abs=1e-4 * max(
                1.0, abs(jc[k])))


def _objective(b, dinfo, frame_cols, name):
    """The penalized half-deviance over the weight sum at coefficients
    ``b`` under the layout ``dinfo``, in float64 numpy (the quantity
    L_BFGS minimizes)."""
    fam, y, kw, _ = _args(name)
    tf = Frame.from_arrays(frame_cols, device="cpu")
    data = tresolve(tf, y, ignored=[c for c in _RESP if c != y])
    Xe = dinfo.expand(tglm.design(tf, data.feature_names)).double().numpy()
    eta = Xe @ b
    yv, w = data.y.double().numpy(), data.w.double().numpy()
    if fam == "multinomial":
        top = eta.max(1)
        lse = np.log(np.exp(eta - top[:, None]).sum(1)) + top
        dev = -2 * (w * (eta[np.arange(len(yv)), yv.astype(int)]
                         - lse)).sum()
    else:
        mu = np.clip(1 / (1 + np.exp(-eta)), 1e-7, 1 - 1e-7)
        dev = -2 * (w * (yv * np.log(mu) + (1 - yv) * np.log1p(-mu))).sum()
    lam = kw.get("lambda_", 0.0) or 0.0
    alpha = kw.get("alpha", 0.5)
    pen = b[:-1]
    return 0.5 * dev / w.sum() + 0.5 * lam * (1 - alpha) * (pen ** 2).sum() \
        + lam * alpha * np.abs(pen).sum()


@pytest.mark.parametrize("name", list(_LBFGS))
def test_lbfgs_reaches_the_reference_optimum(trained, name):
    (jm, jl, tm, tm8), cols = trained[0][name], trained[1]
    name = _LBFGS[name]

    def contrasts(m):                # softmax: the identifiable part
        b = _beta(m)
        return b - b.mean(1, keepdims=True) if b.ndim == 2 else b

    jb = contrasts(jm)
    if jl is not None:
        # the default stopping rule: where the reference's L_BFGS stops
        assert tm.n_iterations == jl.n_iterations
        np.testing.assert_allclose(contrasts(tm), contrasts(jl), rtol=0,
                                   atol=1e-3 * np.abs(jb).max())
        assert tm.residual_deviance == pytest.approx(jl.residual_deviance,
                                                     rel=1e-5)
    # the same objective at the optima (under the port's layout for all:
    # the layouts agree to 1e-6)
    want = min(_objective(_beta(m), tm.dinfo, cols, name)
               for m in (jm, jl) if m is not None)
    got = _objective(_beta(tm), tm.dinfo, cols, name)
    assert got == pytest.approx(want, rel=1e-5)
    assert tm.scoring_history[-1].keys() == {"iteration", "lambda",
                                             "objective"}
    assert len(tm.scoring_history) == tm.n_iterations
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-5)
    # run on, the port reaches the IRLSM optimum
    np.testing.assert_allclose(contrasts(tm8), jb, rtol=0,
                               atol=1e-3 * np.abs(jb).max())
    assert _objective(_beta(tm8), tm.dinfo, cols, name) == pytest.approx(
        want, rel=1e-5)


def test_p_values_match_the_reference(trained):
    jm, tm = trained[0]["p_values"]
    for fn in ("std_errs", "zvalues", "pvalues"):
        want, got = getattr(jm, fn)(), getattr(tm, fn)()
        assert want.keys() == got.keys()
        for k in want:
            w, g = want[k], got[k]
            if fn == "pvalues" and w < 1e-300:
                assert g < 1e-290, (k, w, g)
                continue
            assert g == pytest.approx(w, rel=1e-4, abs=1e-12), (fn, k, w, g)
    with pytest.raises(ValueError, match="compute_p_values=True"):
        trained[0]["gaussian"][1].pvalues()


_ERRORS = [
    ({"family": "nope"}, "yg", {}, "unknown family"),
    ({"solver": "SGD"}, "yg", {}, "unknown solver"),
    ({"family": "tweedie", "tweedie_variance_power": 2.5}, "yc", {},
     "tweedie_variance_power"),
    ({"compute_p_values": True, "solver": "L_BFGS"}, "yg", {},
     "requires solver='IRLSM'"),
    ({"compute_p_values": True, "lambda_": 0.1}, "yg", {},
     "requires lambda=0"),
    ({"family": "multinomial", "compute_p_values": True}, "ym", {},
     "not supported for multinomial"),
    ({"family": "multinomial", "lambda_search": True}, "ym", {},
     "lambda_search is not supported"),
    ({"family": "multinomial"}, "ym", {"offset_column": "off"},
     "offset_column is not supported"),
    ({"family": "binomial"}, "ym", {}, "2-class response"),
    ({"family": "binomial"}, "yg", {}, "categorical response"),
    ({"family": "multinomial"}, "yg", {}, "categorical response"),
    ({"family": "poisson"}, "yb", {}, "numeric response"),
    ({"family": "gamma"}, "yg", {}, "strictly positive"),
    ({"family": "poisson"}, "yg", {}, "non-negative"),
]


def test_validation_errors_match_the_reference(trained):
    _, cols, jf, tf = trained[:4]
    for kw, y, tkw, msg in _ERRORS:
        ign = [c for c in _RESP if c != y and c not in tkw.values()]
        for cls, fr in ((JGLM, jf), (GLM, tf)):
            with pytest.raises(ValueError, match=msg), use_mesh(_MESH1):
                cls(**kw).train(y=y, training_frame=fr, ignored_columns=ign,
                                **tkw)
    assert GLM(nfolds=3).cv_args.nfolds == 3   # item 11: ported


def _carry(jm):
    d = jm.dinfo
    return tglm.glm_model_from_arrays(
        np.asarray(jm.beta), d.coef_names, d.numeric_idx, d.enum_specs,
        np.asarray(d.means), np.asarray(d.stds), d.drop_first,
        jm.feature_names, jm.params.family, link=jm.params.link,
        response_domain=jm.response_domain,
        feature_domains=jm.feature_domains, device="cpu")


_CARRIED = ("binomial", "multinomial", "weights_offset")


@pytest.mark.parametrize("name", _CARRIED)
def test_carried_models_and_artifacts_both_ways(trained, name):
    (jm, tm), hold, X = trained[0][name], trained[4], trained[5]
    th = Frame.from_arrays(hold, device="cpu")
    off = hold["off"] if tm.offset_column else None
    data = {n: X[:, j] for j, n in enumerate(tm.feature_names)}
    if off is not None:
        data["off"] = off
    src = data if off is not None else X
    jbuf = io.BytesIO()
    jmojo.export_mojo(jm, jbuf)
    want = jmojo.MojoModel(io.BytesIO(jbuf.getvalue())).predict(src)
    if name in trained[6]:
        np.testing.assert_allclose(want, trained[6][name], rtol=1e-6,
                                   atol=1e-6)
    pm = _carry(jm)
    pm.offset_column = jm.offset_column
    np.testing.assert_allclose(pm.score_numpy(X, offset=off), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.predict_raw(th), want, rtol=1e-6,
                               atol=1e-6)
    buf = io.BytesIO()
    export_mojo(tm, buf)
    got = tm.score_numpy(X, offset=off)
    np.testing.assert_allclose(jmojo.MojoModel(io.BytesIO(
        buf.getvalue())).predict(src), got, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(MojoModel(io.BytesIO(buf.getvalue())
                                         ).predict(src), got,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        MojoModel(io.BytesIO(jbuf.getvalue())).predict(src), want,
        rtol=1e-12, atol=0)
    perf = tm.model_performance(th, CASES[name][1])
    assert all(np.isfinite(v) for v in perf.values())
