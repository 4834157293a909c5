"""PyTorch port, CoxPH (``models/coxph.py``) against the JAX package's on
the CPU.

A seeded survival frame (2,500 rows): three normal covariates, a
3-level categorical (one-hot, first level dropped) and a Year-like
column, Weibull event times on a grid of 0.02 (tie groups of up to 20
events, within the Efron cap of 32), about 25% censored, and a few
NA rows. The reference runs with the port's column statistics
(``tests/torch_f64_rollups.py``), as CoxPH centres its design through
``DataInfo``. Held here, for Efron and Breslow ties: the coefficients
within 1e-4 of the largest, the final and the null log-likelihood
within 1e-5 relative, the event count, the predictions (the log hazard)
within 1e-5 of their largest; the concordance index equal to 1e-6; the
Efron cap's error and the reference's other errors; artifacts both
ways within 1e-6. The port's risk-set sums are float64 where the
reference's are float32; at these sizes the gap is ~1e-7 relative.
"""

import io

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models import CoxPH as JCoxPH
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import CoxPH, Frame, MojoModel, export_mojo
from torch_f64_rollups import f64_rollups

_MESH1 = make_mesh(n_rows=1)
N = 2500
TIES = ("efron", "breslow")


def surv_cols(rows, seed=0, grid=0.02):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    X["g"] = np.array(list("abc"), dtype=object)[rng.integers(0, 3, rows)]
    X["yr"] = (1997.0 + 6.3 * rng.normal(size=rows)).astype(np.float32)
    lin = 0.5 * X["x0"] - 0.3 * X["x1"] + 0.4 * (X["g"] == "b") \
        + 0.05 * (X["yr"] - 1997.0)
    t = rng.weibull(1.5, rows) * np.exp(-lin / 1.5) * 3.0
    c = rng.exponential(8.0, rows)
    X["t"] = (np.ceil(np.minimum(t, c) / grid) * grid).astype(np.float32)
    X["e"] = (t <= c).astype(np.float32)
    X["x2"][::97] = np.nan                   # rows the train drops
    return X


@pytest.fixture(scope="module")
def trained():
    cols = surv_cols(N)
    tf = Frame.from_arrays(cols, device="cpu")
    out = {}
    with use_mesh(_MESH1), f64_rollups():
        jf = h2o.Frame.from_arrays(cols)
        for ties in TIES:
            kw = dict(stop_column="t", event_column="e", ties=ties)
            out[ties] = (JCoxPH(**kw).train(training_frame=jf),
                         CoxPH(**kw).train(training_frame=tf))
        jpred = {k: np.asarray(jm.predict_raw(jf))[:N]
                 for k, (jm, _) in out.items()}
        jconc = {k: jm.concordance(jf) for k, (jm, _) in out.items()}
    return out, cols, tf, jpred, jconc


def test_the_fixture_has_ties_within_the_cap(trained):
    cols = trained[1]
    ev = cols["t"][cols["e"] > 0]
    _, counts = np.unique(ev, return_counts=True)
    assert 5 <= counts.max() <= 32
    assert 0.2 <= 1 - cols["e"].mean() <= 0.45


@pytest.mark.parametrize("ties", TIES)
def test_coefficients_and_loglik(trained, ties):
    jm, tm = trained[0][ties]
    jc, tc = jm.coef(), tm.coef()
    assert list(tc) == list(jc)
    jb = np.array(list(jc.values()))
    tb = np.array(list(tc.values()))
    assert np.abs(tb - jb).max() <= 1e-4 * np.abs(jb).max()
    for a, b in ((tm.loglik, jm.loglik), (tm.loglik_null, jm.loglik_null)):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    assert tm.n_events == jm.n_events
    np.testing.assert_allclose(list(tm.hazard_ratios().values()),
                               list(jm.hazard_ratios().values()),
                               rtol=1e-4)


@pytest.mark.parametrize("ties", TIES)
def test_predictions_and_concordance(trained, ties):
    _, tm = trained[0][ties]
    tf, jpred, jconc = trained[2], trained[3][ties], trained[4][ties]
    tp = tm.predict_raw(tf)
    ok = ~np.isnan(jpred)
    assert (np.isnan(tp) == ~ok).all()
    scale = np.abs(jpred[ok]).max()
    assert np.abs(tp[ok] - jpred[ok]).max() <= 1e-5 * scale
    assert abs(tm.concordance(tf) - jconc) <= 1e-6


def test_errors_match_reference(trained):
    cols = dict(trained[1])
    wide = surv_cols(600, seed=3, grid=5.0)     # > 32 tied events
    for cls, mk in ((JCoxPH, h2o.Frame.from_arrays),
                    (CoxPH, lambda c: Frame.from_arrays(c, device="cpu"))):
        with pytest.raises(ValueError, match="needs stop_column"):
            cls().train(training_frame=mk(cols))
        with pytest.raises(ValueError, match="unknown ties"):
            cls(stop_column="t", event_column="e",
                ties="exact").train(training_frame=mk(cols))
        with pytest.raises(ValueError, match="exceed the Efron cap"):
            cls(stop_column="t", event_column="e").train(
                training_frame=mk(wide))
        none = dict(cols, e=np.zeros(N, np.float32))
        with pytest.raises(ValueError, match="no events"):
            cls(stop_column="t", event_column="e").train(
                training_frame=mk(none))


def test_artifacts_both_ways(trained):
    jm, tm = trained[0]["efron"]
    cols = trained[1]
    hold = {k: v[:400] for k, v in cols.items()}
    tf = Frame.from_arrays(hold, device="cpu")
    jf = h2o.Frame.from_arrays(hold)
    want = tm.predict_raw(tf)
    buf = io.BytesIO()
    export_mojo(tm, buf)
    for got in (jmojo.MojoModel(io.BytesIO(buf.getvalue())).predict(jf),
                MojoModel(io.BytesIO(buf.getvalue())).predict(tf)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    buf2 = io.BytesIO()
    jmojo.export_mojo(jm, buf2)
    np.testing.assert_allclose(
        MojoModel(io.BytesIO(buf2.getvalue())).predict(tf),
        jmojo.MojoModel(io.BytesIO(buf2.getvalue())).predict(jf), rtol=0,
        atol=1e-6)
