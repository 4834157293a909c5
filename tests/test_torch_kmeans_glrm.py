"""PyTorch port, KMeans and GLRM (``models/kmeans.py``,
``models/glrm.py``) against the JAX package's on the CPU.

The reference runs on a one-row-shard mesh with the port's column
statistics (``tests/torch_f64_rollups.py``), so both expand the same
standardized design; the frame (3,000 rows) has four normal columns
(NaNs in ``x1``), a Year-like column (mean 1997, sigma 6.3) and a
4-level categorical with NAs.

KMeans, held here (PlusPlus, Random and Furthest seeding, k = 5,
standardized and not): the expanded matrix BITWISE, the initial centres
BITWISE (the reference's host numpy on the same matrix); the final
centres and ``tot_withinss`` within 1e-5 relative, the same iteration
count, and the assignments of the training rows equal except where a
row's two nearest centres lie within float32 rounding: each such row
is certified in float64 (the two squared distances within 1e-5 of
‖x‖² + max‖c‖²), as the tree walker certifies near-ties; the cluster
sizes then differ by those rows only.

GLRM, held here (k = 2 and 3; no regularizer, l2, l1 and non-negative;
STANDARDIZE and DEMEAN; NaN cells masked out of the loss): U0 and V0
BITWISE (the threefry twin's ``normal`` through ``key`` and
``split``), the objective and the archetypes within 1e-4 relative (of
max|V|), the representation frame and ``reconstruct`` within 1e-4 of
their largest value; artifacts both ways within 1e-6 (KMeans: equal
cluster ids).
"""

import io

import jax
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models import GLRM as JGLRM
from h2o_kubernetes_tpu.models import KMeans as JKMeans
from h2o_kubernetes_tpu.models import kmeans as jkm
from h2o_kubernetes_tpu.models.base import resolve_x as jresolve_x
from h2o_kubernetes_tpu.models.datainfo import build_datainfo as jbuild
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import (GLRM, Frame, KMeans, MojoModel,
                                      export_mojo)
from h2o_kubernetes_tpu_torch.models import kmeans as tkm
from h2o_kubernetes_tpu_torch.models.base import resolve_x as tresolve_x
from h2o_kubernetes_tpu_torch.models.datainfo import (build_datainfo,
                                                      design)
from torch_f64_rollups import f64_rollups

_MESH1 = make_mesh(n_rows=1)
N = 3000
KM_CASES = [("PlusPlus", True), ("Random", True), ("Furthest", True),
            ("PlusPlus", False)]
GLRM_CASES = {
    "plain": dict(k=2),
    "l2": dict(k=3, regularization_x="l2", regularization_y="l2",
               gamma_x=0.1, gamma_y=0.1),
    "l1": dict(k=2, regularization_x="l1", gamma_x=0.05),
    "nonneg": dict(k=2, regularization_y="non_negative"),
    "demean": dict(k=2, transform="DEMEAN"),
}


def cols_of(rows, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": (rng.normal(size=rows) + (i % 2) * 2.0 *
                   (rng.uniform(size=rows) < 0.4)).astype(np.float32)
         for i in range(4)}
    X["x1"][::17] = np.nan
    X["yr"] = (1997.0 + 6.3 * rng.normal(size=rows)).astype(np.float32)
    X["c"] = np.array(list("abcd"), dtype=object)[rng.integers(0, 4, rows)]
    X["c"][::23] = None
    return X


@pytest.fixture(scope="module")
def trained():
    cols = cols_of(N)
    tf = Frame.from_arrays(cols, device="cpu")
    km, gl = {}, {}
    with use_mesh(_MESH1), f64_rollups():
        jf = h2o.Frame.from_arrays(cols)
        for init, std in KM_CASES:
            kw = dict(k=5, init=init, standardize=std, seed=3)
            km[(init, std)] = (JKMeans(**kw).train(training_frame=jf),
                               KMeans(**kw).train(training_frame=tf))
        for name, kw in GLRM_CASES.items():
            ign = ["yr"] if kw.get("transform") == "DEMEAN" else []
            gl[name] = (JGLRM(seed=5, **kw).train(training_frame=jf,
                                                  ignored_columns=ign),
                        GLRM(seed=5, **kw).train(training_frame=tf,
                                                 ignored_columns=ign))
        # the reference's expanded matrix and seeding inputs
        jd = jresolve_x(jf)
        ji = jbuild(jd, jf, True, drop_first=False)
        jXe = np.asarray(ji.expand(jd.X))[:, :-1]
        jw = np.asarray(jd.w)
        jassign = {key: np.asarray(m.predict_raw(jf))[:N]
                   for key, (m, _) in km.items()}
    return km, gl, cols, tf, jXe, jw, jassign


def _port_xe(tf, standardize=True):
    td = tresolve_x(tf)
    ti = build_datainfo(td, tf, standardize, drop_first=False)
    return ti.expand(design(tf, td.feature_names))[:, :-1].numpy()


def test_expanded_matrix_bitwise(trained):
    jXe, jw = trained[4], trained[5]
    assert _port_xe(trained[3]).tobytes() == jXe[jw > 0].tobytes()


@pytest.mark.parametrize("init", ["PlusPlus", "Random", "Furthest"])
def test_initial_centers_bitwise(trained, init):
    jXe, jw = trained[4], trained[5]
    p = tkm.KMeansParams(k=5, init=init, seed=3)
    got = tkm.initial_centers(_port_xe(trained[3]), np.ones(N), p)
    rng = np.random.default_rng(3)
    want = {"PlusPlus": lambda: jkm._plusplus_init(jXe, jw, 5, rng),
            "Random": lambda: jXe[rng.choice(np.flatnonzero(jw > 0),
                                             size=5, replace=False)],
            "Furthest": lambda: jkm._furthest_init(jXe, jw, 5, rng)}[init]()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", KM_CASES,
                         ids=[f"{i}-{s}" for i, s in KM_CASES])
def test_kmeans_train(trained, case):
    (jm, tm), jassign = trained[0][case], trained[6][case]
    assert tm.iterations == jm.iterations
    jc = np.asarray(jm.centers_std, np.float64)
    tc = tm.centers_std.numpy().astype(np.float64)
    assert np.abs(tc - jc).max() <= 1e-5 * np.abs(jc).max()
    assert abs(tm.tot_withinss - jm.tot_withinss) <= \
        1e-5 * jm.tot_withinss
    np.testing.assert_allclose(tm.centers(), jm.centers(), rtol=1e-5,
                               atol=1e-5)
    ta = tm.predict_raw(trained[3]).astype(np.int64)
    ja = jassign.astype(np.int64)
    diff = np.flatnonzero(ta != ja)
    assert len(diff) <= 0.001 * N, len(diff)
    if len(diff):
        X = _port_xe(trained[3], case[1])[diff].astype(np.float64)
        d_t = ((X - tc[ta[diff]]) ** 2).sum(1)
        d_j = ((X - tc[ja[diff]]) ** 2).sum(1)
        scale = (X * X).sum(1) + (tc * tc).sum(1).max()
        assert np.all(np.abs(d_t - d_j) <= 1e-5 * scale)
    sizes = np.bincount(ta, minlength=5) - np.bincount(ja, minlength=5)
    assert np.abs(sizes).sum() <= 2 * len(diff)
    np.testing.assert_allclose(tm.size, np.asarray(jm.size), rtol=0,
                               atol=2 * len(diff))


@pytest.mark.parametrize("name", list(GLRM_CASES))
def test_glrm_initial_factors_bitwise(trained, name):
    jm, tm = trained[1][name]
    n, d, k = N, tm.V.shape[0], tm.V.shape[1]
    U0, V0 = GLRM.initial_factors(n, d, k, 5)
    k1, k2 = jax.random.split(jax.random.key(5))
    n_pad = np.asarray(jm.U).shape[0]
    jU0 = np.asarray(jax.random.normal(k1, (n_pad, k)) * 0.1)[:n]
    jV0 = np.asarray(jax.random.normal(k2, (d, k)) * 0.1)
    assert U0.numpy().tobytes() == jU0.tobytes()
    assert V0.numpy().tobytes() == jV0.tobytes()


@pytest.mark.parametrize("name", list(GLRM_CASES))
def test_glrm_train(trained, name):
    jm, tm = trained[1][name]
    cols = trained[2]
    assert abs(tm.objective - jm.objective) <= 1e-4 * abs(jm.objective)
    ja = jm.archetypes()
    assert np.abs(tm.archetypes() - ja).max() <= 1e-4 * np.abs(ja).max()
    jx = np.asarray(jm.x_frame().to_matrix())[:N]
    tx = tm.x_frame().to_matrix().numpy()
    assert np.abs(tx - jx).max() <= 1e-4 * np.abs(jx).max()
    ign = ["yr"] if GLRM_CASES[name].get("transform") == "DEMEAN" else []
    fr = {k: v for k, v in cols.items() if k not in ign}
    with use_mesh(_MESH1):
        jr = jm.reconstruct(h2o.Frame.from_arrays(fr))
    tr = tm.reconstruct(Frame.from_arrays(fr, device="cpu"))
    assert tr.names == jr.names
    a, b = tr.to_matrix().numpy(), np.asarray(jr.to_matrix())[:N]
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_glrm_errors(trained):
    tf = trained[3]
    with pytest.raises(ValueError, match="only loss='quadratic'"):
        GLRM(loss="huber").train(training_frame=tf)
    with pytest.raises(ValueError, match="exceeds min"):
        GLRM(k=50).train(training_frame=tf)
    with pytest.raises(ValueError, match="k must be >= 1"):
        KMeans(k=0).train(training_frame=tf)


@pytest.mark.parametrize("which", ["kmeans", "glrm"])
def test_artifacts_both_ways(trained, which):
    jm, tm = trained[0][("PlusPlus", True)] if which == "kmeans" else \
        trained[1]["plain"]
    cols = trained[2]
    hold = {k: v[:400] for k, v in cols.items()}
    tf = Frame.from_arrays(hold, device="cpu")
    jf = h2o.Frame.from_arrays(hold)
    want = tm.predict_raw(tf)
    buf = io.BytesIO()
    export_mojo(tm, buf)
    got = jmojo.MojoModel(io.BytesIO(buf.getvalue())).predict(jf)
    got2 = MojoModel(io.BytesIO(buf.getvalue())).predict(tf)
    buf2 = io.BytesIO()
    jmojo.export_mojo(jm, buf2)
    got3 = MojoModel(io.BytesIO(buf2.getvalue())).predict(tf)
    want3 = jmojo.MojoModel(io.BytesIO(buf2.getvalue())).predict(jf)
    if which == "kmeans":
        assert (got == want).all() and (got2 == want).all()
        assert (got3 == want3).all()
        return
    for g in (got, got2):
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got3, want3, rtol=0, atol=1e-6)
    rec = MojoModel(io.BytesIO(buf.getvalue())).reconstruct(tf)
    ref = tm.reconstruct(tf)
    for n in ref.names:
        np.testing.assert_allclose(rec[n], ref[n].to_numpy(), rtol=0,
                                   atol=1e-5)
    torch.testing.assert_close(torch.as_tensor(rec[ref.names[0]]),
                               torch.as_tensor(jmojo.MojoModel(
                                   io.BytesIO(buf.getvalue())).reconstruct(
                                   jf)[ref.names[0]]), rtol=0, atol=1e-6)
