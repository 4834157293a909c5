"""PyTorch port, the scorer-replica slice as a whole: one MOJO-v2
artifact exported by the JAX package is served by both packages, on
the CPU, and by the port's REST server.

Tolerances: margins are bitwise (same f32 addition order);
probabilities within 1e-6 absolute (the sigmoid/softmax of the two
frameworks may differ in the last ulp); contributions within atol=1e-6,
rtol=1e-5 (ordered f32 sums against XLA's scatter order); additivity
Σφ = logit(p1) within 1e-4.
"""

import base64
import io
import json
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.mojo import export_mojo
from h2o_kubernetes_tpu.operator.registry import load_artifact as jax_load
from h2o_kubernetes_tpu_torch import (FlatTreeScorer, load_artifact,
                                      start_server)
from h2o_kubernetes_tpu_torch.rest import stop_server
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.mojo import MOJO_FORMAT

ATOL, RTOL = 1e-6, 1e-5


def _frame(n=800, seed=5):
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
            for i in range(6)}
    cols["x1"][::13] = np.nan
    c = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)]
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    y = np.where(cols["x0"] - 0.7 * np.nan_to_num(cols["x1"])
                 + (c == "b") + rng.normal(scale=0.5, size=n) > 0,
                 "yes", "no")
    return h2o.Frame.from_arrays({**cols, "c": c, "w": w, "y": y})


@pytest.fixture(scope="module")
def served(mesh8):
    fr = _frame()
    m = GBM(ntrees=6, max_depth=4, nbins=64, seed=3).train(
        y="y", training_frame=fr, weights_column="w")
    buf = io.BytesIO()
    export_mojo(m, buf)
    X = np.asarray(m._design_matrix(fr))[: fr.nrows].copy()
    ecol = m.feature_names.index("c")
    X[::9, ecol] = -1.0                  # negative enum code = NA
    blob = buf.getvalue()
    return blob, X, jax_load(blob), load_artifact(blob, device="cpu")


def _logit(p):
    p = p.astype(np.float64)
    return np.log(p / (1.0 - p))


def test_margins_bitwise_probabilities_close(served):
    blob, X, jm, tm = served
    jft, jem = jm._serving_prepare()
    tft, tem, _ = tm._serving_prepare()
    want = np.asarray(jcore.flat_margin(jft, X, jem, jm.max_depth, 1))
    got = tcore.flat_margin(tft, torch.as_tensor(X), tem, tm.max_depth, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    pj, pt = jm.score_numpy(X), tm.score_numpy(X)
    assert pt.shape == pj.shape == (X.shape[0], 2)
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [200, 700], ids=["below_chunk", "chunked"])
def test_contributions_match_jax(served, monkeypatch, n):
    blob, X, jm, tm = served
    monkeypatch.setenv("H2O_TPU_CONTRIB_CHUNK", "256")
    assert n & (n - 1)                       # not a power of two
    if n == 700:
        assert tm._contrib_chunk() == 256 < n
    want = jm.contrib_numpy(X[:n])
    got = tm.contrib_numpy(X[:n])
    assert got.shape == want.shape == (n, X.shape[1] + 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    p1 = tm.score_numpy(X[:n])[:, 1]
    np.testing.assert_allclose(got.sum(axis=1), _logit(p1), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("kind", ["gaussian", "multinomial", "drf"])
def test_other_distributions_match_jax(kind):
    """Seeded artifacts the JAX package's scorer also loads:
    regression, K=3 multinomial, and DRF averaging (1/T scale)."""
    kw = {"gaussian": dict(nclasses=1, distribution="gaussian"),
          "multinomial": dict(nclasses=3, distribution="multinomial"),
          "drf": dict(nclasses=2, distribution="bernoulli",
                      drf_mode=True, leaf_scale=0.3)}[kind]
    blob = random_tree_artifact(21, n_features=5, ntrees=8, max_depth=4,
                                enum_features=(2,), **kw)
    X = random_rows(22, 300, 5, nan_frac=0.05, enum_features=(2,))
    jm, tm = jax_load(blob), load_artifact(blob, device="cpu")
    np.testing.assert_allclose(tm.score_numpy(X), jm.score_numpy(X),
                               atol=1e-6, rtol=0)
    if tm.contrib_support() is None:
        np.testing.assert_allclose(tm.contrib_numpy(X),
                                   jm.contrib_numpy(X), atol=ATOL,
                                   rtol=RTOL)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _dict_rows(tm, X):
    """JSON rows: enum codes as their level strings, NA as null."""
    rows = []
    for x in X:
        r = {}
        for j, name in enumerate(tm.feature_names):
            dom = tm.feature_domains.get(name)
            v = float(x[j])
            if np.isnan(v) or (dom is not None and v < 0):
                r[name] = None
            else:
                r[name] = dom[int(v)] if dom is not None else v
        rows.append(r)
    return rows


def _non_tree_artifact() -> bytes:
    buf = io.BytesIO()
    npz = io.BytesIO()
    np.savez_compressed(npz, beta=np.zeros(3, np.float32))
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("model.json", json.dumps({
            "format": MOJO_FORMAT, "algo": "glm", "feature_names": ["a"],
            "nclasses": 1}))
        z.writestr("arrays.npz", npz.getvalue())
    return buf.getvalue()


def _tampered(part: str) -> tuple[dict, dict]:
    """A seeded artifact's meta and arrays with one index pushed out of
    its table, as a corrupt or hostile upload would."""
    from h2o_kubernetes_tpu_torch.mojo import read_mojo_parts

    blob = random_tree_artifact(31, n_features=5, ntrees=3, max_depth=3)
    meta, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    arrays = {k: np.array(v) for k, v in arrays.items()}
    sf, lf = arrays["flat_split_feat"], arrays["flat_left"]
    if part == "split_feat":
        sf[0, 0] = 5                          # == F
    elif part == "left_past_end":
        lf[0, 0] = sf.shape[1] - 1            # right child == M
    elif part == "left_negative":
        lf[1, 0] = -3
    elif part == "enum_mask":
        arrays["enum_mask"] = np.zeros(4, dtype=bool)
    elif part == "shape":
        arrays["flat_value"] = arrays["flat_value"][:, :-1]
    return meta, arrays


def _pack(meta: dict, arrays: dict) -> bytes:
    buf, npz = io.BytesIO(), io.BytesIO()
    np.savez_compressed(npz, **arrays)
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("model.json", json.dumps(meta))
        z.writestr("arrays.npz", npz.getvalue())
    return buf.getvalue()


@pytest.mark.parametrize("part", ["split_feat", "left_past_end",
                                  "left_negative", "enum_mask", "shape"])
def test_out_of_range_artifact_rejected(part):
    meta, arrays = _tampered(part)
    with pytest.raises(ValueError):
        FlatTreeScorer(meta, arrays, device="cpu")
    with pytest.raises(ValueError):
        load_artifact(_pack(meta, arrays), device="cpu")


def test_rest_server_end_to_end(served, monkeypatch):
    blob, X, jm, tm = served
    srv = start_server(port=0, device="cpu")
    port = srv.server_address[1]
    try:
        assert _get(port, "/healthz") == 200
        assert _get(port, "/readyz") == 200
        code, r = _post(port, "/3/ModelRegistry/load", {
            "model_id": "gbm1", "warm_buckets": [256],
            "artifact_b64": base64.b64encode(blob).decode()})
        assert code == 200 and r["contributions"] is True, r
        assert r["warmed_buckets"] == [128, 256] and r["device"] == "cpu"
        Xr = X[:150]
        rows = _dict_rows(tm, Xr)
        code, pr = _post(port, "/3/Predictions/models/gbm1",
                         {"rows": rows})
        assert code == 200, pr
        want_p = tm.score_numpy(Xr)
        np.testing.assert_array_equal(np.asarray(pr["pyes"], np.float32),
                                      want_p[:, 1])
        np.testing.assert_allclose(np.asarray(pr["pyes"]),
                                   jm.score_numpy(Xr)[:, 1], atol=1e-6)
        code, cr = _post(port, "/3/Predictions/models/gbm1/contributions",
                         {"rows": rows})
        assert code == 200, cr
        assert cr["columns"] == tm.feature_names + ["BiasTerm"]
        phi = np.asarray(cr["contributions"], np.float32)
        np.testing.assert_array_equal(phi, tm.contrib_numpy(Xr))
        np.testing.assert_allclose(phi, jm.contrib_numpy(Xr), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(phi.sum(axis=1),
                                   _logit(np.asarray(pr["pyes"])),
                                   atol=1e-4, rtol=0)
        # error hygiene
        code, _ = _post(port, "/3/Predictions/models/nope", {"rows": rows})
        assert code == 404
        monkeypatch.setenv("H2O_TPU_SCORE_MAX_ROWS", "5")
        monkeypatch.setenv("H2O_TPU_CONTRIB_MAX_ROWS", "5")
        code, _ = _post(port, "/3/Predictions/models/gbm1",
                        {"rows": rows[:6]})
        assert code == 413
        code, _ = _post(port, "/3/Predictions/models/gbm1/contributions",
                        {"rows": rows[:6]})
        assert code == 413
        code, r = _post(port, "/3/ModelRegistry/load", {
            "model_id": "glm1",
            "artifact_b64": base64.b64encode(_non_tree_artifact()).decode()})
        assert code == 400 and "not servable" in r["msg"]
        code, _ = _post(port, "/3/ModelRegistry/load",
                        {"model_id": "x", "artifact_b64": "@@not base64"})
        assert code == 400
        code, r = _post(port, "/3/ModelRegistry/load", {
            "model_id": "bad", "artifact_b64": base64.b64encode(
                _pack(*_tampered("split_feat"))).decode()})
        assert code == 400 and "tampered" in r["msg"], r
        assert _post(port, "/3/Predictions/models/bad",
                     {"rows": rows})[0] == 404
        code, _ = _post(port, "/3/Predictions/models/gbm1",
                        {"rows": [{"x0": 1.0}]})
        assert code == 400
    finally:
        stop_server(srv)
