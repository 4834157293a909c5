"""PyTorch port, export and the registry loop, the threshold metrics and
the Frame prediction paths, on the CPU.

A binomial GBM trained by the JAX package (a one-row-shard mesh) is
carried across as numpy arrays, so both packages hold the same trees;
the port also trains its own binomial, poisson (with an offset) and
laplace models. Held here:
- an artifact the port exports loads in the JAX package's
  ``load_artifact`` with bitwise-equal ``flat_margin`` margins and
  scores in its numpy ``MojoModel`` within 1e-6; a JAX-exported
  artifact scores in the port's ``MojoModel`` as in the JAX package's
  (1e-12: both are float64 numpy);
- ``ModelRegistry`` publish -> fetch (digest-checked) -> push (a file
  root sends path + sha256, a ``mem://`` root the bytes) to the port's
  ``start_server(device="cpu")``: predictions over REST bitwise equal to
  the model's ``score_numpy``, contributions to its ``contrib_numpy``;
  a tampered sha256 gets 409, a missing path 404; a loaded replica model
  publishes again; the push retries a 503 and not a 400;
- ``save_model``/``load_model`` round trips bitwise; a file naming a
  non-data global is refused; the cloud schemes name their ROADMAP item;
- ``binomial_stats`` and binomial ``model_performance`` within 1e-6 of
  the JAX package's; a single-class holdout keeps the basic three; the
  AUC and the threshold table from one score histogram equal
  ``roc_auc`` and ``binomial_stats`` bitwise;
- ``predict_contributions(frame)`` within 1e-6 of the JAX package's and
  additive to the margin within 1e-5; ``predict_leaf_node_assignment``
  equal to the JAX package's in ``Path`` and ``Node_ID``.
"""

import io
import json
import pickle
import urllib.error

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import metrics as JM
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.operator import registry as jreg
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import (MOJO_FORMAT, GBM, Frame,
                                      ModelRegistry, MojoModel, export_mojo,
                                      load_artifact, load_model, persist,
                                      read_mojo_parts, save_model,
                                      start_server)
from h2o_kubernetes_tpu_torch import metrics as M
from h2o_kubernetes_tpu_torch.rest import stop_server
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from test_torch_distributions import carry, dist_cols, train_kw
from test_torch_gbm import bench_cols
from test_torch_serving import _dict_rows, _post

_KW = dict(ntrees=3, max_depth=3, learn_rate=0.2, seed=1)


@pytest.fixture(scope="module")
def models():
    cols = bench_cols(4096)
    hold = bench_cols(1000, seed=9)
    with use_mesh(make_mesh(n_rows=1)):
        jf, jh = h2o.Frame.from_arrays(cols), h2o.Frame.from_arrays(hold)
        jm = JGBM(**_KW).train(y="y", training_frame=jf)
        X = np.asarray(jm._design_matrix(jh))[: jh.nrows]
    th = Frame.from_arrays(hold, device="cpu")
    tm = GBM(**_KW).train(y="y", training_frame=Frame.from_arrays(
        cols, device="cpu"))
    dc = dist_cols(2048)
    dfr = Frame.from_arrays(dc, device="cpu")
    y, kw = train_kw("poisson", "weighted")
    pois = GBM(distribution="poisson", **_KW).train(y=y, training_frame=dfr,
                                                    **kw)
    y, kw = train_kw("laplace", "plain")
    lap = GBM(distribution="laplace", **_KW).train(y=y, training_frame=dfr,
                                                   **kw)
    dh = dist_cols(500, seed=7)
    return dict(jm=jm, pm=carry(jm), tm=tm, X=X, jh=jh, th=th, hold=hold,
                pois=pois, lap=lap, dh=dh)


def _blob(model) -> bytes:
    buf = io.BytesIO()
    export_mojo(model, buf)
    return buf.getvalue()


def _dmatrix(model, cols):
    return model._design_matrix(Frame.from_arrays(cols, device="cpu")
                                ).numpy()


@pytest.mark.parametrize("which", ["tm", "pois", "lap"])
def test_port_artifact_loads_in_jax(models, which):
    m = models[which]
    blob = _blob(m)
    cols = models["hold"] if which == "tm" else models["dh"]
    X = _dmatrix(m, cols)
    off = cols["off"] if m.offset_column else None
    js = jreg.load_artifact(blob)
    K = 1
    ft, em = js._serving_prepare()
    want = np.asarray(jcore.flat_margin(ft, jnp.asarray(X), em,
                                        m.params.max_depth, K))
    got = tcore.flat_margin(m._serving_prepare()[0], torch.as_tensor(X),
                            m._serving_prepare()[1], m.params.max_depth,
                            K).numpy()
    np.testing.assert_array_equal(got, want)
    jmm = jmojo.MojoModel(io.BytesIO(blob))
    data = {n: X[:, j] for j, n in enumerate(m.feature_names)}
    if off is not None:
        data["off"] = off
    want_p = jmm.predict(data if off is not None else X)
    got_p = m.score_numpy(X, offset=off)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-6)
    port_p = MojoModel(io.BytesIO(blob)).predict(
        data if off is not None else X)
    np.testing.assert_allclose(port_p, want_p, rtol=1e-12, atol=0)
    assert js.margin_scale == m.margin_scale


def test_jax_artifact_scores_in_port_mojo(models):
    buf = io.BytesIO()
    jmojo.export_mojo(models["jm"], buf)
    X = models["X"]
    want = jmojo.MojoModel(io.BytesIO(buf.getvalue())).predict(X)
    got = MojoModel(io.BytesIO(buf.getvalue())).predict(X)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    got_dict = MojoModel(io.BytesIO(buf.getvalue())).predict(
        {k: v for k, v in models["hold"].items() if k != "y"})
    np.testing.assert_allclose(got_dict, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        load_artifact(buf.getvalue(), device="cpu").score_numpy(X), want,
        rtol=0, atol=1e-6)


def test_unported_artifact_algos_name_their_item():
    """Every artifact algo of the JAX package is ported: an algo that
    has none (the aggregator) is refused, reading and writing."""
    buf = io.BytesIO()
    npz = io.BytesIO()
    np.savez_compressed(npz, beta=np.zeros(3, np.float32))
    import zipfile

    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("model.json", json.dumps({
            "format": "h2o_kubernetes_tpu/mojo/2",
            "algo": "aggregator"}))
        z.writestr("arrays.npz", npz.getvalue())
    with pytest.raises(NotImplementedError,
                       match="'aggregator' has no MOJO artifact"):
        MojoModel(io.BytesIO(buf.getvalue()))
    with pytest.raises(ValueError, match="has no MOJO artifact"):
        export_mojo(object(), io.BytesIO())


@pytest.mark.parametrize("root", ["file", "mem"])
def test_registry_publish_fetch_push(models, tmp_path, root):
    tm = models["tm"]
    reg = ModelRegistry(str(tmp_path / "reg") if root == "file"
                        else f"mem://reg-{id(tmp_path)}")
    assert reg.publish(tm, "late") == 1
    blob = reg.fetch("late", 1)
    assert reg.latest("late") == 1
    meta, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    assert meta == dict(tm._artifact_meta, format=MOJO_FORMAT)
    assert arrays.keys() == tm._artifact_arrays.keys()
    for k, a in arrays.items():
        np.testing.assert_array_equal(a, tm._artifact_arrays[k], err_msg=k)
    srv = start_server(port=0, device="cpu")
    port = srv.server_address[1]
    url = f"http://127.0.0.1:{port}"
    try:
        r = reg.push(url, "late", 1, "late1", warm_buckets=[128])
        assert r["contributions"] is True and r["version"] == 1
        X = models["X"][:200]
        rows = _dict_rows(tm, X)
        code, pr = _post(port, "/3/Predictions/models/late1",
                         {"rows": rows})
        assert code == 200, pr
        np.testing.assert_array_equal(np.asarray(pr["pontime"], np.float32),
                                      tm.score_numpy(X)[:, 1])
        code, cr = _post(port, "/3/Predictions/models/late1/contributions",
                         {"rows": rows})
        assert code == 200, cr
        np.testing.assert_array_equal(
            np.asarray(cr["contributions"], np.float32), tm.contrib_numpy(X))
        if root == "file":
            info = reg.info("late", 1)
            with pytest.raises(urllib.error.HTTPError) as e:
                reg._post_json(url, "/3/ModelRegistry/load", {
                    "model_id": "bad", "path": info["path"],
                    "sha256": "0" * 64}, 30)
            assert e.value.code == 409
            code, _ = _post(port, "/3/ModelRegistry/load", {
                "model_id": "gone", "path": info["path"] + ".missing"})
            assert code == 404
            assert _post(port, "/3/Predictions/models/bad",
                         {"rows": rows})[0] == 404
        # a replica's model publishes again and scores the same
        rep = load_artifact(blob, device="cpu")
        assert reg.publish(rep, "late") == 2
        out = reg.push_many(url, [("late", 2, "late2")], warm_buckets=[128])
        assert out[0]["model_id"]["name"] == "late2"
        code, pr2 = _post(port, "/3/Predictions/models/late2",
                          {"rows": rows})
        assert pr2["pontime"] == pr["pontime"]
    finally:
        stop_server(srv)
    if root == "file":
        path = reg.artifact_path("late", 1)
        persist.write_bytes(path, blob[:-1] + bytes([blob[-1] ^ 1]))
        with pytest.raises(IOError, match="digest mismatch"):
            reg.fetch("late", 1)


@pytest.mark.parametrize("first", [503, 400])
def test_push_retries_a_transient_failure(first):
    """A 503 (with Retry-After: 0) is retried and the second answer
    returned; a 400 raises on the first attempt."""
    import http.server
    import threading

    calls = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            calls.append(self.path)
            code = first if len(calls) == 1 else 200
            body = json.dumps({"n": len(calls)}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After", "0")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        if first == 400:
            with pytest.raises(urllib.error.HTTPError) as e:
                ModelRegistry._post_json(url, "/3/ModelRegistry/load",
                                         {}, 30)
            assert e.value.code == 400 and len(calls) == 1
        else:
            r = ModelRegistry._post_json(url, "/3/ModelRegistry/load",
                                         {}, 30)
            assert r == {"n": 2} and len(calls) == 2
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)


@pytest.mark.parametrize("which", ["tm", "pois", "lap"])
def test_save_load_round_trip(models, tmp_path, which):
    m = models[which]
    path = save_model(m, str(tmp_path / which))
    back = load_model(path, device="cpu")
    assert type(back) is type(m) and back.margin_scale == m.margin_scale
    for a, b in zip(m.trees, back.trees):
        assert torch.equal(a, b)
    cols = models["hold"] if which == "tm" else models["dh"]
    X = _dmatrix(m, cols)
    off = cols["off"] if m.offset_column else None
    np.testing.assert_array_equal(back.score_numpy(X, offset=off),
                                  m.score_numpy(X, offset=off))
    assert back.scoring_history == m.scoring_history
    mem = save_model(m, f"mem://models/{which}.model")
    assert persist.list_names("mem://models") and \
        load_model(mem, device="cpu").params == m.params


def test_model_file_refuses_code(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))
    p = tmp_path / "evil.model"
    p.write_bytes(b"H2OTPU-TORCH1\n" + pickle.dumps({"x": Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="not plain data"):
        load_model(str(p), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        persist.read_bytes("s3://bucket/m.model")


def test_binomial_stats_match_reference():
    rng = np.random.default_rng(4)
    y = (rng.random(5000) < 0.3).astype(np.float32)
    p = np.clip(0.3 * y + 0.7 * rng.random(5000), 0, 1).astype(np.float32)
    want = JM.binomial_stats(y, p)
    got = M.binomial_stats(torch.as_tensor(y), torch.as_tensor(p))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(M.confusion_matrix(y, p, 0.5),
                                  JM.confusion_matrix(y, p, 0.5))
    with pytest.raises(ValueError, match="both classes"):
        M.binomial_stats(np.zeros(10), p[:10])


@pytest.mark.parametrize("rows", [5000, 70_000])
def test_binomial_auc_and_stats_share_one_histogram(rows):
    """The AUC and the threshold table from one score histogram equal
    ``roc_auc`` and ``binomial_stats`` bit for bit, on the exact path
    and the histogram path; a single-class holdout gives no table."""
    rng = np.random.default_rng(5)
    y = torch.as_tensor((rng.random(rows) < 0.3).astype(np.float32))
    p = torch.as_tensor(rng.random(rows).astype(np.float32))
    auc, stats = M.binomial_auc_and_stats(y, p)
    assert auc == M.roc_auc(y, p)
    want = M.binomial_stats(y, p)
    assert stats.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(stats[k], v, err_msg=k)
    one, stats = M.binomial_auc_and_stats(torch.ones(rows), p)
    assert stats is None and np.isnan(one) and np.isnan(
        M.roc_auc(torch.ones(rows), p))


def test_model_performance_matches_reference(models):
    jm, pm = models["jm"], models["pm"]
    want = jm.model_performance(models["jh"], y="y")
    got = pm.model_performance(models["th"], y="y")
    assert set(got) == set(want) and "pr_auc" in got
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
    one = {k: v[models["hold"]["y"] == "late"] for k, v in
           models["hold"].items()}
    one_fr = Frame.from_arrays(one, domains={"y": ["late", "ontime"]},
                               device="cpu")
    assert set(pm.model_performance(one_fr, y="y")) == {"auc", "logloss",
                                                        "rmse"}


def test_predict_contributions_frame(models):
    jm, pm = models["jm"], models["pm"]
    want = jm.predict_contributions(models["jh"])
    got = pm.predict_contributions(models["th"])
    assert got.names == want.names == pm.feature_names + ["BiasTerm"]
    W = np.stack([np.asarray(want.vec(n).to_numpy()) for n in want.names], 1)
    G = np.stack([got.vec(n).to_numpy() for n in got.names], 1)
    np.testing.assert_allclose(G, W, rtol=0, atol=1e-6)
    p1 = pm.score_numpy(models["X"])[:, 1].astype(np.float64)
    np.testing.assert_allclose(G.astype(np.float64).sum(axis=1),
                               np.log(p1 / (1 - p1)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["Path", "Node_ID"])
def test_leaf_node_assignment(models, kind):
    jm, pm = models["jm"], models["pm"]
    want = jm.predict_leaf_node_assignment(models["jh"], type=kind)
    got = pm.predict_leaf_node_assignment(models["th"], type=kind)
    assert got.names == want.names == ["T1", "T2", "T3"]
    for n in got.names:
        np.testing.assert_array_equal(got.vec(n).to_numpy(),
                                      np.asarray(want.vec(n).to_numpy()))
        assert got.vec(n).domain == want.vec(n).domain
    with pytest.raises(ValueError):
        pm.predict_leaf_node_assignment(models["th"], type="Leaf")


# -- DeepLearning and Word2Vec artifacts, both ways -------------------------

def _jax_dl_model(tm, rng):
    """A JAX-package DeepLearningModel with the port model's layout and
    fresh random weights (built from numpy: nothing compiles)."""
    from h2o_kubernetes_tpu.models import deeplearning as JDLM
    from h2o_kubernetes_tpu.models.base import TrainData as JTrainData
    from h2o_kubernetes_tpu.models.datainfo import DataInfo as JDataInfo

    d = tm.dinfo
    jd = JDataInfo(list(d.coef_names), list(d.numeric_idx),
                   [tuple(s) for s in d.enum_specs], d.means, d.stds,
                   d.n_expanded, d.drop_first)
    data = JTrainData(tm.feature_names, None, None, None, 0, tm.nclasses,
                      tm.response_domain, tm.distribution,
                      tm.feature_domains)
    net = [{"w": rng.normal(size=l["w"].shape).astype(np.float32),
            "b": rng.normal(size=l["b"].shape).astype(np.float32)}
           for l in tm.net_numpy()]
    jm = JDLM.DeepLearningModel(data, JDLM.DeepLearningParams(
        hidden=tm.params.hidden, autoencoder=tm.params.autoencoder,
        activation=tm.params.activation), jd, net, tm.loss_kind)
    jm.offset_column = tm.offset_column
    return jm


@pytest.fixture(scope="module")
def dl_w2v():
    from h2o_kubernetes_tpu_torch import DeepLearning, Word2Vec

    from test_torch_deeplearning import dl_cols

    cols = dl_cols(512)
    hold = dl_cols(200, seed=4)
    fr = Frame.from_arrays(cols, device="cpu")
    kw = dict(hidden=(6, 5), epochs=1, seed=2)
    resp = ["y", "yr", "ym", "w", "off"]
    dl = {"binomial": DeepLearning(**kw).train(
              y="y", training_frame=fr, ignored_columns=resp[1:]),
          "offset": DeepLearning(activation="tanh", **kw).train(
              y="yr", training_frame=fr, offset_column="off",
              ignored_columns=["y", "ym", "w"]),
          "autoencoder": DeepLearning(hidden=(3,), epochs=1, seed=2,
                                      autoencoder=True).train(
              training_frame=fr, ignored_columns=resp)}
    toks = np.array([f"w{i % 37}" for i in range(3000)], dtype=object)
    toks[::11] = None
    w2v = Word2Vec(vec_size=8, epochs=1, min_word_freq=2, seed=3).train(
        Frame.from_arrays({"words": toks}, device="cpu"))
    return dl, hold, w2v


def _dl_src(m, hold):
    X = _dmatrix(m, hold)
    if not m.offset_column:
        return X, X
    data = {n: X[:, j] for j, n in enumerate(m.feature_names)}
    data["off"] = hold["off"]
    return X, data


@pytest.mark.parametrize("which", ["binomial", "offset", "autoencoder"])
def test_deeplearning_artifacts_both_ways(dl_w2v, which):
    """A port DeepLearning artifact scores in the JAX package's
    MojoModel within 1e-6 of the port model's score_numpy (and in the
    port's MojoModel as in the JAX package's, 1e-12: both float64
    numpy); a JAX-written artifact scores in the port's MojoModel as in
    the JAX package's, and a port model built from its parts scores it
    within 1e-6."""
    from h2o_kubernetes_tpu_torch.models.deeplearning import \
        deeplearning_model_from_arrays

    m, hold = dl_w2v[0][which], dl_w2v[1]
    X, src = _dl_src(m, hold)
    off = hold["off"] if m.offset_column else None
    blob = _blob(m)
    meta, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    assert meta["algo"] == "deeplearning" and meta["n_layers"] == len(
        m.net.layers) and meta["autoencoder"] == (which == "autoencoder")
    want = jmojo.MojoModel(io.BytesIO(blob)).predict(src)
    np.testing.assert_allclose(m.score_numpy(X, offset=off), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(MojoModel(io.BytesIO(blob)).predict(src),
                               want, rtol=1e-12, atol=0)
    jm = _jax_dl_model(m, np.random.default_rng(7))
    jbuf = io.BytesIO()
    jmojo.export_mojo(jm, jbuf)
    want = jmojo.MojoModel(io.BytesIO(jbuf.getvalue())).predict(src)
    np.testing.assert_allclose(
        MojoModel(io.BytesIO(jbuf.getvalue())).predict(src), want,
        rtol=1e-12, atol=0)
    meta, arrays, _ = read_mojo_parts(io.BytesIO(jbuf.getvalue()))
    pm = deeplearning_model_from_arrays(
        [{"w": arrays[f"net_{i}_w"], "b": arrays[f"net_{i}_b"]}
         for i in range(meta["n_layers"])], m.dinfo.coef_names,
        meta["numeric_idx"], meta["enum_specs"], arrays["means"],
        arrays["stds"], meta["feature_names"], meta["loss_kind"],
        meta["response_domain"], meta["feature_domains"],
        offset_column=meta["offset_column"], device="cpu",
        activation=meta["activation"], autoencoder=meta["autoencoder"])
    np.testing.assert_allclose(pm.score_numpy(X, offset=off), want,
                               rtol=1e-6, atol=1e-6)


def test_word2vec_artifacts_both_ways(dl_w2v):
    """Word vectors round-trip bitwise both ways and the synonyms agree."""
    from h2o_kubernetes_tpu.models.word2vec import Word2VecModel as JW2V

    w2v = dl_w2v[2]
    blob = _blob(w2v)
    mine, theirs = MojoModel(io.BytesIO(blob)), jmojo.MojoModel(
        io.BytesIO(blob))
    for word in w2v.vocab[:5]:
        v = w2v.W[w2v.word_index[word]]
        np.testing.assert_array_equal(mine.word_vector(word), v)
        np.testing.assert_array_equal(theirs.word_vector(word), v)
        assert list(mine.find_synonyms(word, 5)) == \
            list(theirs.find_synonyms(word, 5))
    W = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    jm = JW2V(None, ["a", "b", "c", "d"], np.ones(4), W)
    jbuf = io.BytesIO()
    jmojo.export_mojo(jm, jbuf)
    got = MojoModel(io.BytesIO(jbuf.getvalue()))
    for i, word in enumerate("abcd"):
        np.testing.assert_array_equal(got.word_vector(word), W[i])
    with pytest.raises(KeyError):
        got.word_vector("zz")
    with pytest.raises(ValueError, match="score no rows"):
        got.predict(np.zeros((2, 1), np.float32))


# -- frame files both ways -------------------------------------------------------

def _frame_cols():
    rng = np.random.default_rng(31)
    n = 257
    t = (1_650_000_000_000 + rng.integers(0, 10 ** 9, n)).astype(
        "datetime64[ms]")
    t[::9] = np.datetime64("NaT")
    x = (rng.normal(size=n) * 1e3).astype(np.float32)
    x[::7] = np.nan
    x[1], x[2] = -0.0, np.float32(1e-7)
    return {"x": x, "g": np.array(["a", "b,c", 'q"t', ""])[
        rng.integers(0, 4, n)], "t": t,
        "k": rng.integers(0, 9, n).astype(np.float32)}


def _same_frame(tf, jf):
    from test_torch_frame import same_frame
    with use_mesh(make_mesh(n_rows=1)):
        same_frame(tf, jf)


def test_frame_files_both_ways(tmp_path):
    """A port save_frame loads in the JAX package's load_frame and the
    reverse: names, kinds, domains, time origins and values bitwise."""
    from h2o_kubernetes_tpu_torch import load_frame, save_frame

    c = _frame_cols()
    tf = Frame.from_arrays(c, device="cpu")
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.Frame.from_arrays(c)
    save_frame(tf, str(tmp_path / "port.frame"))
    h2o.save_frame(jf, str(tmp_path / "jax.frame"))
    with use_mesh(make_mesh(n_rows=1)):
        j_from_port = h2o.load_frame(str(tmp_path / "port.frame"))
    t_from_jax = load_frame(str(tmp_path / "jax.frame"), device="cpu")
    _same_frame(tf, j_from_port)
    _same_frame(t_from_jax, jf)
    _same_frame(load_frame(str(tmp_path / "port.frame"), device="cpu"), jf)
    (tmp_path / "bad.frame").write_bytes(b"not a frame")
    with pytest.raises(Exception):
        load_frame(str(tmp_path / "bad.frame"), device="cpu")


def test_export_file_bytes_equal(tmp_path):
    """export_file writes the same bytes in both packages (numbers as
    %g, quoted labels, ISO times, empty NA fields), and import_file reads
    them back as the JAX package does."""
    from h2o_kubernetes_tpu_torch import export_file, import_file

    c = _frame_cols()
    tf = Frame.from_arrays(c, device="cpu")
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.Frame.from_arrays(c)
        h2o.export_file(jf, str(tmp_path / "jax.csv"))
    export_file(tf, str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    export_file(tf, str(tmp_path / "port.tsv"), header=False, sep="\t")
    with use_mesh(make_mesh(n_rows=1)):
        h2o.export_file(jf, str(tmp_path / "jax.tsv"), header=False,
                        sep="\t")
    assert (tmp_path / "port.tsv").read_bytes() == \
        (tmp_path / "jax.tsv").read_bytes()
    back = import_file(str(tmp_path / "port.csv"), device="cpu")
    with use_mesh(make_mesh(n_rows=1)):
        jback = h2o.import_file(str(tmp_path / "jax.csv"))
    _same_frame(back, jback)


# -- the other learners: artifacts both ways and model files ----------------

@pytest.fixture(scope="module")
def learners():
    """One small train of each of the eight other learners in both
    packages (the reference on a one-row-shard mesh, with the port's
    column statistics)."""
    from h2o_kubernetes_tpu import models as JM_
    from h2o_kubernetes_tpu.models.targetencoder import TargetEncoder as JTE
    from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
    from h2o_kubernetes_tpu_torch import (GLRM, PCA, Aggregator, CoxPH,
                                          IsolationForest, KMeans,
                                          NaiveBayes, TargetEncoder)
    from torch_f64_rollups import f64_rollups

    rng = np.random.default_rng(11)
    n = 800
    cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
            for i in range(3)}
    cols["x1"][::13] = np.nan
    cols["c"] = np.array(list("pqr"), dtype=object)[rng.integers(0, 3, n)]
    cols["y"] = np.where(cols["x0"] + rng.logistic(size=n) > 0, "b", "a")
    cols["t"] = (np.ceil(rng.weibull(1.5, n) * 50) / 50).astype(np.float32)
    cols["e"] = (rng.uniform(size=n) < 0.7).astype(np.float32)
    cols["fold"] = (np.arange(n) % 3).astype(np.float32)
    unsup = ["y", "t", "e", "fold"]
    specs = {
        "naivebayes": (JM_.NaiveBayes, NaiveBayes, {},
                       {"y": "y", "ignored_columns": ["t", "e", "fold"]}),
        "pca": (JM_.PCA, PCA, {"k": 2}, {"ignored_columns": unsup}),
        "kmeans": (JM_.KMeans, KMeans, {"k": 3}, {"ignored_columns": unsup}),
        "glrm": (JM_.GLRM, GLRM, {"k": 2, "max_iterations": 20},
                 {"ignored_columns": unsup}),
        "isolationforest": (JM_.IsolationForest, IsolationForest,
                            {"ntrees": 3}, {"ignored_columns": unsup}),
        "coxph": (JM_.CoxPH, CoxPH,
                  {"stop_column": "t", "event_column": "e"},
                  {"ignored_columns": ["y", "fold", "x1"]}),
        "targetencoder": (JTE, TargetEncoder,
                          {"data_leakage_handling": "k_fold",
                           "fold_column": "fold", "blending": True},
                          {"y": "y", "x": ["c"]}),
        "aggregator": (JM_.Aggregator, Aggregator,
                       {"target_num_exemplars": 30},
                       {"ignored_columns": unsup}),
    }
    tf = Frame.from_arrays(cols, device="cpu")
    out = {}
    with use_mesh(make_mesh(n_rows=1)), f64_rollups():
        jf = h2o.Frame.from_arrays(cols)
        for algo, (jcls, tcls, kw, tkw) in specs.items():
            out[algo] = (jcls(**kw).train(training_frame=jf, **tkw),
                         tcls(**kw).train(training_frame=tf, **tkw))
    return out, cols, tf


def _scores(m, data):
    """A port model's scores on a port Frame, or a MojoModel's."""
    if m.algo == "targetencoder":
        if isinstance(m, MojoModel):
            return m.transform(data)["c_te"]
        return m.transform(data)["c_te"].to_numpy()
    return m.predict(data) if isinstance(m, MojoModel) \
        else m.predict_raw(data)


@pytest.mark.parametrize("algo", ["naivebayes", "pca", "kmeans", "glrm",
                                  "isolationforest", "coxph",
                                  "targetencoder"])
def test_learner_artifacts_both_ways(learners, algo):
    """A port artifact scores in the JAX package's ``MojoModel`` and in
    the port's within 1e-6 (relative past 1) of the port model; a JAX
    artifact scores in the port's ``MojoModel`` as in the JAX
    package's."""
    (jm, tm), cols, tf = learners[0][algo], learners[1], learners[2]
    jf = h2o.Frame.from_arrays(cols)
    want = np.asarray(_scores(tm, tf), np.float64)
    buf = io.BytesIO()
    export_mojo(tm, buf)
    jmm = jmojo.MojoModel(io.BytesIO(buf.getvalue()))
    got_j = jmm.transform(jf)["c_te"] if algo == "targetencoder" \
        else jmm.predict(jf)
    got_t = _scores(MojoModel(io.BytesIO(buf.getvalue())), tf)
    buf2 = io.BytesIO()
    jmojo.export_mojo(jm, buf2)
    jmm2 = jmojo.MojoModel(io.BytesIO(buf2.getvalue()))
    want2 = jmm2.transform(jf)["c_te"] if algo == "targetencoder" \
        else jmm2.predict(jf)
    got2 = _scores(MojoModel(io.BytesIO(buf2.getvalue())), tf)
    for got, ref in ((got_j, want), (got_t, want), (got2, want2)):
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        assert got.shape == ref.shape
        ok = ~np.isnan(ref)
        assert (np.isnan(got) == ~ok).all()
        assert np.all(np.abs(got[ok] - ref[ok]) <=
                      1e-6 * np.maximum(np.abs(ref[ok]), 1.0)), algo


@pytest.mark.parametrize("algo", ["naivebayes", "pca", "kmeans", "glrm",
                                  "isolationforest", "coxph",
                                  "targetencoder", "aggregator"])
def test_learner_model_files(learners, tmp_path, algo):
    """``save_model``/``load_model`` keep every learner's scores (the
    aggregator its exemplar frame) bitwise."""
    tm, tf = learners[0][algo][1], learners[2]
    back = load_model(save_model(tm, str(tmp_path / algo)), device="cpu")
    assert type(back) is type(tm) and back.algo == algo
    if algo == "aggregator":
        a, b = tm.aggregated_frame, back.aggregated_frame
        assert a.names == b.names
        for n in a.names:
            np.testing.assert_array_equal(a[n].to_numpy(), b[n].to_numpy())
        return
    np.testing.assert_array_equal(_scores(back, tf), _scores(tm, tf))
    if algo not in ("targetencoder",):
        assert back.params == tm.params
