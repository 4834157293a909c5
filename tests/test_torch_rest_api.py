"""PyTorch port, the H2O REST API on a replica (``start_server(device=
"cpu")``), on the CPU.

Held here:
- the client loop CSV → ``/3/ImportFiles`` + ``/3/Parse`` →
  ``/3/ModelBuilders/gbm`` → ``/3/Jobs`` → ``/3/Models`` →
  ``/3/Predictions/models/{m}/frames/{f}`` → DELETE (and ``/3/DKV``);
- a GBM built over REST is bitwise the in-process train on the same
  file (trees, scoring history, predictions), and its downloaded MOJO
  scores within 1e-6 in the JAX package's numpy ``MojoModel``;
- ``/3/Cloud``'s keys are the JAX package's ``cluster_status()``'s; the
  leader probe (``H2O_TPU_PROCESS_ID``), ``/3/Timeline``, the Flow page,
  NaN served as JSON ``null``, URL-encoded keys, the job reaper and the
  job poll timeout (``H2O_TPU_JOB_TIMEOUT``);
- every learner's builder route at a tiny size, the stacked ensemble
  over REST-built base models, AutoML over REST with the in-process
  run's leaderboard ids and order, and a grid;
- no ``h2o-torch-*`` thread outlives the test that started it (server,
  batcher, job workers, heartbeat, status listener).
"""

import io
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch import (GBM, AutoML, GridSearch, import_file,
                                      rest)
from h2o_kubernetes_tpu_torch.automl import JOBS, Job
from h2o_kubernetes_tpu_torch.runtime import health, lifecycle, telemetry

N = 240


def _strict(body: bytes):
    """JSON that must not carry bare NaN/Infinity."""
    def refuse(tok):
        raise ValueError(f"non-JSON constant {tok}")
    return json.loads(body, parse_constant=refuse)


def _call(base, path, payload=None, method=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        base + path, data=data,
        method=method or ("GET" if data is None else "POST"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
            ctype = r.headers.get("Content-Type", "")
            return r.status, (_strict(body) if "json" in ctype else body)
    except urllib.error.HTTPError as e:
        return e.code, _strict(e.read())


def _write_csv(path, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 4)).astype(np.float32)
    c = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, N)]
    y = np.where(x[:, 0] - 0.5 * x[:, 1] + (c == "b")
                 + rng.normal(scale=0.5, size=N) > 0, "yes", "no")
    t = np.round(rng.exponential(size=N) + 0.01, 3)
    e = (rng.random(N) < 0.7).astype(int)
    with open(path, "w") as f:
        f.write("x0,x1,x2,x3,c,y,t,e,empty\n")
        for i in range(N):
            xs = ["" if (i % 17 == 3 and j == 1) else f"{x[i, j]:.5f}"
                  for j in range(4)]
            f.write(",".join(xs + [c[i], y[i], f"{t[i]}", f"{e[i]}", ""])
                    + "\n")
    return path


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    work = tmp_path_factory.mktemp("rest_api")
    csv = _write_csv(str(work / "table.csv"))
    words = work / "words.csv"
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(12)]
    words.write_text("w\n" + "\n".join(
        vocab[int(i)] for i in rng.integers(0, 12, 400)) + "\n")
    srv = rest.start_server(port=0, device="cpu")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    code, fr = _call(base, "/3/ImportFiles", {"path": csv,
                                              "destination_frame": "tab"})
    assert code == 200 and fr["rows"] == N
    yield {"base": base, "csv": csv, "words": str(words)}
    rest.stop_server(srv)
    for store in (rest.FRAMES, rest.MODELS, rest.AUTOML, rest.GRIDS):
        store.clear()
    lifecycle.reset()


GBM_KW = {"ntrees": 4, "max_depth": 3, "seed": 1}


def _build(base, algo, **params):
    code, out = _call(base, f"/3/ModelBuilders/{algo}",
                      {"training_frame": "tab", **params})
    assert code == 200, out
    return out["job"]


def test_csv_to_predictions_and_delete(api):
    base = api["base"]
    code, out = _call(base, "/3/Parse", {"source_frames": [api["csv"]],
                                         "destination_frame": "tab2"})
    assert code == 200 and out["frame_id"]["name"] == "tab2"
    kinds = {col["label"]: col["type"] for col in out["columns"]}
    assert kinds["c"] == "enum" and kinds["x0"] == "numeric"
    assert _call(base, "/3/Parse", {"source_frames": ["a", "b"]})[0] == 400
    assert _call(base, "/3/ImportFiles", {"path": api["csv"] + ".no"}
                 )[0] == 404
    job = _build(base, "gbm", model_id="gbm_rest", response_column="y",
                 ignored_columns=["t", "e", "empty"], **GBM_KW)
    assert job["status"] == "DONE" and job["dest"]["name"] == "gbm_rest"
    code, jobs = _call(base, "/3/Jobs")
    assert any(j["dest"] == "gbm_rest" and j["status"] == "DONE"
               for j in jobs["jobs"])
    code, ms = _call(base, "/3/Models")
    assert {"model_id": {"name": "gbm_rest"}, "algo": "gbm"} in ms["models"]
    code, m = _call(base, "/3/Models/gbm_rest")
    assert code == 200 and m["nclasses"] == 2 and \
        m["variable_importances"]
    code, p = _call(base, "/3/Predictions/models/gbm_rest/frames/tab2", {})
    assert code == 200 and p["rows"] == N
    assert [c["label"] for c in p["columns"]] == ["predict", "pno", "pyes"]
    pkey = p["predictions_frame"]["name"]
    assert _call(base, f"/3/Frames/{pkey}")[0] == 200
    assert _call(base, "/3/Models/nope")[0] == 404
    assert _call(base, "/3/ModelBuilders/nope", {})[0] == 404
    assert _call(base, "/3/ModelBuilders/gbm", {"training_frame": "no"}
                 )[0] == 404
    for path in (f"/3/Frames/{pkey}", "/3/Frames/tab2"):
        code, out = _call(base, path, method="DELETE")
        assert code == 200 and out["removed"]
        assert _call(base, path, method="DELETE")[0] == 404


def test_rest_gbm_bitwise_and_its_mojo(api):
    from h2o_kubernetes_tpu.mojo import MojoModel as JaxMojo

    base = api["base"]
    if "gbm_rest" not in rest.MODELS:
        _build(base, "gbm", model_id="gbm_rest", response_column="y",
               ignored_columns=["t", "e", "empty"], **GBM_KW)
    served = rest.MODELS["gbm_rest"]
    fr = import_file(api["csv"], device="cpu")
    local = GBM(**GBM_KW).train(y="y", training_frame=fr,
                                ignored_columns=["t", "e", "empty"])
    for a, b in zip(served.trees, local.trees):
        assert torch.equal(a, b)
    assert served.scoring_history == local.scoring_history
    want = local.predict_raw(fr)
    np.testing.assert_array_equal(served.predict_raw(rest.FRAMES["tab"]),
                                  want)
    code, blob = _call(base, "/3/Models/gbm_rest/mojo")
    assert code == 200 and isinstance(blob, bytes)
    X = local._design_matrix(fr).numpy()
    got = JaxMojo(io.BytesIO(blob)).predict(X)
    assert np.abs(got - want).max() <= 1e-6


def test_cloud_leader_timeline_flow(api, monkeypatch):
    from h2o_kubernetes_tpu import cluster_status

    base = api["base"]
    code, cloud = _call(base, "/3/Cloud")
    assert code == 200 and cloud["cloud_healthy"] is True
    assert set(cloud) == set(cluster_status())
    assert cloud["cloud_size"] == 1 and cloud["devices"] == ["cpu"]
    for path in ("/kubernetes/isLeaderNode", "/3/IsLeaderNode"):
        assert _call(base, path) == (200, {"leader": True})
    for pid in ("1", "x"):
        monkeypatch.setenv("H2O_TPU_PROCESS_ID", pid)
        assert _call(base, "/kubernetes/isLeaderNode")[0] == 503
    monkeypatch.setenv("H2O_TPU_PROCESS_ID", "0")
    assert _call(base, "/3/IsLeaderNode")[0] == 200
    code, tl = _call(base, "/3/Timeline")
    assert code == 200 and any(e["kind"] == "job_start"
                               for e in tl["events"])
    for path in ("", "/flow", "/flow/index.html"):
        code, page = _call(base, path)
        assert code == 200 and b"/3/ModelBuilders/" in page
    assert _call(base, "/no/such/route")[0] == 404


def test_nan_as_null_and_encoded_keys(api):
    base = api["base"]
    key = "my frame%1"
    code, out = _call(base, "/3/ImportFiles",
                      {"path": api["csv"], "destination_frame": key})
    assert code == 200
    enc = urllib.parse.quote(key, safe="")
    code, summ = _call(base, f"/3/Frames/{enc}/summary")
    assert code == 200 and summ["frame_id"]["name"] == key
    assert summ["summary"]["empty"]["mean"] is None      # NaN -> null
    assert summ["summary"]["x1"]["nacnt"] > 0
    assert any(f["frame_id"]["name"] == key
               for f in _call(base, "/3/Frames")[1]["frames"])
    mid = "gbm model %2"
    job = _build(base, "gbm", model_id=mid, response_column="y",
                 ignored_columns=["t", "e", "empty"], ntrees=1, max_depth=2)
    assert job["status"] == "DONE"
    menc = urllib.parse.quote(mid, safe="")
    assert _call(base, f"/3/Models/{menc}")[1]["model_id"]["name"] == mid
    code, p = _call(base, f"/3/Predictions/models/{menc}/frames/{enc}", {})
    assert code == 200
    assert _call(base, f"/3/Models/{menc}", method="DELETE")[0] == 200
    assert _call(base, f"/3/Frames/{enc}", method="DELETE")[0] == 200


def test_job_reaper_and_poll_timeout(api, monkeypatch):
    base = api["base"]
    dead = threading.Thread(target=lambda: None, name="h2o-torch-job")
    dead.start()
    dead.join()
    j1 = Job(dest="reap_dead", description="a worker that died").start()
    j1._thread = dead
    j2 = Job(dest="reap_slow", description="a stuck job").start()
    j2.start_time = time.time() - 10.0
    try:
        code, _ = _call(base, "/3/Jobs")
        assert code == 200
        assert j1.status == "FAILED" and "died" in j1.msg
        assert j2.status == "RUNNING"           # no timeout set
        monkeypatch.setenv("H2O_TPU_JOB_TIMEOUT", "5")
        out = {j["dest"]: j for j in _call(base, "/3/Jobs")[1]["jobs"]}
        assert out["reap_slow"]["status"] == "FAILED"
        assert "H2O_TPU_JOB_TIMEOUT" in out["reap_slow"]["msg"]
    finally:
        JOBS.pop("reap_dead", None)
        JOBS.pop("reap_slow", None)


_LEARNERS = {
    "drf": {"response_column": "y", "ntrees": 2, "max_depth": 3},
    "xgboost": {"response_column": "y", "ntrees": 2, "max_depth": 2},
    "glm": {"response_column": "y", "family": "binomial"},
    "deeplearning": {"response_column": "y", "hidden": [4], "epochs": 1,
                     "seed": 1},
    "naivebayes": {"response_column": "y"},
    "kmeans": {"k": 2}, "pca": {"k": 2}, "glrm": {"k": 2,
                                                  "max_iterations": 5},
    "isolationforest": {"ntrees": 3, "sample_size": 64},
    "aggregator": {"target_num_exemplars": 20},
    "coxph": {"stop_column": "t", "event_column": "e"},
    "targetencoder": {"response_column": "y"},
}


@pytest.mark.parametrize("algo", sorted(_LEARNERS))
def test_builder_route_of_each_learner(api, algo):
    base = api["base"]
    kw = dict(_LEARNERS[algo])
    ign = ["empty"] + (["t", "e"] if algo != "coxph" else []) + \
        (["y"] if "response_column" not in kw and algo != "coxph" else [])
    if algo == "coxph":
        ign += ["y", "c"]
    job = _build(base, algo, model_id=f"{algo}_b", ignored_columns=ign,
                 **kw)
    assert job["status"] == "DONE", job["msg"]
    model = rest.MODELS[f"{algo}_b"]
    assert model.algo == algo
    code, out = _call(base, f"/3/Models/{algo}_b")
    assert code == 200 and out["algo"] == algo


def test_word2vec_and_stacked_ensemble_routes(api):
    base = api["base"]
    code, _ = _call(base, "/3/ImportFiles", {"path": api["words"],
                                             "destination_frame": "words"})
    assert code == 200
    code, out = _call(base, "/3/ModelBuilders/word2vec", {
        "training_frame": "words", "model_id": "w2v_b", "vec_size": 4,
        "min_word_freq": 1, "epochs": 1})
    assert code == 200 and out["job"]["status"] == "DONE", out
    assert rest.MODELS["w2v_b"].algo == "word2vec"
    ids = []
    for algo, kw in (("gbm", GBM_KW), ("glm", {"family": "binomial"})):
        ids.append(f"{algo}_cv")
        _build(base, algo, model_id=ids[-1], response_column="y",
               ignored_columns=["t", "e", "empty"], nfolds=2,
               fold_assignment="modulo", **kw)
    job = _build(base, "stackedensemble", model_id="se_b",
                 response_column="y", base_models=ids)
    assert job["status"] == "DONE", job["msg"]
    assert rest.MODELS["se_b"].algo == "stackedensemble"
    assert _call(base, "/3/ModelBuilders/stackedensemble", {
        "training_frame": "tab", "response_column": "y",
        "base_models": ["nope"]})[0] == 404


def test_automl_and_grid_over_rest(api):
    base = api["base"]
    kw = {"max_models": 2, "nfolds": 2, "include_algos": ["glm", "gbm"],
          "seed": 1}
    code, out = _call(base, "/3/AutoML", {
        "training_frame": "tab", "response_column": "y",
        "project_name": "aml_rest", **kw})
    assert code == 200 and out["job"]["status"] == "DONE", out
    code, lb = _call(base, "/3/AutoML/aml_rest")
    assert code == 200
    fr = import_file(api["csv"], device="cpu")
    local = AutoML(project_name="aml_rest", verbosity=None, **kw).train(
        y="y", training_frame=fr)
    want = local.leaderboard.as_list()
    assert [r["model_id"] for r in lb["leaderboard"]] == \
        [r["model_id"] for r in want]
    assert [r["auc"] for r in lb["leaderboard"]] == [r["auc"] for r in want]
    assert lb["leader"]["name"] == lb["leaderboard"][0]["model_id"]
    assert _call(base, "/3/AutoML/none")[0] == 404
    code, out = _call(base, "/99/Grid/gbm", {
        "training_frame": "tab", "response_column": "y",
        "grid_id": "g_rest", "ntrees": 2, "seed": 1,
        "hyper_parameters": {"max_depth": [2, 3]}})
    assert code == 200 and out["job"]["status"] == "DONE", out
    code, g = _call(base, "/99/Grids/g_rest")
    assert code == 200 and len(g["model_ids"]) == 2
    local_g = GridSearch(GBM(ntrees=2, seed=1), {"max_depth": [2, 3]},
                         grid_id="g_local").train(y="y", training_frame=fr)
    assert [r["max_depth"] for r in g["summary"]] == \
        [r["max_depth"] for r in local_g.get_grid()]
    assert _call(base, "/99/Grid/gbm", {"training_frame": "tab",
                                        "response_column": "y"})[0] == 400


def _port_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("h2o-torch-") and t.is_alive()]


def test_no_port_thread_outlives_its_test(tmp_path):
    """A server with a job worker, the batcher, the heartbeat loop and
    a status listener: stopped, none of their threads is left."""
    before = {id(t) for t in _port_threads()}
    srv = rest.start_server(port=0, device="cpu")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    status = telemetry.start_status_listener(0)
    health.start_heartbeat(interval=0.05, timeout=10.0, device="cpu")
    try:
        csv = _write_csv(str(tmp_path / "t.csv"), seed=4)
        assert _call(base, "/3/ImportFiles", {"path": csv,
                                              "destination_frame": "thr"}
                     )[0] == 200
        code, out = _call(base, "/3/ModelBuilders/gbm", {
            "training_frame": "thr", "response_column": "y",
            "model_id": "thr_gbm", "ntrees": 1, "max_depth": 2,
            "ignored_columns": ["t", "e", "empty"]})
        assert code == 200 and out["job"]["status"] == "DONE"
        rows = [{f"x{i}": 0.1 for i in range(4)} | {"c": "a"}]
        assert _call(base, "/3/Predictions/models/thr_gbm",
                     {"rows": rows})[0] == 200
        names = {t.name for t in _port_threads()}
        assert {"h2o-torch-rest", "h2o-torch-score-batcher",
                "h2o-torch-status", "h2o-torch-heartbeat"} <= names
    finally:
        health.stop_heartbeat(join=True)
        status.shutdown()
        status.server_close()
        rest.stop_server(srv)
        rest.FRAMES.pop("thr", None)
        rest.MODELS.pop("thr_gbm", None)
        health.reset()
        lifecycle.reset()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        left = [t.name for t in _port_threads() if id(t) not in before]
        if not left:
            break
        time.sleep(0.05)
    assert not left, left
