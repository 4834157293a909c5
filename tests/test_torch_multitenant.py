"""PyTorch port, the multi-tenant scorer replica, on the CPU.

Held here:
- the admission helpers equal the JAX package's on the same inputs:
  ``retry.bucket_take`` (the token bucket), ``rest._resolve_slo``,
  ``_resolve_contrib_slo``, ``_request_slo`` and ``_model_queue_share``;
- the byte budget (``H2O_TPU_SCORER_CACHE_BYTES``) holds at every step
  of a 20-model sweep, evicts and promotes, and the count cap
  (``H2O_TPU_SCORER_CACHE_MAX``) works on top;
- evict → promote is bitwise on scores and on contributions, counted as
  a promotion and timed (``promotion_s``);
- fairness bounds a tail model's latency under a hot flood, and the
  unfair baseline (``H2O_TPU_SCORE_FAIRNESS=0``) starves it; the cap is
  a per-model share; the per-model rate limit;
- over REST: the SLO header and per-model stats, warm misses
  re-baselined across an eviction, ``/3/ModelRegistry/require`` gating
  readiness, ``push_many(require=True)``;
- ``/3/Stats``' and ``/metrics``' key sets equal those of one reference
  server fed the same artifact (its predictions bitwise), but for the
  fields the README lists: the reference's ``compiles`` section, its
  build keys (jax, jaxlib, hostfp — the port's are torch, cuda,
  device) and the port's ``scorer_cache.promotion_s``.
"""

import base64
import json
import socket
import threading
import time
import traceback
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch import load_artifact, rest
from h2o_kubernetes_tpu_torch.models.base import (evict_scorer_cache,
                                                  model_scorer_counters,
                                                  scorer_cache_stats)
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.operator.registry import ModelRegistry
from h2o_kubernetes_tpu_torch.runtime import lifecycle, retry, telemetry

F = 4


def _blob(seed, ntrees=3, depth=3):
    return random_tree_artifact(seed, n_features=F, ntrees=ntrees,
                                max_depth=depth)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(base, path, payload, headers=None):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            body = r.read()
            return r.status, (json.loads(body) if path != "/metrics"
                              else body.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# Admission helpers against the reference
# ---------------------------------------------------------------------------


def test_bucket_take_equals_reference():
    from h2o_kubernetes_tpu.runtime.retry import bucket_take as jax_take

    rng = np.random.default_rng(0)
    bp, bj = {}, {}
    now = 0.0
    for _ in range(400):
        now += float(rng.exponential(0.05))
        key = f"m{int(rng.integers(0, 5))}"
        rate = float(rng.choice([0.5, 2.0, 10.0]))
        burst = None if rng.random() < 0.7 else float(rng.integers(1, 4))
        assert retry.bucket_take(bp, key, rate, now, burst) == \
            jax_take(bj, key, rate, now, burst)
        assert bp == bj


def test_slo_resolution_and_queue_share_equal_reference(monkeypatch):
    from h2o_kubernetes_tpu import rest as jrest

    assert rest.SLO_CLASSES == jrest.SLO_CLASSES
    saved = dict(jrest.REGISTRY_MODELS)
    try:
        for mod in (rest, jrest):
            mod.REGISTRY_MODELS["slo_a"] = {"slo": "interactive"}
            mod.REGISTRY_MODELS["slo_b"] = {"slo": "bogus"}
            mod.REGISTRY_MODELS["slo_c"] = {}
        for default in (None, "batch", "BATCH", "nonsense"):
            for share in (None, "0", "0.125", "3", "x"):
                for contrib in (None, "interactive", "Nope"):
                    for k, v in (("H2O_TPU_SLO_DEFAULT", default),
                                 ("H2O_TPU_SCORE_MODEL_QUEUE_SHARE", share),
                                 ("H2O_TPU_CONTRIB_SLO_DEFAULT", contrib)):
                        if v is None:
                            monkeypatch.delenv(k, raising=False)
                        else:
                            monkeypatch.setenv(k, v)
                    for key in ("slo_a", "slo_b", "slo_c", "absent"):
                        for hdr in (None, "standard", "explain"):
                            assert rest._resolve_slo(key, hdr) == \
                                jrest._resolve_slo(key, hdr)
                    for hdr in (None, "batch"):
                        assert rest._resolve_contrib_slo(hdr) == \
                            jrest._resolve_contrib_slo(hdr)
                    for cls in rest.SLO_CLASSES.values():
                        assert rest._model_queue_share(cls) == \
                            jrest._model_queue_share(cls)
        for raw in (None, "Interactive", " batch ", "turbo"):
            hdrs = {} if raw is None else {"X-H2O-SLO": raw}
            try:
                want = jrest._request_slo(hdrs)
            except ValueError:
                with pytest.raises(ValueError, match="unknown X-H2O-SLO"):
                    rest._request_slo(hdrs)
            else:
                assert rest._request_slo(hdrs) == want
    finally:
        for k in ("slo_a", "slo_b", "slo_c"):
            rest.REGISTRY_MODELS.pop(k, None)
        jrest.REGISTRY_MODELS.clear()
        jrest.REGISTRY_MODELS.update(saved)


# ---------------------------------------------------------------------------
# Byte-budgeted device state
# ---------------------------------------------------------------------------


@pytest.fixture
def clean_cache():
    evict_scorer_cache()
    yield
    evict_scorer_cache()


def test_byte_budget_holds_under_20_models(clean_cache, monkeypatch):
    """20 tenants (contributions too) under a quarter of their total
    charge: resident bytes never exceed the budget, evictions happen,
    evicted tenants promote and score bitwise as before."""
    models = [load_artifact(_blob(100 + i % 4), device="cpu")
              for i in range(20)]
    X = random_rows(7, 64, F)
    monkeypatch.setenv("H2O_TPU_SCORER_CACHE_BYTES", "0")   # unbounded
    first = [(m.score_numpy(X), m.contrib_numpy(X)) for m in models]
    total = scorer_cache_stats()["resident_bytes"]
    assert scorer_cache_stats()["resident"] == 20 and total > 0
    budget = total // 4
    monkeypatch.setenv("H2O_TPU_SCORER_CACHE_BYTES", str(budget))
    s0 = scorer_cache_stats()
    rng = np.random.default_rng(1)
    for i in rng.integers(0, 20, 60):
        m = models[int(i)]
        np.testing.assert_array_equal(m.score_numpy(X), first[int(i)][0])
        np.testing.assert_array_equal(m.contrib_numpy(X), first[int(i)][1])
        st = scorer_cache_stats()
        assert st["resident_bytes"] <= budget
        assert st["budget_bytes"] == budget
    st = scorer_cache_stats()
    assert st["evictions"] > s0["evictions"]
    assert st["promotions"] > s0["promotions"]
    assert st["promotion_s"] > s0["promotion_s"]
    assert st["resident"] < 20


def test_count_cap(clean_cache, monkeypatch):
    monkeypatch.setenv("H2O_TPU_SCORER_CACHE_MAX", "1")
    a = load_artifact(_blob(111), device="cpu")
    b = load_artifact(_blob(112), device="cpu")
    X = random_rows(8, 16, F)
    ev0 = scorer_cache_stats()["evictions"]
    a.score_numpy(X)
    b.score_numpy(X)
    assert scorer_cache_stats()["evictions"] == ev0 + 1
    assert "_flat_trees" not in a.__dict__ and "_flat_trees" in b.__dict__
    assert scorer_cache_stats()["resident"] == 1


def test_evict_promote_bitwise(clean_cache):
    """Eviction drops the device tensors (flat trees, TreeSHAP path and
    pattern tables) and keeps the host arrays; the next calls promote
    with bitwise-equal scores and contributions."""
    m = load_artifact(_blob(113, ntrees=4, depth=4), device="cpu")
    X = random_rows(9, 300, F)
    p0, c0 = m.score_numpy(X), m.contrib_numpy(X)
    assert m._serving_resident_bytes() > 0
    s0 = scorer_cache_stats()
    assert evict_scorer_cache(m) == 1
    for name in ("_flat_trees", "_enum_mask", "_init_t", "_shap_tables",
                 "_shap_ctab", "_shap_slots"):
        assert name not in m.__dict__, name
    assert "_artifact_arrays" in m.__dict__ and \
        "_shap_tables_np" in m.__dict__
    s1 = scorer_cache_stats()
    assert s1["evictions"] == s0["evictions"] + 1
    assert s1["resident"] == s0["resident"] - 1
    np.testing.assert_array_equal(m.score_numpy(X), p0)
    np.testing.assert_array_equal(m.contrib_numpy(X), c0)
    s2 = scorer_cache_stats()
    assert s2["promotions"] == s1["promotions"] + 2
    assert s2["misses"] == s1["misses"] + 2
    assert model_scorer_counters(m)["promotions"] == 2
    assert s2["promotion_s"] > s1["promotion_s"]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (scoring graphs are card-only)")
    return name


@pytest.mark.parametrize("dev", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_eviction_from_another_thread_while_scoring(dev, clean_cache,
                                                    monkeypatch):
    """One thread scores a model at three buckets while a second evicts
    it, directly and through the count cap as it scores another model:
    every score keeps its bits (on the card, the replay of a graph whose
    model is evicted meanwhile), nothing raises, and the model's charge
    is whole once the threads stop."""
    dev = _device(dev)
    monkeypatch.setenv("H2O_TPU_SCORER_CACHE_MAX", "1")
    m = load_artifact(_blob(114, ntrees=4, depth=4), device=dev)
    other = load_artifact(_blob(115), device=dev)
    Xs = {n: random_rows(10 + n, n, F) for n in (1, 200, 600)}
    want = {n: m.score_numpy(X) for n, X in Xs.items()}
    s0 = scorer_cache_stats()
    errors, stop = [], threading.Event()

    def scorer():
        try:
            for i in range(150):
                n = (1, 200, 600)[i % 3]
                np.testing.assert_array_equal(m.score_numpy(Xs[n]), want[n])
        except BaseException:           # noqa: BLE001 — reported below
            errors.append(traceback.format_exc())
        finally:
            stop.set()

    def evictor():
        try:
            while not stop.is_set():
                evict_scorer_cache(m)
                other.score_numpy(Xs[1])        # the cap evicts m too
        except BaseException:           # noqa: BLE001
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=f) for f in (scorer, evictor)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, "\n".join(errors)
    s1 = scorer_cache_stats()
    assert s1["evictions"] > s0["evictions"]
    assert s1["promotions"] > s0["promotions"]
    monkeypatch.setenv("H2O_TPU_SCORER_CACHE_MAX", "0")
    np.testing.assert_array_equal(m.score_numpy(Xs[600]), want[600])
    from h2o_kubernetes_tpu_torch.models import base

    assert base._SCORER_BYTES[id(m)] == m._serving_resident_bytes() > 0


# ---------------------------------------------------------------------------
# Fairness, SLO priority, rate limits (the batcher alone)
# ---------------------------------------------------------------------------


class _SlowModel:
    """Scores zeros after ``delay`` seconds (a dispatch stand-in)."""

    def __init__(self, delay, k=2):
        self.delay = delay
        self.k = k

    def score_numpy(self, X, offset=None):
        time.sleep(self.delay)
        return np.zeros((X.shape[0], self.k), dtype=np.float32)


def _flood(batcher, model, key, workers, rows, stop):
    shed = [0]

    def worker():
        X = np.zeros((rows, 4), dtype=np.float32)
        while not stop.is_set():
            try:
                batcher.submit(model, X, model_key=key, slo="standard",
                               timeout=5.0)
            except rest.QueueFullError:
                shed[0] += 1
                time.sleep(0.002)
            except Exception:  # noqa: BLE001 — the flood keeps going
                pass

    ts = [threading.Thread(target=worker, daemon=True)
          for _ in range(workers)]
    for t in ts:
        t.start()
    return ts, shed


@pytest.fixture
def serving_node():
    lifecycle.reset()
    lifecycle.mark_serving()
    yield
    lifecycle.reset()


@pytest.mark.parametrize("fair", [True, False], ids=["fair", "unfair"])
def test_fairness_tail_under_hot_flood(fair, serving_node, monkeypatch):
    """Fairness on: the hot model sheds against its own share and every
    serial interactive tail request completes inside its implicit 500 ms
    deadline. Off: the same flood owns the queue and the tail misses
    (shed or 504)."""
    monkeypatch.setenv("H2O_TPU_SCORE_QUEUE_MAX", "8")
    monkeypatch.setenv("H2O_TPU_SCORE_FAIRNESS", "1" if fair else "0")
    monkeypatch.setenv("H2O_TPU_SCORE_BATCH_US", "1000")
    batcher = rest.ScoreBatcher()
    hot, tail = _SlowModel(delay=0.03), _SlowModel(delay=0.001)
    stop = threading.Event()
    ts, hot_shed = _flood(batcher, hot, "hot", 12, 64, stop)
    try:
        time.sleep(0.2)
        lat, misses = [], 0
        for _ in range(25 if fair else 40):
            Xt = np.zeros((8, 4), dtype=np.float32)
            t0 = time.monotonic()
            try:
                out = batcher.submit(tail, Xt, model_key="tail",
                                     slo="interactive")
                assert out.shape == (8, 2)
                lat.append(time.monotonic() - t0)
            except (rest.QueueFullError, rest._DeadlineExpired,
                    TimeoutError):
                misses += 1
        if fair:
            assert misses == 0 and max(lat) < 0.5, sorted(lat)[-3:]
            assert hot_shed[0] > 0 and batcher.stats["fairness_shed"] > 0
        else:
            assert misses > 0
    finally:
        stop.set()
        for t in ts:
            t.join(10)
        batcher.stop(timeout=10)


def test_fairness_cap_is_per_model_share(serving_node, monkeypatch):
    monkeypatch.setenv("H2O_TPU_SCORE_QUEUE_MAX", "8")
    monkeypatch.setenv("H2O_TPU_SCORE_FAIRNESS", "1")
    monkeypatch.setenv("H2O_TPU_SCORE_BATCH_US", "900000")
    batcher = rest.ScoreBatcher()
    m = _SlowModel(delay=0.0)
    errs, ts = [], []

    def one(key, slo):
        try:
            batcher.submit(m, np.zeros((1, 4), np.float32), model_key=key,
                           slo=slo, timeout=5.0)
        except rest.QueueFullError as e:
            errs.append(e)

    try:
        # standard's share of 8 is 4: the 5th and 6th are shed
        for _ in range(6):
            t = threading.Thread(target=one, args=("a", "standard"))
            t.start()
            ts.append(t)
            time.sleep(0.02)
        time.sleep(0.1)
        assert len(errs) == 2 and "fair share" in str(errs[0])
        # another model still finds room
        t = threading.Thread(target=one, args=("b", "standard"))
        t.start()
        ts.append(t)
        time.sleep(0.05)
        assert len(errs) == 2
    finally:
        batcher.stop(timeout=10)
        for t in ts:
            t.join(10)


def test_rate_limit_token_bucket(serving_node, monkeypatch):
    monkeypatch.setenv("H2O_TPU_MODEL_RATE_LIMIT", "5")
    monkeypatch.setenv("H2O_TPU_SCORE_BATCH_US", "0")
    monkeypatch.setattr(rest, "_bucket_now", lambda: 1000.0)
    rest.reset_rate_buckets()
    batcher = rest.ScoreBatcher()
    m = _SlowModel(delay=0.0)
    X = np.zeros((1, 4), np.float32)
    base_total = rest.STATS["rate_limited"]
    ok = limited = 0
    retry_after = None
    try:
        for _ in range(8):
            try:
                batcher.submit(m, X, model_key="hot_rl", slo="standard")
                ok += 1
            except rest.QueueFullError as e:
                limited += 1
                retry_after = e.retry_after
        batcher.submit(m, X, model_key="cold_rl", slo="standard")
        assert ok == 5 and limited == 3
        assert 0 < retry_after <= 0.25
        assert rest.STATS["rate_limited"] - base_total == 3
        assert rest.MODEL_STATS["hot_rl"]["rate_limited"] == 3
        assert rest.MODEL_STATS["cold_rl"]["rate_limited"] == 0
        monkeypatch.setenv("H2O_TPU_MODEL_RATE_LIMIT", "0")
        rest.reset_rate_buckets()
        for _ in range(10):                       # off: never limited
            batcher.submit(m, X, model_key="hot_rl", slo="standard")
        assert not rest._RATE_BUCKETS
    finally:
        batcher.stop(timeout=10)
        rest.reset_rate_buckets()
        for k in ("hot_rl", "cold_rl"):
            rest.MODEL_STATS.pop(k, None)


# ---------------------------------------------------------------------------
# Over REST
# ---------------------------------------------------------------------------


@pytest.fixture
def tenant_server():
    srv = rest.start_server(port=0, device="cpu")
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    rest.stop_server(srv)
    rest.READINESS_GATES.clear()
    rest.REQUIRED_MODEL_IDS.clear()
    for store in (rest.REGISTRY_MODELS, rest.MODEL_STATS, rest.MODELS):
        store.clear()
    lifecycle.reset()


def _load(base, model_id, blob, slo=None):
    body = {"model_id": model_id, "warm_buckets": [128],
            "artifact_b64": base64.b64encode(blob).decode()}
    if slo is not None:
        body["slo"] = slo
    return _post(base, "/3/ModelRegistry/load", body)


def test_slo_header_and_per_model_stats(tenant_server):
    base = tenant_server
    code, out = _load(base, "tm", _blob(121), slo="interactive")
    assert code == 200 and out["slo"] == "interactive"
    assert _load(base, "tx", _blob(121), slo="turbo")[0] == 400
    rows = [{f"x{i}": 0.1 * i for i in range(F)}]
    code, out = _post(base, "/3/Predictions/models/tm", {"rows": rows},
                      headers={"X-H2O-SLO": "turbo"})
    assert code == 400 and "turbo" in out["msg"]
    assert _post(base, "/3/Predictions/models/tm", {"rows": rows},
                 headers={"X-H2O-SLO": "batch"})[0] == 200
    assert _post(base, "/3/Predictions/models/tm", {"rows": rows})[0] == 200
    assert _post(base, "/3/Predictions/models/tm/contributions",
                 {"rows": rows})[0] == 200
    code, st = _get(base, "/3/Stats")
    assert code == 200
    rec = st["models"]["tm"]
    assert rec["requests"] == 2 and rec["batches"] == 2
    assert rec["contrib_requests"] == 1 and rec["contrib_rows"] == 1
    assert rec["slo"] == "explain"          # the last request's class
    for k in ("resident", "resident_bytes", "budget_bytes", "promotions",
              "evictions"):
        assert k in st["scorer_cache"]
    assert st["fairness"] is True
    assert st["registry"]["tm"]["slo"] == "interactive"
    code, reg = _get(base, "/3/ModelRegistry")
    assert code == 200 and reg["models"]["tm"]["slo"] == "interactive"
    assert "warm_baseline" not in reg["models"]["tm"]


def test_warm_misses_rebaseline_across_eviction(tenant_server):
    base = tenant_server
    assert _load(base, "wm", _blob(122))[0] == 200
    rows = [{f"x{i}": 0.5 for i in range(F)}] * 8

    def wcm():
        return _get(base, "/3/Stats")[1]["registry"]["wm"][
            "warm_cache_misses"]

    assert _post(base, "/3/Predictions/models/wm", {"rows": rows})[0] == 200
    assert wcm() == 0
    evict_scorer_cache(rest.MODELS["wm"])
    assert _post(base, "/3/Predictions/models/wm", {"rows": rows})[0] == 200
    assert _post(base, "/3/Predictions/models/wm/contributions",
                 {"rows": rows})[0] == 200
    assert wcm() == 0, "a promotion was reported as a warm miss"
    assert model_scorer_counters(rest.MODELS["wm"])["promotions"] == 2


def test_require_gates_readiness(tenant_server):
    base = tenant_server
    rest.install_pool_replica_gate()
    code, out = _post(base, "/3/ModelRegistry/require",
                      {"model_ids": ["a1", "a2"]})
    assert code == 200 and out["satisfied"] is False
    assert _get(base, "/readyz")[0] == 503
    blob = _blob(123)
    assert _load(base, "a1", blob)[0] == 200
    code, out = _get(base, "/readyz")
    assert code == 503 and any("a2" in r for r in out["reasons"])
    assert _load(base, "a2", blob)[0] == 200
    assert _get(base, "/readyz")[0] == 200
    assert _post(base, "/3/ModelRegistry/require",
                 {"model_ids": "a1"})[0] == 400
    # cordon: readiness off, scoring still served
    code, out = _post(base, "/3/Cordon", {"reason": "roll"})
    assert code == 200 and out["ready"] is False
    assert _get(base, "/readyz")[0] == 503
    rows = [{f"x{i}": 0.0 for i in range(F)}]
    assert _post(base, "/3/Predictions/models/a1", {"rows": rows})[0] == 200
    assert _post(base, "/3/Uncordon", {})[1]["ready"] is True
    # push_many declares the set first: the replica requires b1, b2
    reg = ModelRegistry("mem://torch_multitenant_push")
    v = reg.publish(load_artifact(blob, device="cpu"), "t")
    out = reg.push_many(base, [("t", v, "b1"), ("t", v, "b2", "batch")],
                        warm_buckets=[128])
    assert [o["model_id"]["name"] for o in out] == ["b1", "b2"]
    assert out[1]["slo"] == "batch"
    assert _get(base, "/3/ModelRegistry")[1]["required"] == ["b1", "b2"]


# ---------------------------------------------------------------------------
# /3/Stats and /metrics against one reference server
# ---------------------------------------------------------------------------

# what the port leaves out or adds (README: "Serving replica")
_PORT_ONLY = {("scorer_cache", "promotion_s"), ("build", "torch"),
              ("build", "cuda"), ("build", "device")}
_REF_ONLY = {("compiles",), ("build", "jax"), ("build", "jaxlib"),
             ("build", "hostfp")}
# the stat groups both servers register (the reference process may hold
# other groups and series from other tests)
_GROUPS = ("counters", "batcher", "models", "registry", "identity",
           "scorer_cache", "lifecycle", "build")


def _key_paths(obj, prefix=()):
    out = set()
    for k, v in obj.items():
        out.add(prefix + (k,))
        if isinstance(v, dict) and prefix[:1] not in (("models",),
                                                      ("registry",)):
            out |= _key_paths(v, prefix + (k,))
    return out


def _series_names(text):
    names = {name for name, _ in telemetry.parse_prometheus_text(text)}
    keep = tuple(telemetry.metric_name(g) + "_" for g in _GROUPS)
    return {n for n in names if n.startswith(keep)
            or n.startswith(("h2o_request_phase_seconds",
                             "h2o_request_seconds"))}


@pytest.fixture(scope="module")
def twin_servers(mesh8):
    from h2o_kubernetes_tpu import rest as jrest

    blob = _blob(131, ntrees=4, depth=4)
    jport = _free_port()
    jsrv = jrest.start_server(jport)
    psrv = rest.start_server(port=0, device="cpu")
    bases = (f"http://127.0.0.1:{psrv.server_address[1]}",
             f"http://127.0.0.1:{jport}")
    try:
        for base in bases:
            code, _ = _load(base, "twin", blob, slo="standard")
            assert code == 200
        yield bases
    finally:
        rest.stop_server(psrv)
        jsrv.shutdown()
        jsrv.server_close()
        for mod in (rest, jrest):
            mod.REGISTRY_MODELS.pop("twin", None)
            mod.MODELS.pop("twin", None)
            with mod._STATS_LOCK:
                mod.MODEL_STATS.pop("twin", None)
        lifecycle.reset()


def test_stats_and_metrics_keys_equal_reference(twin_servers):
    port, ref = twin_servers
    rows = random_rows(132, 40, F)
    body = {"rows": [[None if np.isnan(v) else float(v) for v in r]
                     for r in rows], "columns": [f"x{i}" for i in range(F)]}
    outs = []
    for base in (port, ref):
        code, out = _post(base, "/3/Predictions/models/twin", body,
                          headers={"X-H2O-Trace-Id": "twin-trace"})
        assert code == 200
        outs.append(out)
        assert _post(base, "/3/Predictions/models/twin/contributions",
                     body)[0] == 200
    assert outs[0]["predict"] == outs[1]["predict"]
    np.testing.assert_array_equal(np.float32(outs[0]["p1"]),
                                  np.float32(outs[1]["p1"]))
    (pc, pst), (rc, rst) = _get(port, "/3/Stats"), _get(ref, "/3/Stats")
    assert pc == rc == 200
    pk = {p for p in _key_paths(pst) if p[0] != "identity"}
    rk = {p for p in _key_paths(rst) if p[0] != "identity"}
    assert {p for p in pk - rk} == _PORT_ONLY
    assert {p[:1] if p[0] == "compiles" else p for p in rk - pk} \
        == _REF_ONLY
    assert set(pst["models"]["twin"]) == set(rst["models"]["twin"])
    assert set(pst["registry"]["twin"]) == set(rst["registry"]["twin"])
    pn = _series_names(_get(port, "/metrics")[1])
    rn = _series_names(_get(ref, "/metrics")[1])
    # a None leaf (torch's CUDA version on a CPU build) has no series
    port_only = {telemetry.metric_name(*p) for p in _PORT_ONLY
                 if pst[p[0]][p[1]] is not None}
    ref_only = {telemetry.metric_name(*p) for p in _REF_ONLY
                if p[0] == "build" and rst[p[0]][p[1]] is not None}
    assert pn - rn == port_only
    assert rn - pn == ref_only
    for base in (port, ref):
        code, tr = _get(base, "/3/Trace/twin-trace")
        assert code == 200
        assert {s["name"] for s in tr["spans"]} == {
            "admission", "queue", "assemble", "dispatch", "total"}
