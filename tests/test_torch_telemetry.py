"""PyTorch port, telemetry (``runtime/telemetry.py``, a copy of the JAX
package's, rewired): the same sequence of updates gives the same
Prometheus text in both packages, and the contracts of the JAX
package's ``tests/test_telemetry.py`` hold on the port — the label
allowlist, no lost updates under threads, the top-K ``model`` cap, the
histogram buckets and quantile, the stat groups and their exposition,
trace ids, the trace ring, phase spans, build info (torch, CUDA and the
card, never jax), the status listener, and on the replica the
``/3/Stats`` shape, ``/metrics`` covering every ``/3/Stats`` counter and
a request's trace. Tracing has no switch: ``H2O_TPU_TRACE=0`` changes
nothing.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from h2o_kubernetes_tpu_torch import rest
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.runtime import lifecycle, telemetry
from h2o_kubernetes_tpu_torch.runtime.telemetry import (
    ALLOWED_LABELS, MetricsRegistry, build_info, metric_name,
    parse_prometheus_text)


def _drive(tel):
    """One fixed sequence of updates on a fresh registry of ``tel`` (the
    port's telemetry module or the JAX package's); returns its text."""
    r = tel.MetricsRegistry()
    c = r.counter("h2o_req_total", "requests", label="model")
    for i in range(40):                    # past the default top-K (20)
        for _ in range(1 + i % 7):
            c.inc(label_value=f"m{i:02d}")
    r.counter("h2o_plain_total", "plain").inc(3.5)
    r.gauge("h2o_depth", "depth").set(7)
    h = r.histogram("h2o_lat_seconds", "latency", label="phase")
    for v in (0.0004, 0.003, 0.02, 0.2, 3.0, 11.0):
        h.observe(v, label_value="total")
        h.observe(v / 2, label_value="queue")
    r.histogram("h2o_b_seconds", "custom", buckets=(0.5, 0.1)).observe(0.3)
    r.register_group("grp", lambda: {"n": 7, "flag": True, "state": "open",
                                     "nested": {"x": 1.5}, "skip": [1]})
    r.register_group("per_model", lambda: {
        f"t{i:03d}": {"requests": i, "slo": "batch"} for i in range(30)},
        labeled="model")
    return r.prometheus_text({"extra": {"k": 2}})


def test_prometheus_text_equal_in_both_packages():
    from h2o_kubernetes_tpu.runtime import telemetry as jtel

    text = _drive(telemetry)
    assert text == _drive(jtel)
    assert parse_prometheus_text(text) == jtel.parse_prometheus_text(text)
    for parts in (("batcher", "shed"), ("a b", "1x"), ("models",)):
        assert metric_name(*parts) == jtel.metric_name(*parts)
    for hdr in ({"X-H2O-Trace-Id": "ab-C_9"}, {"X-H2O-Trace-Id": "x" * 80}):
        assert telemetry.trace_id_from(hdr) == jtel.trace_id_from(hdr)


def test_label_allowlist_enforced():
    r = MetricsRegistry()
    with pytest.raises(ValueError, match="allowlist"):
        r.counter("h2o_bad_total", "x", label="tenant_name")
    with pytest.raises(ValueError, match="allowlist"):
        r.register_group("g", dict, labeled="tenant_name")
    for lab in ("model", "shard", "phase"):
        assert lab in ALLOWED_LABELS
        r.counter(f"h2o_ok_{lab}_total", "x", label=lab)
    with pytest.raises(ValueError, match="re-registered"):
        r.gauge("h2o_ok_model_total", "x", label="model")


def test_registry_hammer_no_lost_updates():
    r = MetricsRegistry()
    c_plain = r.counter("h2o_plain_total", "")
    c_model = r.counter("h2o_bymodel_total", "", label="model")
    h = r.histogram("h2o_lat_seconds", "", label="phase")
    threads, per = 6, 2000
    errs = []

    def work():
        try:
            for i in range(per):
                c_plain.inc()
                c_model.inc(label_value=f"m{i % 30}")
                h.observe(0.001 * (i % 7), label_value="total")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert c_plain.value() == threads * per
    assert sum(v for _, _, v in c_model.samples()) == threads * per
    assert h.snapshot("total")["count"] == threads * per


def test_model_label_cardinality_bounded():
    r = MetricsRegistry()
    c = r.counter("h2o_req_total", "", label="model")
    k = telemetry._topk()
    for hot in range(5):
        for _ in range(200):
            c.inc(label_value=f"hot{hot}")
    for i in range(1000):
        c.inc(label_value=f"tail{i:04d}")
    assert c.series_count() <= k + 1
    samples = {tuple(sorted(lbl.items())): v for _, lbl, v in c.samples()}
    assert sum(samples.values()) == 5 * 200 + 1000
    for hot in range(5):
        assert (("model", f"hot{hot}"),) in samples
    assert samples.get((("model", "other"),), 0) > 0


def test_histogram_buckets_and_quantile():
    r = MetricsRegistry()
    h = r.histogram("h2o_x_seconds", "", buckets=(0.01, 0.1, 1.0))
    assert h.quantile(0.5) is None
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 5 and snap["buckets"] == {0.01: 1, 0.1: 3,
                                                      1.0: 4}
    assert 0.01 <= h.quantile(0.5) <= 0.1
    p = parse_prometheus_text(r.prometheus_text())
    assert p[("h2o_x_seconds_bucket", (("le", "0.1"),))] == 3
    assert p[("h2o_x_seconds_bucket", (("le", "+Inf"),))] == 5
    assert p[("h2o_x_seconds_count", ())] == 5


def test_groups_exposition_topk_and_idempotence():
    r = MetricsRegistry()
    r.register_group("grp", lambda: {"n": 7, "flag": True,
                                     "state": "open", "nested": {"x": 1.5}})
    data = {f"t{i:04d}": {"requests": i} for i in range(1000)}
    r.register_group("models", lambda: data, labeled="model")
    p = parse_prometheus_text(r.prometheus_text())
    assert p[(metric_name("grp", "n"), ())] == 7
    assert p[(metric_name("grp", "flag"), ())] == 1
    assert p[(metric_name("grp", "state"), (("value", "open"),))] == 1
    assert p[(metric_name("grp", "nested", "x"), ())] == 1.5
    series = [(lbls, v) for (n, lbls), v in p.items()
              if n == metric_name("models", "requests")]
    assert len(series) <= telemetry._topk() + 1
    assert sum(v for _, v in series) == sum(range(1000))
    labels = {dict(lbls)["model"] for lbls, _ in series}
    assert "t0999" in labels and "other" in labels
    r.register_group("grp", lambda: {"v": 2})          # last wins
    assert r.group_snapshot(("grp",)) == {"grp": {"v": 2}}
    r.register_group("boom", lambda: 1 / 0)   # an error marker, no 500
    assert "error" in r.group_snapshot()["boom"]


def test_trace_ids_and_ring(monkeypatch):
    assert telemetry.trace_id_from({"X-H2O-Trace-Id": "ab-C_9"}) == "ab-C_9"
    bad = telemetry.trace_id_from({"X-H2O-Trace-Id": 'x"\r\nSet-Cookie: p'})
    assert bad and all(c.isalnum() or c in "-_" for c in bad)
    assert telemetry.trace_id_from({})
    monkeypatch.setenv("H2O_TPU_TRACE_RING", "16")
    monkeypatch.setenv("H2O_TPU_TRACE", "0")    # no switch: still records
    ring = telemetry.TraceRing()
    for i in range(200):
        ring.record(f"t{i}", [{"name": "total", "ms": 1.0}])
    assert ring.get("t0") is None and ring.get("t199") is not None
    assert len(ring._ring) <= 16
    ring.record("t199", [{"name": "x", "ms": 0.0}] * 400)
    rec = ring.get("t199")
    assert len(rec["spans"]) == ring.MAX_SPANS and rec["truncated"]


def test_trace_ring_records_oldest_first_as_copies():
    ring = telemetry.TraceRing(capacity=3)
    for i in range(5):
        ring.record(f"t{i}", [{"name": "total", "ms": float(i)}],
                    model=f"m{i}")
    recs = ring.records()
    assert [r["trace_id"] for r in recs] == ["t2", "t3", "t4"]
    assert [r["model"] for r in recs] == ["m2", "m3", "m4"]
    recs[0]["spans"].append({"name": "x", "ms": 0.0})
    assert len(ring.get("t2")["spans"]) == 1
    ring.clear()
    assert ring.records() == []


def test_phase_span_feeds_histogram_and_timeline():
    from h2o_kubernetes_tpu_torch.diagnostics import timeline

    hist = telemetry.train_phase_histogram()
    before = hist.snapshot("unit_test_phase")["count"]
    with telemetry.phase_span("unit_test_phase", depth=3):
        time.sleep(0.002)
    assert hist.snapshot("unit_test_phase")["count"] == before + 1
    evs = [e for e in timeline.events("phase")
           if e.get("phase") == "unit_test_phase"]
    assert evs and evs[-1]["dur_ms"] >= 1.0 and evs[-1]["depth"] == 3
    # the timeline's per-kind counts are a stat group
    assert telemetry.group_snapshot(("timeline",))["timeline"]["phase"] >= 1


def test_ooc_stream_account():
    before = telemetry.ooc_overlap_snapshot()
    telemetry.ooc_stream_account(0.5, 1.5, 2.0)
    after = telemetry.ooc_overlap_snapshot()
    assert after["streams"] == before["streams"] + 1
    assert after["upload_s"] == pytest.approx(before["upload_s"] + 0.5)
    assert 0 < after["overlap_ratio"] <= 1
    p = parse_prometheus_text(telemetry.prometheus_text())
    assert p[("h2o_ooc_upload_seconds_total", ())] >= 0.5


def test_build_info_fields():
    import torch

    b = build_info()
    assert b["version"] and b["pid"] and b["uptime_s"] >= 0
    assert b["torch"] == torch.__version__
    assert b["cuda"] == torch.version.cuda
    assert b["device"] == (torch.cuda.get_device_name(0)
                           if torch.cuda.is_available() else "cpu")
    assert not {"jax", "jaxlib", "hostfp"} & set(b)


def test_status_listener_serves_metrics():
    srv = telemetry.start_status_listener(0, extra_groups=lambda: {
        "operator": {"pool": "p", "n": 3}})
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            p = parse_prometheus_text(r.read().decode())
        assert p[(metric_name("operator", "n"), ())] == 3
        assert any(k[0] == "h2o_build_info" for k in p)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            hz = json.loads(r.read())
        assert hz["alive"] and hz["build"]["pid"]
        assert [t for t in threading.enumerate()
                if t.name == "h2o-torch-status"]
    finally:
        srv.shutdown()
        srv.server_close()
    assert telemetry.start_status_listener(None) is None


# ---------------------------------------------------------------------------
# The replica's surface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stats_server():
    import base64

    srv = rest.start_server(port=0, device="cpu")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    blob = random_tree_artifact(61, n_features=4, ntrees=2, max_depth=3)
    req = urllib.request.Request(
        base + "/3/ModelRegistry/load", method="POST",
        data=json.dumps({"model_id": "telem_pm", "warm_buckets": [128],
                         "artifact_b64": base64.b64encode(blob).decode()}
                        ).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
    yield base
    rest.stop_server(srv)
    for store in (rest.MODELS, rest.REGISTRY_MODELS, rest.MODEL_STATS):
        store.pop("telem_pm", None)
    lifecycle.reset()


def _call(base, path, payload=None, headers=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        base + path, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


# the JAX package's golden /3/Stats shape, less its `compiles` section
# and with the port's build keys (README: "Serving replica")
GOLDEN_TOP_KEYS = {
    "ready", "reasons", "state", "healthy", "breaker", "cordoned",
    "drain_budget_s", "identity", "scorer_cache", "batcher", "counters",
    "models", "fairness", "registry", "build"}
GOLDEN_SECTIONS = {
    "counters": {"deadline_504", "scored_while_unready", "rate_limited"},
    "batcher": {"requests", "batches", "batched_rows",
                "max_batch_requests", "shed", "fairness_shed",
                "queue_depth"},
    "scorer_cache": {"hits", "misses", "promotions", "evictions", "models",
                     "resident", "resident_bytes", "budget_bytes",
                     "promotion_s"},
    "breaker": {"state", "consecutive_failures", "cooldown_remaining_s",
                "trips", "short_circuited", "probes", "closes",
                "failures"},
    "build": {"version", "torch", "cuda", "device", "pid", "started_at",
              "uptime_s"},
}


def test_stats_golden_json_shape(stats_server):
    code, body, _ = _call(stats_server, "/3/Stats")
    st = json.loads(body)
    assert code == 200 and set(st) == GOLDEN_TOP_KEYS
    for section, keys in GOLDEN_SECTIONS.items():
        assert set(st[section]) == keys, section


def test_metrics_inventory_covers_stats(stats_server):
    rows = [{f"x{i}": 0.2 for i in range(4)}]
    code, _, _ = _call(stats_server, "/3/Predictions/models/telem_pm",
                       {"rows": rows})
    assert code == 200
    st = json.loads(_call(stats_server, "/3/Stats")[1])
    code, body, hdrs = _call(stats_server, "/metrics")
    assert code == 200 and "text/plain" in hdrs["Content-Type"]
    exposed = parse_prometheus_text(body.decode())
    names = {k[0] for k in exposed}

    def leaves(prefix, obj, out):
        for k, v in obj.items():
            if isinstance(v, (bool, int, float)):
                out.append(prefix + (str(k),))
            elif isinstance(v, dict):
                leaves(prefix + (str(k),), v, out)

    missing = []
    for section, group in (("counters", "counters"), ("batcher", "batcher"),
                           ("scorer_cache", "scorer_cache"),
                           ("breaker", "lifecycle")):
        flat: list = []
        pre = (group, "breaker") if section == "breaker" else (group,)
        leaves(pre, st[section], flat)
        missing += ["/".join(p) for p in flat if metric_name(*p) not in names]
    for mkey, rec in st["models"].items():
        for k, v in rec.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                if (metric_name("models", k), (("model", mkey),)) \
                        not in exposed:
                    missing.append(f"models/{mkey}/{k}")
    assert not missing
    assert "h2o_request_phase_seconds_bucket" in names


def test_request_trace_spans_and_echo(stats_server, monkeypatch):
    monkeypatch.setenv("H2O_TPU_TRACE", "0")      # no switch
    rows = np.round(random_rows(62, 5, 4), 3).tolist()
    body = {"rows": rows, "columns": [f"x{i}" for i in range(4)]}
    tid = "trace-test-0001"
    code, _, hdrs = _call(stats_server, "/3/Predictions/models/telem_pm",
                          body, headers={"X-H2O-Trace-Id": tid})
    assert code == 200
    assert {k.lower(): v for k, v in hdrs.items()}["x-h2o-trace-id"] == tid
    code, raw, _ = _call(stats_server, f"/3/Trace/{tid}")
    tr = json.loads(raw)
    assert code == 200 and tr["model"] == "telem_pm"
    names = [s["name"] for s in tr["spans"]]
    assert names == ["admission", "queue", "assemble", "dispatch", "total"]
    spans = {s["name"]: s["ms"] for s in tr["spans"]}
    assert 0 <= spans["dispatch"] <= spans["total"]
    code, _, hdrs = _call(stats_server, "/3/Predictions/models/telem_pm",
                          body)
    minted = {k.lower(): v for k, v in hdrs.items()}["x-h2o-trace-id"]
    assert code == 200 and minted and minted != tid
    # a request that dies in the queue is traced with its outcome
    code, _, _ = _call(stats_server, "/3/Predictions/models/telem_pm",
                       body, headers={"X-H2O-Trace-Id": "dead-1",
                                      "X-H2O-SLO": "interactive",
                                      "X-H2O-Deadline-Ms": "0.001"})
    assert code == 504
    assert _call(stats_server, "/3/Trace/doesnotexist")[0] == 404
