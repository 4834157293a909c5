"""PyTorch port, runtime and fleet surface: tenant placement, the
sharded pool and the front-door router (``h2o_kubernetes_tpu_torch/
operator/{placement,reconcile,router}.py``) held against the JAX
package's on the same inputs.

Placement and move destinations must be equal on the reference tests'
catalogs and on a seeded 1,000-tenant one; a ``ShardedPool`` over
scripted replicas must derive the same child specs and routing tables
and take the same re-placement, rebalance and failback decisions; the
router must forward, fail over inside its retry budget, serve the typed
503s and forward deadlines and SLO classes, and its ``/3/Stats`` must
have the reference router's key paths. The real-subprocess leg is
``tests/test_torch_fleet.py``."""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import h2o_kubernetes_tpu.operator as jop
import h2o_kubernetes_tpu.operator.router as jrouter
import h2o_kubernetes_tpu_torch.operator as pop
import h2o_kubernetes_tpu_torch.operator.router as prouter
from h2o_kubernetes_tpu_torch.operator.probe import probe_json
from test_torch_operator import FakeReplica  # noqa: E402 — the scripted
# in-process replica (tests/ is pytest-inserted, not a package)

PKGS = {"ref": SimpleNamespace(op=jop, kw={}),
        "port": SimpleNamespace(op=pop, kw={"device": "cpu"})}

KEYS = [f"m{i:03d}" for i in range(1000)]
SHARDS3 = ["p-s0", "p-s1", "p-s2"]
_RNG = np.random.default_rng(14)
# a seeded 1,000-tenant catalog: random key names, a popularity order
SEEDED = [f"tenant-{int(v):08x}" for v in
          _RNG.choice(2 ** 32, size=1000, replace=False)]
SHARDS7 = [f"pool-s{i}" for i in range(7)]


# -- placement -------------------------------------------------------------


def _plan_tuple(plan):
    return (plan.shards, plan.head_keys, plan.assignments,
            {s: plan.keys_for(s) for s in plan.shards})


@pytest.mark.parametrize("keys,shards,head,tail", [
    (KEYS, SHARDS3, 10, 1), (KEYS, SHARDS3, 0, 1), (KEYS, SHARDS3, 10, 2),
    (list(reversed(KEYS)), SHARDS3, 0, 1), (KEYS, SHARDS3[:2], 1, 1),
    (KEYS, SHARDS3 + ["p-s3"], 10, 1), (SEEDED, SHARDS7, 25, 2),
    (SEEDED, SHARDS3, 100, 3), (SEEDED[:120], SHARDS3, 8, 1)])
def test_plan_placement_equals_reference(keys, shards, head, tail):
    port = pop.plan_placement(keys, shards, head=head, tail_replicas=tail)
    ref = jop.plan_placement(keys, shards, head=head, tail_replicas=tail)
    assert _plan_tuple(port) == _plan_tuple(ref)
    for k in keys[:50]:
        assert pop.shard_preference(k, shards) == \
            jop.shard_preference(k, shards)
    # the head on every shard, the tail on ``tail`` shards
    for k in keys[:head]:
        assert set(port.assignments[k]) == set(shards)
    for k in keys[head:]:
        assert len(port.assignments[k]) == min(tail, len(shards))


def test_placement_stability_and_validation():
    a = pop.plan_placement(KEYS, SHARDS3, head=10)
    b = pop.plan_placement(KEYS, SHARDS3 + ["p-s3"], head=10)
    moved = sum(1 for k in KEYS[10:]
                if a.assignments[k] != b.assignments[k])
    assert moved < 0.4 * len(KEYS[10:])        # ~1/4, never a reshuffle
    for args, msg in ((([], ), "at least one shard"),
                      ((["a", "a"],), "duplicate shard")):
        with pytest.raises(ValueError, match=msg):
            pop.plan_placement(KEYS, *args)
    with pytest.raises(ValueError, match="duplicate model keys"):
        pop.plan_placement(["k", "k"], SHARDS3)


@pytest.mark.parametrize("seed", range(4))
def test_move_destination_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for key in rng.choice(SEEDED, size=50, replace=False):
        ex = list(rng.choice(SHARDS7, size=int(rng.integers(0, 7)),
                             replace=False))
        healthy = {s: bool(rng.random() < 0.7) for s in SHARDS7}
        for h in (None, healthy):
            assert pop.move_destination(key, SHARDS7, exclude=ex,
                                        healthy=h) == \
                jop.move_destination(key, SHARDS7, exclude=ex, healthy=h)


# -- the sharded pool: same decisions as the reference --------------------


class StubRegistry:
    """Records targeted pushes instead of HTTP."""

    def __init__(self, fail: int = 0):
        self.pushes = []
        self._fail = fail

    def push(self, url, name, version, model_key, warm_buckets=None,
             timeout=300.0, inline=None, slo=None):
        if self._fail > 0:
            self._fail -= 1
            raise IOError("stub push failure")
        self.pushes.append((url, name, int(version), model_key, slo))
        return {"model_id": {"name": model_key}}


def _sharded(ns, shards=2, tenants=8, registry=None, **spec_kw):
    store = ns.op.PoolStore()
    extra = tuple((f"a{i}", 1, f"t{i}") for i in range(1, tenants + 1))
    store.apply(ns.op.ScorerPoolSpec(
        name="p", artifact="a0", version=1, model_key="m", replicas=1,
        shards=shards, head_models=1, extra_artifacts=extra, **spec_kw))
    pool = ns.op.ShardedPool(store, registry or StubRegistry(), "p",
                             replica_factory=FakeReplica, **ns.kw)
    return store, pool


def _settle(pool, passes=40):
    for _ in range(passes):
        pool.reconcile_once()
        if pool.converged():
            return True
    return pool.converged()


def _tables(store, pool):
    children = {sid: store.get(sid)[0] for sid in sorted(pool.recs)}
    return ({sid: (s.artifact, s.model_key, s.extra_artifacts,
                   s.replicas) for sid, s in children.items()},
            pool.routing_table()["keys"],
            {sid: sorted(rec.autoscale_keys)
             for sid, rec in pool.recs.items()})


def _child_specs(ns):
    store, pool = _sharded(ns, shards=3, tenants=30)
    before = _tables(store, pool)
    assert _settle(pool)
    t = pool.routing_table()
    assert set(t["keys"]) == {"m"} | {f"t{i}" for i in range(1, 31)}
    assert all(t["shards"][s] for s in pool.recs)
    return before, _tables(store, pool), store.get_status("p")["converged"]


def _shard_death(ns):
    reg = StubRegistry(fail=1)
    store, pool = _sharded(ns, shards=3, tenants=12, registry=reg)
    assert _settle(pool)
    dead = "p-s0"
    orphans = set(pool.plan.keys_for(dead)) - {"m"}
    for r in pool.recs[dead].replicas:
        r._alive = False
    pending = sorted(pool.pending_orphans())
    moved = pool._replace_once() + pool._replace_once()
    assert moved == len(orphans) and pool.pending_orphans() == []
    mid = (pending, moved, sorted(p[3] for p in reg.pushes),
           dict(pool.overrides), _tables(store, pool))
    assert _settle(pool, passes=60)
    kinds = [e["kind"] for e in store.events("p")]
    assert {"shard_down", "tenant_replace_failed", "shard_recovered"} \
        <= set(kinds)
    return mid, kinds


def _rebalance(ns):
    reg = StubRegistry()
    store, pool = _sharded(ns, shards=3, tenants=9, registry=reg)
    assert _settle(pool)
    hot = next(k for k in sorted(pool.plan.assignments)
               if k != "m" and len(pool.plan.assignments[k]) == 1)
    src = pool.plan.assignments[hot][0]
    for total in (5, 11, 19):
        for r in pool.recs[src].replicas:
            r.stats_payload = {"models": {hot: {"shed": total,
                                                "deadline_504": 0}}}
        pool._rebalance_once()
    mv = {k: {f: v[f] for f in ("src", "dst", "state")}
          for k, v in pool.moves.items()}
    serving = pool.routing_table()["keys"][hot]
    assert mv[hot]["state"] == "serving" and src in serving
    retired = pool._retire_moves()
    return mv, serving, retired, _tables(store, pool)


def _failback(ns):
    store, pool = _sharded(ns, shards=2, tenants=6)
    assert _settle(pool)
    for r in pool.recs["p-s0"].replicas:
        r._alive = False
    n = pool._replace_once()
    assert _settle(pool, passes=60)
    back = pool._failback_once()
    assert pool.overrides == {}
    return n, back, _tables(store, pool)


@pytest.mark.parametrize("scenario", [
    _child_specs, _shard_death, _rebalance, _failback],
    ids=lambda f: f.__name__.strip("_"))
def test_sharded_pool_equals_reference(scenario, monkeypatch):
    monkeypatch.setenv("H2O_TPU_POOL_DEREGISTER_GRACE", "0")
    monkeypatch.setenv("H2O_TPU_REBALANCE", "1")
    monkeypatch.setenv("H2O_TPU_REBALANCE_SUSTAIN", "3")
    monkeypatch.setenv("H2O_TPU_REBALANCE_COOLDOWN", "0")
    monkeypatch.setenv("H2O_TPU_REBALANCE_RETIRE_S", "0")
    monkeypatch.setenv("H2O_TPU_REBALANCE_FAILBACK_S", "0")
    assert scenario(PKGS["port"]) == scenario(PKGS["ref"])


def test_replacement_state_survives_controller_restart():
    reg = StubRegistry()
    store, pool = _sharded(PKGS["port"], shards=2, tenants=6, registry=reg)
    assert _settle(pool)
    orphans = set(pool.plan.keys_for("p-s0")) - {"m"}
    for r in pool.recs["p-s0"].replicas:
        r._alive = False
    pool._replace_once()
    pool._publish_status()
    pool2 = pop.ShardedPool(store, reg, "p", replica_factory=FakeReplica,
                            device="cpu")
    assert pool2.overrides == {k: ("p-s1",) for k in orphans}
    assert pool2._ever_healthy == {"p-s0", "p-s1"}
    assert pool2.pending_orphans() == []


def test_store_routing_table_and_deposed_controller(monkeypatch):
    import time

    monkeypatch.setenv("H2O_TPU_ROUTER_TABLE_INTERVAL", "0")
    reg = StubRegistry()
    store, pool = _sharded(PKGS["port"], shards=2, tenants=4, registry=reg)
    p1 = pop.StoreRoutingTable(store, "p")
    assert p1().get("cold") and p1.generation == 0
    assert _settle(pool)
    assert store.acquire_lease("p", "op-a", ttl=0.05) == 1
    pool.lease_epoch = 1
    pool._publish_routing()
    g1 = p1()["table_generation"]
    assert g1 >= 1 and pop.StoreRoutingTable(store, "p")() == p1()
    time.sleep(0.08)
    assert store.acquire_lease("p", "op-b", ttl=30.0) == 2
    pool._publish_routing()
    assert pool.deposed and p1()["table_generation"] == g1
    with pytest.raises(pop.StaleGenerationError):
        store.publish_routing("p", {"keys": {}, "shards": {}}, epoch=1)


# -- the router over stub replicas ------------------------------------------


class _StubReplica:
    """A minimal replica: /3/Stats says ready, POST scripted."""

    def __init__(self, on_post=None, ready=True, name="stub"):
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, payload, hdrs=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (hdrs or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._send(200, {"ready": stub.ready, "name": stub.name})

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                req = self.rfile.read(n) if n else b""
                self._send(*stub.on_post(self.path, req, dict(self.headers)))

        self.ready, self.name, self.posts = ready, name, []
        self._on_post = on_post
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def on_post(self, path, body, headers):
        self.posts.append((path, body, headers))
        if self._on_post is not None:
            return self._on_post(path, body, headers)
        return 200, {"predict": ["ok"], "served_by": self.name}, None

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _post(url, payload=None, headers=None, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload or {"rows": [[1.0]]}).encode(),
        method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.fixture
def fleet(monkeypatch):
    """Stub replicas and port routers, all stopped at teardown."""
    monkeypatch.setenv("H2O_TPU_ROUTER_HEALTH_INTERVAL", "30")
    made = {"stubs": [], "routers": []}

    def stub(**kw):
        s = _StubReplica(**kw)
        made["stubs"].append(s)
        return s

    def router(table, mod=prouter):
        srv, r = mod.start_router(table)
        made["routers"].append((srv, r))
        return srv, r, f"http://127.0.0.1:{srv.server_address[1]}"

    yield SimpleNamespace(stub=stub, router=router)
    for srv, r in made["routers"]:
        r.stop()
        srv.shutdown()
        srv.server_close()
    for s in made["stubs"]:
        try:
            s.close()
        except OSError:
            pass


def test_router_forwards_fails_over_and_relays(fleet):
    a = fleet.stub(name="a", on_post=lambda *x: (500, {"msg": "boom"}, None))
    b = fleet.stub(name="b")
    c = fleet.stub(name="c", on_post=lambda *x: (
        429, {"msg": "rate limited"}, {"Retry-After": "7"}))
    table = {"keys": {"pm": ["s0", "s1"], "tail": ["s1"], "rl": ["s2", "s1"]},
             "shards": {"s0": [a.url], "s1": [b.url], "s2": [c.url]}}
    _, router, url = fleet.router(table)
    code, out, _ = _post(url + "/3/Predictions/models/pm")
    assert code == 200 and out["served_by"] == "b"
    st = router.snapshot()
    assert st["stats"]["retries"] == st["retry_budget"]["granted"] == 1
    assert st["stats"]["relayed_5xx"] == 1
    code, out, _ = _post(url + "/3/Predictions/models/tail/contributions")
    assert code == 200 and b.posts[-1][0].endswith("/tail/contributions")
    # a tenant's own 429 is relayed, never retried on another shard
    n_b = len(b.posts)
    code, _, hdrs = _post(url + "/3/Predictions/models/rl")
    assert code == 429 and hdrs.get("Retry-After") == "7"
    assert len(b.posts) == n_b


def test_router_retry_budget_denied(fleet, monkeypatch):
    monkeypatch.setenv("H2O_TPU_ROUTER_RETRY_BUDGET", "0")
    a = fleet.stub(name="a", on_post=lambda *x: (502, {"msg": "x"}, None))
    b = fleet.stub(name="b")
    _, router, url = fleet.router(
        {"keys": {"pm": ["s0", "s1"]},
         "shards": {"s0": [a.url], "s1": [b.url]}})
    assert _post(url + "/3/Predictions/models/pm")[0] == 502
    st = router.snapshot()
    assert st["stats"]["retries"] == 0 and st["stats"]["retry_denied"] == 1
    assert not b.posts


def test_router_typed_503s_deadline_and_slo(fleet, monkeypatch):
    monkeypatch.setenv("H2O_TPU_ROUTER_TABLE_INTERVAL", "0")
    seen = {}

    def a_post(path, body, headers):
        seen.update({k.lower(): v for k, v in headers.items()})
        return 200, {"predict": ["ok"], "served_by": "a"}, None

    a = fleet.stub(name="a", on_post=a_post)
    lonely = fleet.stub(name="l")
    store = pop.PoolStore()
    _, router, url = fleet.router(pop.StoreRoutingTable(store, "p"))
    code, out, hdrs = _post(url + "/3/Predictions/models/pm")
    assert code == 503 and out["hint"] == "table_pending"
    store.publish_routing("p", {"keys": {"pm": ["s0"], "lonely": ["s1"]},
                                "shards": {"s0": [a.url],
                                           "s1": [lonely.url]}})
    lonely.close()
    router.sweep_health()
    code, out, hdrs = _post(url + "/3/Predictions/models/lonely")
    assert code == 503 and out["hint"] == "placement_pending"
    assert "Retry-After" in hdrs
    assert _post(url + "/3/Predictions/models/nope")[0] == 404
    assert _post(url + "/3/Predictions/models/pm",
                 headers={"X-H2O-Deadline-Ms": "-1"})[0] == 504
    code, _, _ = _post(url + "/3/Predictions/models/pm",
                       headers={"X-H2O-Deadline-Ms": "5000",
                                "X-H2O-SLO": "interactive"})
    assert code == 200
    assert 0 < float(seen["x-h2o-deadline-ms"]) <= 5000
    assert seen["x-h2o-slo"] == "interactive"
    assert _post(url + "/3/Predictions/models/pm",
                 headers={"X-H2O-Deadline-Ms": "soon"})[0] == 400
    assert probe_json(url, "/readyz", retries=1)["ready"] is True


def _key_paths(obj, prefix=()):
    out = set()
    for k, v in obj.items():
        out.add(prefix + (k,))
        if isinstance(v, dict) and prefix[:1] not in (
                ("by_model",), ("by_shard",), ("shards",)):
            out |= _key_paths(v, prefix + (k,))
    return out


# the build block names each package's framework (README: "The fleet")
_PORT_ONLY = {("build", "torch"), ("build", "cuda"), ("build", "device")}
_REF_ONLY = {("build", "jax"), ("build", "jaxlib"), ("build", "hostfp")}


def test_router_stats_keys_equal_reference(fleet):
    """The same traffic through a port router and a reference router
    over the same stub shards: equal ``/3/Stats`` key paths up to the
    stated build keys, equal counters, and both routers' ``/metrics``
    carry the router series."""
    a = fleet.stub(name="a", on_post=lambda *x: (503, {"msg": "d"},
                                                 {"Retry-After": "1"}))
    b = fleet.stub(name="b")
    table = {"keys": {"pm": ["s0", "s1"], "t": ["s1"]},
             "shards": {"s0": [a.url], "s1": [b.url]}}
    snaps = []
    for mod in (prouter, jrouter):
        _, router, url = fleet.router(dict(table), mod)
        for key in ("pm", "t", "pm"):
            assert _post(url + f"/3/Predictions/models/{key}")[0] == 200
        with urllib.request.urlopen(url + "/3/Stats", timeout=10) as r:
            snaps.append(json.loads(r.read()))
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert b"h2o_stats_router_stats_forwarded" in r.read()
    port, ref = snaps
    pk, rk = _key_paths(port), _key_paths(ref)
    assert pk - rk == _PORT_ONLY and rk - pk == _REF_ONLY
    assert port["stats"] == ref["stats"]
    assert port["by_model"] == ref["by_model"]


def test_router_logs_a_slow_route_with_its_attempts(fleet, monkeypatch,
                                                     caplog):
    """A route slower than ``_SLOW_ROUTE_S`` is logged with its dispatch
    attempts (shard, url, outcome, ms, and a transport error's text,
    which the trace keeps too), so the hop that held a request is
    named. Here: a replica that died after the health sweep, then its
    survivor."""
    import logging

    from h2o_kubernetes_tpu_torch.runtime import telemetry as ptel

    monkeypatch.setattr(prouter, "_SLOW_ROUTE_S", 0.0)
    a = fleet.stub(name="a")
    b = fleet.stub(name="b")
    table = {"keys": {"pm": ["s0", "s1"]},
             "shards": {"s0": [a.url], "s1": [b.url]}}
    _, router, url = fleet.router(table)
    a.close()
    with caplog.at_level(logging.WARNING, logger="h2o_kubernetes_tpu_torch"):
        code, out, hdrs = _post(url + "/3/Predictions/models/pm")
    assert code == 200 and out["served_by"] == "b"
    slow = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("slow route")]
    assert len(slow) == 1 and "tenant pm answered 200" in slow[0]
    assert a.url in slow[0] and b.url in slow[0]
    rec = ptel.TRACER.get(hdrs["X-H2O-Trace-Id"])
    disp = [s for s in rec["spans"] if s["name"] == "dispatch"]
    assert [s["outcome"] for s in disp] == ["transport_error", "forwarded"]
    assert "refused" in disp[0]["error"].lower()


def test_router_fails_over_a_connect_that_never_completes(fleet,
                                                          monkeypatch):
    """A forward's connect is capped by the probe timeout, its reads by
    the forward timeout: a replica whose address stops answering
    connects after the health sweep (a listener that takes no more, as a
    just-killed pod's address behaved on an H100 host) costs the probe
    timeout, then the request fails over, well inside the forward
    timeout that capped it before."""
    import socket
    import time

    from h2o_kubernetes_tpu_torch.runtime import telemetry as ptel

    monkeypatch.setenv("H2O_TPU_POOL_PROBE_TIMEOUT", "0.5")
    monkeypatch.setenv("H2O_TPU_ROUTER_TIMEOUT", "10")
    a = fleet.stub(name="a")
    b = fleet.stub(name="b")
    table = {"keys": {"pm": ["s0", "s1"]},
             "shards": {"s0": [a.url], "s1": [b.url]}}
    _, router, url = fleet.router(table)
    port = a.srv.server_address[1]
    a.close()
    hole = socket.socket()
    hole.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    hole.bind(("127.0.0.1", port))
    hole.listen(0)
    fill = []
    try:
        # fill the accept queue: the kernel drops every later connect
        while True:
            c = socket.socket()
            fill.append(c)
            c.settimeout(0.3)
            try:
                c.connect(("127.0.0.1", port))
            except OSError:
                break
        t0 = time.monotonic()
        code, out, hdrs = _post(url + "/3/Predictions/models/pm")
        took = time.monotonic() - t0
    finally:
        for c in fill:
            c.close()
        hole.close()
    assert code == 200 and out["served_by"] == "b"
    assert took < 3.0
    rec = ptel.TRACER.get(hdrs["X-H2O-Trace-Id"])
    disp = [s for s in rec["spans"] if s["name"] == "dispatch"]
    assert [s["outcome"] for s in disp] == ["transport_error", "forwarded"]
    assert "timed out" in disp[0]["error"] and disp[0]["ms"] < 2000


@pytest.mark.parametrize("total_s,logged", [(2.0, True), (0.5, False)])
def test_replica_logs_a_slow_request_with_its_spans(monkeypatch, caplog,
                                                    total_s, logged):
    """A replica's request slower than ``_SLOW_REQUEST_S`` is logged with
    its phase spans and trace id; a faster one is not."""
    import logging

    from h2o_kubernetes_tpu_torch.runtime import telemetry as ptel

    monkeypatch.setattr(ptel, "_SLOW_REQUEST_S", 1.0)
    marks = {"admit": 10.0, "enqueue": 10.1, "pop": 10.0 + total_s - 0.4,
             "dispatch_start": 10.0 + total_s - 0.3,
             "dispatch_end": 10.0 + total_s - 0.1}
    with caplog.at_level(logging.WARNING, logger="h2o_kubernetes_tpu_torch"):
        spans = ptel.record_request_phases(
            "slow-tid", marks, 10.0, 10.0 + total_s, model="m",
            kind="score")
    slow = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("slow request")]
    assert len(slow) == int(logged)
    if logged:
        assert slow[0].startswith(
            "slow request: model m (score) answered after 2.0 s")
        assert str(spans) in slow[0] and "slow-tid" in slow[0]


@pytest.mark.parametrize("topk", [1, 3, 20])
def test_capped_label_counter_counts_a_pruned_newcomer(monkeypatch, topk):
    """A label value new to a capped counter whose traffic map is full
    is counted (into ``other``). The reference's ``_series_for`` prunes
    the coldest ranks — the newcomer's own among them — and then reads
    it (KeyError): its router answered such a tenant's request with a
    500 under a many-tenant storm (the router-shard-kill drill, 1,000
    tenants, on the card and here)."""
    import h2o_kubernetes_tpu.runtime.telemetry as jtel
    import h2o_kubernetes_tpu_torch.runtime.telemetry as ptel

    monkeypatch.setenv("H2O_TPU_METRICS_TOPK", str(topk))
    # 8K values seen twice fill the traffic map; then a newcomer
    warm = [f"m{i:04d}" for i in range(8 * topk) for _ in range(2)]
    ref = jtel.Counter("h2o_test_total", "", "model", threading.Lock())
    port = ptel.Counter("h2o_test_total", "", "model", threading.Lock())
    for v in warm:
        ref.inc(label_value=v)
        port.inc(label_value=v)
    with pytest.raises(KeyError):
        ref.inc(label_value="newcomer")
    port.inc(label_value="newcomer")
    total = sum(v for _, _, v in port.samples())
    assert total == len(warm) + 1
    assert port.value("other") >= 1


@pytest.mark.parametrize("server", ["pod", "router"])
def test_listen_backlog_holds_a_burst_of_connects(server):
    """A pod's REST server and the router queue a burst of connects that
    their accept loop has not reached yet. With socketserver's backlog
    of 5 the kernel drops the seventh and later connects, and a dropped
    connect's resends back off to tens of seconds: a forward outlived
    the client's 30 s while a busy pod on the card was re-placed onto."""
    import socket

    import h2o_kubernetes_tpu_torch.rest as prest

    if server == "pod":
        srv = prest._Server(("127.0.0.1", 0), BaseHTTPRequestHandler, "cpu")
    else:
        srv = prouter._RouterServer(("127.0.0.1", 0),
                                    BaseHTTPRequestHandler)
    socks = []
    try:
        # the accept loop never runs: every connect waits in the queue
        for _ in range(32):
            s = socket.socket()
            socks.append(s)
            s.settimeout(0.5)
            s.connect(srv.server_address)
    finally:
        for s in socks:
            s.close()
        srv.server_close()
