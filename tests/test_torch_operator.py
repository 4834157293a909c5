"""PyTorch port, runtime and fleet surface: the operator's control
plane (``h2o_kubernetes_tpu_torch/operator/``: spec, durable store,
reconcile loop, autoscale signal, adoption, crash-loop backoff and
rollback) held against the JAX package's operator on the same inputs.

Pure orchestration with scripted in-process replicas, as the JAX
package's ``tests/test_operator.py`` drives it: each scenario runs on
both packages' ``Reconciler`` and must give the port's contract AND the
same event sequence as the reference. The real-subprocess legs are
``tests/test_torch_fleet.py`` and ``tools/torch_chaos.py``."""

import json
import os
import threading
import time
from types import SimpleNamespace

import pytest

import h2o_kubernetes_tpu.operator as jop
import h2o_kubernetes_tpu.operator.autoscale as jautoscale
import h2o_kubernetes_tpu.operator.reconcile as jreconcile
import h2o_kubernetes_tpu_torch.operator as pop
import h2o_kubernetes_tpu_torch.operator.autoscale as pautoscale
import h2o_kubernetes_tpu_torch.operator.reconcile as preconcile
from h2o_kubernetes_tpu_torch import persist as ppersist

STARTING, LOADING, READY = "STARTING", "LOADING", "READY"
CORDONED, DRAINING, DEAD = "CORDONED", "DRAINING", "DEAD"

PKGS = {
    "ref": SimpleNamespace(op=jop, rc=jreconcile, autoscale=jautoscale,
                           kw={}),
    "port": SimpleNamespace(op=pop, rc=preconcile, autoscale=pautoscale,
                            kw={"device": "cpu"}),
}


def test_state_names_equal_reference():
    for name in ("PENDING", STARTING, LOADING, READY, CORDONED, DRAINING,
                 DEAD, "CAPACITY_STATES"):
        assert getattr(preconcile, name) == getattr(jreconcile, name)


class FakeReplica:
    """Scripted in-process stand-in for ScorerReplica (the reference
    test's): healthy one tick after spawn, loaded and ready one tick
    after the push, dies on terminate/kill."""

    def __init__(self, rid, version, spec):
        self.rid = rid
        self.version = int(version)
        self.model_key = spec.model_key
        self.artifact = spec.artifact
        self.warm_buckets = None if spec.warm_buckets is None \
            else tuple(spec.warm_buckets)
        self.port = 0
        self.state = "PENDING"
        self.created_at = 0.0
        self.cordoned_at = 0.0
        self.drain_at = 0.0
        self._alive = False
        self._loaded = False
        self._load_done = False
        self.stats_payload = None

    @property
    def url(self):
        return f"fake://{self.rid}"

    def spawn(self):
        self._alive = True
        self.state = STARTING
        self.created_at = time.monotonic()

    def alive(self):
        return self._alive

    def pid(self):
        return None

    def mark_dead(self):
        self.state = DEAD

    def healthz_ok(self):
        return self._alive

    def readyz_ok(self):
        return self._alive and self._loaded

    def stats(self):
        return self.stats_payload

    def loaded_version(self):
        return self.version if self._loaded else None

    def start_load(self, registry):
        self.state = LOADING
        self._loaded = True
        self._load_done = True

    def load_finished(self):
        return self._load_done

    def load_error(self):
        return None

    def cordon(self):
        self.state = CORDONED
        self.cordoned_at = time.monotonic()

    def terminate(self):
        self.state = DRAINING
        self.drain_at = time.monotonic()
        self._alive = False           # fake drains instantly

    def kill(self):
        self._alive = False


class CrashingReplica(FakeReplica):
    def spawn(self):
        super().spawn()
        self._alive = False


class V2FailsReplica(FakeReplica):
    def start_load(self, registry):
        if self.version == 2:
            self.state = LOADING
            self._load_done = True
        else:
            super().start_load(registry)

    def load_error(self):
        return "boom: poison artifact" if self.version == 2 else None


class NeverHealthy(FakeReplica):
    def healthz_ok(self):
        return False


def _settle(rec, passes=30):
    for _ in range(passes):
        rec.reconcile_once()
        if rec.converged():
            return True
    return rec.converged()


def _pool(ns, factory=FakeReplica, replicas=2, **spec_kw):
    store = ns.op.PoolStore()
    store.apply(ns.op.ScorerPoolSpec(name="p", artifact="a", version=1,
                                     model_key="m", replicas=replicas,
                                     **spec_kw))
    rec = ns.op.Reconciler(store, registry=None, pool="p",
                           replica_factory=factory, **ns.kw)
    return store, rec


def _kinds(store):
    return [e["kind"] for e in store.events("p")]


# -- reconcile scenarios: the port's contract, the reference's events ----


def _converge_and_replace(ns):
    store, rec = _pool(ns)
    assert _settle(rec)
    assert [r.state for r in rec.replicas] == [READY, READY]
    rec.replicas[0]._alive = False
    assert not rec.converged()
    assert _settle(rec)
    kinds = _kinds(store)
    died = kinds.index("replica_died")
    assert {"replica_start", "replica_ready"} <= set(kinds[died:])
    return kinds


def _resize(ns):
    store, rec = _pool(ns, replicas=1, max_replicas=8)
    assert _settle(rec)
    store.apply_update("p", replicas=3)
    assert _settle(rec)
    assert sum(1 for r in rec.replicas if r.state == READY) == 3
    store.apply_update("p", replicas=1)
    assert _settle(rec)
    assert sum(1 for r in rec.replicas if r.state == READY) == 1
    assert "replica_cordon" in _kinds(store)
    return _kinds(store)


def _rolling_update(ns):
    store, rec = _pool(ns)
    assert _settle(rec)
    store.apply_update("p", version=2)
    min_ready, max_capacity = 99, 0
    for _ in range(40):
        rec.reconcile_once()
        live = [r for r in rec.replicas if r.state != DEAD]
        min_ready = min(min_ready, sum(
            1 for r in live if r.state == READY and r.alive()))
        max_capacity = max(max_capacity, sum(
            1 for r in live if r.state in (STARTING, LOADING, READY)))
        if rec.converged():
            break
    assert rec.converged() and min_ready >= 2 and max_capacity <= 3
    assert all(r.version == 2 for r in rec.replicas)
    kinds = _kinds(store)
    assert kinds.index("replica_cordon") > kinds.index("replica_ready")
    return kinds


def _startup_timeout(ns):
    made = []

    def factory(rid, version, spec):
        r = (NeverHealthy if not made else FakeReplica)(rid, version, spec)
        made.append(r)
        return r

    store, rec = _pool(ns, factory=factory, replicas=1)
    rec.reconcile_once()
    time.sleep(1.1)
    assert _settle(rec)
    assert "replica_startup_timeout" in _kinds(store)
    assert made[0].state == DEAD and len(made) == 2
    return _kinds(store)


def _rollback(ns):
    store, rec = _pool(ns, factory=V2FailsReplica)
    assert _settle(rec)
    old = sorted(r.rid for r in rec.replicas)
    store.apply_update("p", version=2)
    assert _settle(rec, passes=80)
    kinds = _kinds(store)
    assert "rollout_rolled_back" in kinds and "replica_cordon" not in kinds
    assert kinds.count("replica_load_failed") == 3
    st = store.get_status("p")
    assert st["rollout"] == {"failed_version": 2, "pinned_version": 1,
                             "state": "rolled_back"}
    assert sorted(r.rid for r in rec.replicas) == old
    store.apply_update("p", version=3)
    assert _settle(rec, passes=80)
    assert all(r.version == 3 for r in rec.replicas)
    return _kinds(store)


@pytest.mark.parametrize("scenario", [
    _converge_and_replace, _resize, _rolling_update, _startup_timeout,
    _rollback], ids=lambda f: f.__name__.strip("_"))
def test_reconcile_scenario_equals_reference(scenario, monkeypatch):
    monkeypatch.setenv("H2O_TPU_POOL_DEREGISTER_GRACE", "0")
    monkeypatch.setenv("H2O_TPU_POOL_STARTUP_DEADLINE", "1")
    monkeypatch.setenv("H2O_TPU_POOL_BACKOFF_BASE", "0")
    monkeypatch.setenv("H2O_TPU_POOL_ROLLOUT_RETRIES", "3")
    assert scenario(PKGS["port"]) == scenario(PKGS["ref"])


def test_crash_loop_backoff_spacing(monkeypatch):
    monkeypatch.setenv("H2O_TPU_POOL_BACKOFF_BASE", "0.15")
    monkeypatch.setenv("H2O_TPU_POOL_BACKOFF_MAX", "5")
    store, rec = _pool(PKGS["port"], factory=CrashingReplica, replicas=1)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 2.0:
        rec.reconcile_once()
        time.sleep(0.01)
    starts = [e["t"] for e in store.events("p")
              if e["kind"] == "replica_start"]
    assert "crash_loop_backoff" in _kinds(store)
    assert 4 <= len(starts) <= 8
    gaps = [b - a for a, b in zip(starts, starts[1:])]
    assert gaps[1] >= 0.15 - 0.02 and gaps[2] >= 0.30 - 0.02, gaps
    assert store.get_status("p")["crash_loop"]["version"] == 1


# -- autoscale: the same decisions on the same /3/Stats samples ----------


def _stats(depth=0, shed=0, d504=0, requests=0, models=None):
    out = {"batcher": {"queue_depth": depth, "shed": shed,
                       "requests": requests},
           "counters": {"deadline_504": d504}}
    if models is not None:
        out["models"] = models
    return out


_AUTOSCALE_CASES = [
    # (spec kwargs, previous sample(s) or None, sample(s), model_keys)
    ({}, None, [_stats(depth=10), _stats(depth=8)], None),
    ({}, [_stats(shed=5)], [_stats(shed=7)], None),
    ({}, [_stats(d504=1)], [_stats(d504=3)], None),
    ({"replicas": 4, "max_replicas": 4}, None, [_stats(depth=99)], None),
    ({}, [_stats(requests=100)], [_stats(requests=100)], None),
    ({}, [_stats(requests=100)], [_stats(requests=150)], None),
    ({}, [_stats(requests=1000)], [_stats(requests=50)], None),
    ({}, None, [], None),
    ({"replicas": 1}, [_stats()], [_stats()], None),
    ({}, [_stats(shed=9, requests=500, models={
        "t1": {"shed": 9, "deadline_504": 0, "requests": 400},
        "t2": {"shed": 0, "deadline_504": 0, "requests": 100}})],
     [_stats(shed=12, requests=600, models={
         "t1": {"shed": 12, "deadline_504": 0, "requests": 450},
         "t2": {"shed": 0, "deadline_504": 0, "requests": 100}})],
     {"t1"}),
    ({}, [_stats(shed=9, requests=500, models={
        "t1": {"shed": 9, "deadline_504": 0, "requests": 400},
        "t2": {"shed": 0, "deadline_504": 0, "requests": 100}})],
     [_stats(shed=12, requests=600, models={
         "t1": {"shed": 12, "deadline_504": 0, "requests": 450},
         "t2": {"shed": 0, "deadline_504": 0, "requests": 100}})],
     {"t2"}),
]


@pytest.mark.parametrize("case", range(len(_AUTOSCALE_CASES)))
def test_desired_replicas_equal_reference(case):
    kw, prev_s, now_s, keys = _AUTOSCALE_CASES[case]
    outs = []
    for ns in (PKGS["port"], PKGS["ref"]):
        spec = ns.op.ScorerPoolSpec(**{
            "name": "p", "artifact": "a", "version": 1, "model_key": "m",
            "replicas": 2, "min_replicas": 1, "max_replicas": 4, **kw})
        mk = {} if keys is None else {"model_keys": keys}
        prev = None if prev_s is None else \
            ns.autoscale.desired_replicas(spec, prev_s, **mk)[2]
        outs.append(ns.autoscale.desired_replicas(spec, now_s, prev, **mk))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("keys", [None, {"t1"}, {"t2", "t3"}])
def test_pressure_by_model_equal_reference(keys):
    samples = [
        {"models": {"t1": {"shed": 3, "deadline_504": 2},
                    "t2": {"shed": 0, "deadline_504": 0}}},
        {"models": {"t1": {"shed": 1}, "t3": {"deadline_504": 5}}},
    ]
    got = pautoscale.pressure_by_model(samples, keys)
    assert got == jautoscale.pressure_by_model(samples, keys)
    if keys is None:
        assert got == {"t1": 6, "t2": 0, "t3": 5}


# -- durable store: round trips, fencing, leases, both ways ---------------


def _spec(ns, **kw):
    return ns.op.ScorerPoolSpec(**{
        "name": "p", "artifact": "a", "version": 3, "model_key": "m",
        "replicas": 2, "warm_buckets": (128,),
        "extra_artifacts": (("a2", 1, "m2", "batch"),), "env": {"K": "V"},
        "shards": 2, "head_models": 1, **kw})


@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_store_json_readable_both_ways(tmp_path, writer, reader):
    """Specs, status, events and routing tables one package's
    DurablePoolStore writes are read back intact by the other's."""
    w, r = PKGS[writer], PKGS[reader]
    root = str(tmp_path / "store")
    a = w.op.DurablePoolStore(root)
    a.apply(_spec(w))
    gen = a.apply_update("p", replicas=3)
    a.set_status("p", {"converged": False, "ready": 1}, fence=gen)
    a.record_event("p", "replica_start", "p-1 v3")
    assert a.publish_routing("p", {"keys": {"m": ["s0", "s1"]},
                                   "shards": {"s0": ["u0"]}}) == 1
    b = r.op.DurablePoolStore(root)
    spec, g = b.get("p")
    assert g == gen == 2 and spec == _spec(r, replicas=3)
    assert b.get_status("p") == {"converged": False, "ready": 1}
    assert [e["kind"] for e in b.events("p")] == ["replica_start"]
    assert b.get_routing("p")["keys"] == {"m": ["s0", "s1"]}
    # the files are the same bytes the reader's own store would write
    for name in os.listdir(root):
        assert json.loads(open(os.path.join(root, name)).read())
    b.apply_update("p", version=4)
    assert a.get("p")[0].version == 4


def test_durable_store_fencing_and_ring(tmp_path):
    store = pop.DurablePoolStore(str(tmp_path / "store"))
    spec = pop.ScorerPoolSpec(name="p", artifact="a", version=1,
                              model_key="m")
    g1 = store.apply(spec)
    g2 = store.apply_update("p", replicas=2)
    for call in (lambda: store.apply(spec, fence=g1),
                 lambda: store.apply_update("p", fence=g1, replicas=9),
                 lambda: store.set_status("p", {"x": 1}, fence=g1)):
        with pytest.raises(pop.StaleGenerationError):
            call()
    assert store.get("p")[0].replicas == 2 and store.get_status("p") == {}
    store.set_status("p", {"x": 2}, fence=g2)
    for i in range(300):
        store.record_event("p", "k", str(i))
    evs = pop.DurablePoolStore(str(tmp_path / "store")).events("p")
    assert len(evs) == 256 and evs[-1]["msg"] == "299"


def test_lease_and_routing_fence(tmp_path):
    root = str(tmp_path / "store")
    a, b = pop.DurablePoolStore(root), pop.DurablePoolStore(root)
    a.apply(pop.ScorerPoolSpec(name="p", artifact="a", version=1,
                               model_key="m"))
    assert a.acquire_lease("p", "op-a", ttl=30.0) == 1
    assert b.acquire_lease("p", "op-b", ttl=30.0) is None
    assert a.renew_lease("p", "op-a", 1) and not b.renew_lease("p", "op-b", 1)
    assert a.acquire_lease("p", "op-a", ttl=0.05) == 1
    time.sleep(0.08)
    assert b.acquire_lease("p", "op-b", ttl=30.0) == 2
    assert not a.renew_lease("p", "op-a", 1)
    t = {"keys": {"m": ["s1"]}, "shards": {"s0": ["u0"]}}
    assert b.publish_routing("p", t, epoch=2) == 1
    assert b.publish_routing("p", dict(t, table_generation=9)) == 1
    with pytest.raises(pop.StaleGenerationError):
        a.publish_routing("p", t, epoch=1)
    b.release_lease("p", "op-b")
    assert a.get_lease("p")["released"]
    assert a.acquire_lease("p", "op-a", ttl=30.0) == 3


def test_atomic_write_and_listing(tmp_path):
    p = str(tmp_path / "d" / "f.json")
    ppersist.write_bytes_atomic(p, b"v1")
    ppersist.write_bytes_atomic(p, b"v2")
    assert ppersist.read_bytes(p) == b"v2"
    assert sorted(os.listdir(tmp_path / "d")) == ["f.json"]
    (tmp_path / "d" / "sub").mkdir()
    assert ppersist.list_names(str(tmp_path / "d")) == ["f.json"]
    assert ppersist.list_names(str(tmp_path / "nope")) == []


# -- adoption after a controller restart ----------------------------------


class FakeAdopted(FakeReplica):
    def __init__(self, manifest, version, spec):
        super().__init__(manifest["rid"], version, spec)
        self.port = manifest["port"]
        self._alive = True
        self._loaded = True

    def spawn(self):
        raise AssertionError("adopted replicas are never spawned")


def _manifest(dirpath, rid, pid=1000, port=7001, version=1):
    os.makedirs(dirpath, exist_ok=True)
    doc = {"rid": rid, "pool": "p", "pid": pid, "port": port,
           "version": version}
    with open(os.path.join(dirpath, f"{rid}.json"), "w") as f:
        json.dump(doc, f)


def _ready_stats(rid, version, pid=1000):
    return {"ready": True, "reasons": [], "cordoned": None,
            "identity": {"pool": "p", "replica": rid, "pid": pid},
            "registry": {"m": {"version": version}}}


def _adopt(ns, tmp_path, version, pods_version, manifests):
    mdir = str(tmp_path / "pods")
    for rid, pid, port in manifests:
        _manifest(mdir, rid, pid=pid, port=port)
    store = ns.op.PoolStore()
    store.apply(ns.op.ScorerPoolSpec(name="p", artifact="a",
                                     version=version, model_key="m",
                                     replicas=2))
    rec = ns.op.Reconciler(store, registry=None, pool="p",
                           replica_factory=FakeReplica,
                           workdir=str(tmp_path), adopted_factory=FakeAdopted,
                           **ns.kw)
    rec._probe_stats = lambda url: _ready_stats(
        "p-1" if url.endswith(":7001") else
        "p-2" if url.endswith(":7002") else "OTHER", pods_version,
        pid=1000 if url.endswith(("7001", "7002")) else 999)
    rec._pid_alive = lambda pid: pid != 111
    n = rec.adopt_existing()
    assert _settle(rec, passes=60)
    return n, _kinds(store), sorted((r.rid, r.version, r.state)
                                    for r in rec.replicas)


@pytest.mark.parametrize("version,pods,manifests", [
    (1, 1, [("p-1", 1000, 7001), ("p-2", 1000, 7002)]),
    (2, 1, [("p-1", 1000, 7001), ("p-2", 1000, 7002)]),
    (1, 1, [("p-1", 111, 7001), ("p-3", 222, 7003)]),
], ids=["matching", "stale_version", "stale_and_foreign"])
def test_adoption_equals_reference(tmp_path, monkeypatch, version, pods,
                                   manifests):
    monkeypatch.setenv("H2O_TPU_POOL_DEREGISTER_GRACE", "0")
    port = _adopt(PKGS["port"], tmp_path / "port", version, pods,
                  manifests)
    ref = _adopt(PKGS["ref"], tmp_path / "ref", version, pods, manifests)
    assert port == ref
    n, kinds, reps = port
    if version == 1 and manifests[0][1] == 1000:
        assert n == 2 and "replica_start" not in kinds
    assert all(v == version and s == READY for _, v, s in reps)


def test_rollback_state_survives_restart(tmp_path):
    store = pop.DurablePoolStore(str(tmp_path / "store"))
    store.apply(pop.ScorerPoolSpec(name="p", artifact="a", version=2,
                                   model_key="m", replicas=1))
    store.set_status("p", {"last_good_version": 1,
                           "rollout": {"failed_version": 2,
                                       "pinned_version": 1,
                                       "state": "rolled_back"}})
    rec = pop.Reconciler(store, registry=None, pool="p",
                         replica_factory=FakeReplica, device="cpu")
    assert rec._want_version(store.get("p")[0]) == 1
    store.apply_update("p", version=3)
    assert rec._want_version(store.get("p")[0]) == 3


def test_adopt_runs_before_reconcile_in_run(tmp_path, monkeypatch):
    monkeypatch.setenv("H2O_TPU_POOL_DEREGISTER_GRACE", "0")
    _manifest(str(tmp_path / "pods"), "p-1", port=7001)
    store = pop.PoolStore()
    store.apply(pop.ScorerPoolSpec(name="p", artifact="a", version=1,
                                   model_key="m", replicas=1))
    rec = pop.Reconciler(store, registry=None, pool="p",
                         replica_factory=FakeReplica, workdir=str(tmp_path),
                         adopted_factory=FakeAdopted, device="cpu")
    rec._probe_stats = lambda url: _ready_stats("p-1", 1)
    rec._pid_alive = lambda pid: True
    stop = threading.Event()
    t = threading.Thread(target=rec.run, args=(stop,),
                         kwargs={"interval": 0.02}, daemon=True)
    t.start()
    try:
        assert rec.wait_converged(timeout=10)
    finally:
        stop.set()
        t.join(timeout=5)
    kinds = _kinds(store)
    assert "replica_adopted" in kinds and "replica_start" not in kinds


# -- the pods' device ------------------------------------------------------


def test_pods_need_the_card_unless_asked_for_the_cpu(tmp_path):
    """Without a card every constructor that would start pods raises;
    with ``device="cpu"`` the pod's command line carries it."""
    import torch

    spec = pop.ScorerPoolSpec(name="p", artifact="a", version=1,
                              model_key="m")
    store = pop.PoolStore()
    store.apply(spec)
    if not torch.cuda.is_available():
        for make in (lambda: pop.ScorerReplica("p-1", 1, spec),
                     lambda: pop.Reconciler(store, None, "p"),
                     lambda: pop.ShardedPool(store, None, "p")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    r = pop.ScorerReplica("p-1", 1, spec, device="cpu")
    assert r.device == "cpu"
    rec = pop.Reconciler(store, None, "p", device="cpu",
                         log_dir=str(tmp_path))
    assert rec.replica_factory("p-9", 1, spec).device == "cpu"


def test_probe_timeout_knob(monkeypatch):
    assert preconcile._probe_timeout() == jreconcile._probe_timeout() == 2.0
    monkeypatch.setenv("H2O_TPU_POOL_PROBE_TIMEOUT", "0.7")
    assert preconcile._probe_timeout() == 0.7
    monkeypatch.setenv("H2O_TPU_POOL_PROBE_TIMEOUT", "0")
    assert preconcile._probe_timeout() == 0.1
