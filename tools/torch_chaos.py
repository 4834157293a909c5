#!/usr/bin/env python
"""Fleet chaos drills on the port's pods — rehearse the operator's
failure scenarios, exit nonzero if recovery fails.

The JAX package's fleet drills (``tools/chaos.py``), run against the
port: scorer pods are ``python -m h2o_kubernetes_tpu_torch.operator.pod``
processes, the controller is the port's ``Reconciler`` /
``ShardedPool`` / ``operator.run``, and the front door the port's
router. The drills' gates are the reference's, with one change: eager
torch compiles nothing, so where the JAX storm held "every promotion is
a persistent-cache hit", this one holds that promotions are counted and
timed (``promotion_s``) and that a promoted tenant answers with the
same bytes. This tool imports nothing of the JAX package; the base
models are trained on the CPU in the drill's process, and the pods
serve them on ``--device`` (``cpu`` by default, ``--card`` for the
CUDA card).

Usage::

    python tools/torch_chaos.py replica-kill
    python tools/torch_chaos.py all                # every drill
    python tools/torch_chaos.py --card all         # pods on the card

Drills:

- ``rolling-update``  a 2-replica pool rolls v1 → v2 under closed-loop
  load: zero 5xx, zero requests scored while unready, both replicas on
  v2, no scoring state built on live traffic after warm-up, and the
  cordon → drain → exit events in status.
- ``replica-kill``  SIGKILL one replica: replaced, back to spec count
  and ready, replica_died → replica_start → replica_ready in events.
- ``tenant-storm``  a Zipf flood over 11 tenants under a byte budget of
  a quarter of their charge: resident bytes within budget at every sample,
  zero 5xx, every tenant served, promotions counted, timed and
  bitwise.
- ``operator-restart``  SIGKILL the operator process mid-rollout
  under load; the successor adopts the live pods (no duplicate
  spawns, no leaks) and finishes the rollout, zero 5xx.
- ``poison-rollback``  a corrupted v2: backoff-spaced respawns, an
  automatic rollback to the pinned last good version, old replicas
  READY throughout, zero 5xx.
- ``router-shard-kill``  a 3-shard fleet serving a Zipf storm through
  the router loses a shard: zero 5xx on the replicated head, typed
  ``placement_pending`` 503s on the victim's tail while each is
  re-placed, resident bytes within budget, token-backed retries, and
  the shard recovers (``H2O_TPU_DRILL_ROUTER_TENANTS``, default 1000).
- ``trace-failover``  one traced request whose primary replica is dead:
  the router's and the survivor's trace spans and /metrics.
- ``router-ha-kill``  two lease-fenced ``operator.run --ha`` controllers
  and two router processes; a rebalance move, the holder and a router
  SIGKILLed together, takeover within the lease TTL, adoption of every
  pod, the fence, shard loss and failback
  (``H2O_TPU_DRILL_HA_TENANTS``, default 60).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

# the device every drill's pods serve on; main() sets it from --card
DEVICE = "cpu"


class ChaosFailure(AssertionError):
    """A drill's recovery contract was broken."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ChaosFailure(msg)


def _catalog_charge(registry, entries) -> int:
    """Device-state bytes the tenant catalog ``entries`` ((artifact,
    version, key) triples) pins on one replica of DEVICE: each distinct
    artifact loaded here on DEVICE and warmed at bucket 128 with its
    contributions, as a pod's push does, and scored once; its
    ``_serving_resident_bytes`` counted once per
    tenant key. A quarter of it is the byte budget the storm drills give
    every pod, the rule ``chip_smoke.py``'s serving phases use."""
    import numpy as np

    from h2o_kubernetes_tpu_torch.operator import load_artifact

    per: dict = {}
    for name, version, _ in entries:
        if (name, version) not in per:
            m = load_artifact(registry.fetch(name, version), device=DEVICE)
            m.warm_up([128], contributions=m.contrib_support() is None)
            m.score_numpy(np.zeros((8, len(m.feature_names)), np.float32))
            per[(name, version)] = m._serving_resident_bytes()
            m._serving_evict()
    return sum(per[(n, v)] for n, v, _ in entries)


def _post_raw(url: str, key: str, body: dict,
              headers: dict | None = None,
              timeout: float = 30.0) -> tuple:
    """POST one scoring request directly; returns (status, bytes) —
    the bitwise-comparison primitive (same artifact + same rows must
    produce byte-identical predictions on any replica serving them)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"{url}/3/Predictions/models/{key}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except Exception:  # noqa: BLE001 — transport
        return -1, b""


class _PoolFixture:
    """A converged 2-replica scorer pool on artifact v1 (+v2 staged in
    the registry) — the shared setup of the rolling-update,
    replica-kill and tenant-storm drills. ``tenants`` > 0 adds that
    many EXTRA artifacts to the spec (multi-artifact push: the pool
    serves a tenant population, /readyz held until every one is
    loaded+warmed); ``pod_env`` injects env overrides into the pods
    (the tenant-storm drill pins a small scorer-cache byte budget:
    ``budget_fraction`` of the catalog's charge, ``_catalog_charge``).
    Always tear down via close(): subprocess pods must not outlive a
    failed drill."""

    def __init__(self, tag: str, tenants: int = 0,
                 pod_env: dict | None = None,
                 budget_fraction: float | None = None):
        import tempfile

        import numpy as np

        import h2o_kubernetes_tpu_torch as h2o
        from h2o_kubernetes_tpu_torch import GBM
        from h2o_kubernetes_tpu_torch.operator import (ModelRegistry,
                                                 PoolStore, Reconciler,
                                                 ScorerPoolSpec)

        self.td = tempfile.mkdtemp(prefix=f"chaos_{tag}_")
        rng = np.random.default_rng(0)
        n = 500
        cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
                for i in range(4)}
        cols["y"] = np.where(cols["x0"] - cols["x1"] > 0, "late",
                             "ontime")
        self.feature_cols = [f"x{i}" for i in range(4)]
        fr = h2o.Frame.from_arrays(cols, device="cpu")
        m1 = GBM(ntrees=4, max_depth=3, seed=1).train(
            y="y", training_frame=fr)
        m2 = GBM(ntrees=6, max_depth=3, seed=2).train(
            y="y", training_frame=fr)
        self.registry = ModelRegistry(os.path.join(self.td, "registry"))
        self.v1 = self.registry.publish(m1, "scorer")
        self.v2 = self.registry.publish(m2, "scorer")
        extra = ()
        self.tenant_keys = ["pm"]
        if tenants:
            # a second, structurally different artifact (more trees)
            # so the tenant set is not one model's device state
            # rebuilt again and again
            m3 = GBM(ntrees=8, max_depth=3, seed=3).train(
                y="y", training_frame=fr)
            self.registry.publish(m3, "scorer2")
            keys = [f"t{i:02d}" for i in range(1, tenants + 1)]
            extra = tuple(
                ("scorer" if i % 2 else "scorer2",
                 self.v1 if i % 2 else 1, k)
                for i, k in enumerate(keys, start=1))
            self.tenant_keys += keys
        self.store = PoolStore()
        self.store.apply(ScorerPoolSpec(
            name="pool", artifact="scorer", version=self.v1,
            model_key="pm", replicas=2, warm_buckets=(128,),
            extra_artifacts=extra, env=dict(pod_env or {})))
        self.budget = None
        if budget_fraction is not None:
            entries = [("scorer", self.v1, "pm")] + list(extra)
            self.budget = int(_catalog_charge(self.registry, entries)
                              * budget_fraction)
            self.store.apply_update("pool", env={
                **dict(pod_env or {}),
                "H2O_TPU_SCORER_CACHE_BYTES": str(self.budget)})
        self.rec = Reconciler(self.store, self.registry, "pool",
                              log_dir=os.path.join(self.td, "logs"),
                              device=DEVICE)
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=self.rec.run, args=(self.stop,),
            kwargs={"interval": 0.25}, daemon=True)
        self.thread.start()
        try:
            _check(self.rec.wait_converged(timeout=240),
                   f"pool never converged on v1: "
                   f"{self.store.get_status('pool')} "
                   f"(pod logs under {self.td}/logs)")
        except BaseException:
            # raising out of __init__ means the drill's try/finally
            # never runs — tear the pods down HERE or they leak as the
            # exact orphans the preflight reaper exists to catch
            # (keep_dir: the failure message points at the pod logs)
            self.close(keep_dir=True)
            raise

    def event_kinds(self) -> list[str]:
        return [e["kind"] for e in self.store.events("pool")]

    def close(self, keep_dir: bool = False) -> None:
        try:
            self.rec.shutdown(timeout=60)
        finally:
            self.stop.set()
            self.thread.join(timeout=10)
            if not keep_dir:
                import shutil

                shutil.rmtree(self.td, ignore_errors=True)


def scenario_rolling_update() -> None:
    """Artifact v1 → v2 across a 2-replica pool under closed-loop
    load: zero 5xx, zero unready routing, both replicas end on v2 with
    the warm-up contract intact."""
    from tools.score_load import run_load_multi

    fx = _PoolFixture("roll")
    try:
        load_stop = threading.Event()
        result: dict = {}

        def drive():
            result.update(run_load_multi(
                fx.rec.endpoints, "pm", fx.feature_cols,
                concurrency=3, rows_per_request=8,
                stop_event=load_stop))

        lt = threading.Thread(target=drive, daemon=True)
        lt.start()
        time.sleep(1.5)              # load in flight on v1
        fx.store.apply_update("pool", version=fx.v2)
        rolled = fx.rec.wait_converged(timeout=300)
        time.sleep(0.5)              # post-roll traffic on v2
        load_stop.set()
        lt.join(timeout=60)
        _check(rolled, "pool never converged on v2: "
               f"{fx.store.get_status('pool')}")
        _check(result.get("requests", 0) > 50,
               f"load generator barely ran: {result}")
        _check(result["fivexx"] == 0,
               f"{result['fivexx']} 5xx during the rolling update: "
               f"{result['fivexx_sample']}")
        _check(result["errors"] == 0,
               f"non-HTTP client errors during the roll: "
               f"{result['error_sample']}")
        versions = [r.loaded_version() for r in fx.rec.replicas]
        _check(versions == [fx.v2, fx.v2],
               f"replicas did not end on v2: {versions}")
        for r in fx.rec.replicas:
            st = r.stats()
            _check(st is not None, f"{r.rid}: /3/Stats unreachable")
            _check(st["counters"]["scored_while_unready"] == 0,
                   f"{r.rid} admitted scoring while unready: "
                   f"{st['counters']}")
            _check(st["registry"]["pm"]["warm_cache_misses"] == 0,
                   f"{r.rid} built scoring state on live traffic after "
                   f"warm-up: "
                   f"{st['registry']}")
        kinds = fx.event_kinds()
        for needed in ("replica_cordon", "replica_drain",
                       "replica_exit"):
            _check(needed in kinds,
                   f"event '{needed}' missing from operator status: "
                   f"{kinds}")
    finally:
        fx.close()


def scenario_replica_kill() -> None:
    """SIGKILL one replica of a converged pool: the reconciler
    replaces it and the pool recovers spec count + aggregate readiness
    inside the deadline, with the event sequence in status."""
    import signal

    fx = _PoolFixture("kill")
    try:
        victim = fx.rec.replicas[0]
        vid = victim.rid
        os.kill(victim.pid(), signal.SIGKILL)
        # SIGKILL delivery is async: wait until the process is
        # OBSERVABLY dead before polling convergence, or the first
        # converged() check can race the kill and declare victory over
        # a still-listed dead replica
        deadline = time.monotonic() + 10
        while victim.alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        _check(not victim.alive(), f"SIGKILL did not kill {vid}")
        _check(fx.rec.wait_converged(timeout=240),
               "pool never reconverged after SIGKILL: "
               f"{fx.store.get_status('pool')}")
        for r in fx.rec.replicas:
            _check(r.readyz_ok(), f"{r.rid} not ready after recovery")
        _check(len(fx.rec.replicas) == 2,
               f"pool not back at spec count: "
               f"{fx.store.get_status('pool')}")
        kinds = fx.event_kinds()
        died = kinds.index("replica_died")
        _check("replica_start" in kinds[died:]
               and "replica_ready" in kinds[died:],
               f"no replacement start/ready after replica_died ({vid}):"
               f" {kinds}")
    finally:
        fx.close()


def scenario_tenant_storm() -> None:
    """Zipf tenant flood against a 2-replica multi-artifact pool under
    a deliberately tiny scorer-cache byte budget: resident scorer bytes
    never exceed the budget on either replica, zero 5xx on any tenant
    (an evicted model must re-promote transparently, never error),
    eviction→promotion churn actually happens, and a promoted tenant
    answers with the same bytes as before the flood. Eager torch
    compiles nothing: a promotion rebuilds the model's device tensors
    (and, on the card, its scoring graphs), counted and timed as
    ``promotions`` and ``promotion_s`` on /3/Stats."""
    from tools.score_load import _make_bodies, run_load_zipf

    fx = _PoolFixture("storm", tenants=10, budget_fraction=0.25)
    budget = fx.budget
    try:
        body = _make_bodies(fx.feature_cols, 8, seed=3, pool=1)[0]
        url = fx.rec.replicas[0].url
        before = {k: _post_raw(url, k, body) for k in
                  (fx.tenant_keys[0], fx.tenant_keys[-1])}
        out = run_load_zipf(fx.rec.endpoints, fx.tenant_keys,
                            fx.feature_cols, concurrency=4,
                            rows_per_request=8, seconds=8.0,
                            zipf_s=1.1)
        _check(out["requests"] > 50,
               f"tenant flood barely ran: {out}")
        _check(out["fivexx"] == 0,
               f"{out['fivexx']} 5xx during the tenant storm "
               f"(sample: {out['fivexx_sample']}) — an evicted tenant "
               "must re-promote, not error")
        _check(out["errors"] == 0,
               f"client errors during the storm: {out['error_sample']}")
        served = [k for k, r in out["by_model"].items()
                  if r["requests"] > 0]
        _check(len(served) == len(fx.tenant_keys),
               f"only {len(served)}/{len(fx.tenant_keys)} tenants saw "
               "traffic — the Zipf flood did not cover the tail")
        res = out["residency"]
        _check(res["samples"] > 0, "no /3/Stats residency samples")
        _check(res["budget_bytes"] == budget,
               f"pods did not pick up the byte budget: {res}")
        _check(res["budget_exceeded"] == 0
               and res["max_resident_bytes"] <= budget,
               f"resident bytes exceeded the budget: {res}")
        _check((res["promotions_delta"] or 0) > 0,
               f"no eviction→promotion churn under a {budget}B budget "
               f"with {len(fx.tenant_keys)} tenants: {res}")
        for k, (code, raw) in before.items():
            code2, raw2 = _post_raw(url, k, body)
            _check(code == code2 == 200 and raw == raw2,
                   f"tenant {k} answered differently after the flood's "
                   f"evictions and promotions (HTTP {code} -> {code2})")
        st = fx.rec.replicas[0].stats() or {}
        sc = st.get("scorer_cache") or {}
        _check(sc.get("promotions", 0) > 0
               and sc.get("promotion_s", 0.0) > 0.0,
               f"promotions not counted and timed on /3/Stats: {sc}")
    finally:
        fx.close()


def _live_pods_for(workdir: str) -> list[tuple[int, str]]:
    """operator.pod processes whose cmdline references this pool's
    workdir — the leak check of the control-plane drills."""
    out = []
    try:
        pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return out
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    errors="replace")
        except OSError:
            continue
        if "operator.pod" in cmd and workdir in cmd:
            out.append((pid, cmd[:160]))
    return out


def scenario_operator_restart() -> None:
    """SIGKILL the operator process mid-rollout under closed-loop
    load, restart it against the durable store: the successor ADOPTS
    the live pods (zero duplicate spawns, zero leaked pods), finishes
    the rollout, and the load generator records zero 5xx end to end —
    the control plane died, the data plane never noticed."""
    import shutil
    import signal
    import subprocess

    import numpy as np

    import h2o_kubernetes_tpu_torch as h2o
    from h2o_kubernetes_tpu_torch import GBM
    from h2o_kubernetes_tpu_torch.operator import (DurablePoolStore,
                                             ModelRegistry,
                                             ScorerPoolSpec)
    from tools.score_load import run_load_multi

    td = tempfile.mkdtemp(prefix="chaos_oprestart_")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    storedir = os.path.join(td, "store")
    workdir = os.path.join(td, "work")
    regdir = os.path.join(td, "registry")
    procs: list = []
    try:
        rng = np.random.default_rng(0)
        n = 500
        cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
                for i in range(4)}
        cols["y"] = np.where(cols["x0"] - cols["x1"] > 0, "late",
                             "ontime")
        feature_cols = [f"x{i}" for i in range(4)]
        fr = h2o.Frame.from_arrays(cols, device="cpu")
        registry = ModelRegistry(regdir)
        v1 = registry.publish(GBM(ntrees=4, max_depth=3, seed=1).train(
            y="y", training_frame=fr), "scorer")
        v2 = registry.publish(GBM(ntrees=6, max_depth=3, seed=2).train(
            y="y", training_frame=fr), "scorer")
        store = DurablePoolStore(storedir)
        store.apply(ScorerPoolSpec(
            name="pool", artifact="scorer", version=v1,
            model_key="pm", replicas=2, warm_buckets=(128,)))

        def spawn_operator(tag: str) -> subprocess.Popen:
            log = open(os.path.join(td, f"operator_{tag}.log"), "ab")
            p = subprocess.Popen(
                [sys.executable, "-m",
                 "h2o_kubernetes_tpu_torch.operator.run",
                 "--store", storedir, "--registry", regdir,
                 "--pool", "pool", "--workdir", workdir,
                 "--interval", "0.25", "--device", DEVICE],
                cwd=repo, env=dict(os.environ),
                stdout=log, stderr=log, start_new_session=True)
            procs.append(p)
            return p

        def status() -> dict:
            return store.get_status("pool")

        def wait_status(pred, timeout: float, what: str) -> dict:
            deadline = time.monotonic() + timeout
            st = status()
            while time.monotonic() < deadline:
                st = status()
                if pred(st):
                    return st
                time.sleep(0.05)
            raise ChaosFailure(f"timed out waiting for {what}: {st} "
                               f"(operator logs under {td})")

        def endpoints() -> list[str]:
            return [f"http://127.0.0.1:{r['port']}"
                    for r in status().get("replicas", ())
                    if r["state"] in ("STARTING", "LOADING", "READY")]

        op1 = spawn_operator("1")
        wait_status(lambda st: st.get("converged")
                    and st.get("desired_version") == v1,
                    240, "v1 convergence")

        load_stop = threading.Event()
        result: dict = {}

        def drive():
            result.update(run_load_multi(
                endpoints, "pm", feature_cols, concurrency=3,
                rows_per_request=8, stop_event=load_stop))

        lt = threading.Thread(target=drive, daemon=True)
        lt.start()
        time.sleep(1.5)                     # load in flight on v1
        store.apply_update("pool", version=v2)
        # the moment the surge-one v2 replica exists, the rollout is
        # mid-flight — SIGKILL the control plane RIGHT THERE
        wait_status(lambda st: any(r["version"] == v2
                                   for r in st.get("replicas", ())),
                    120, "the surge v2 replica to spawn")
        op1.kill()
        op1.wait(timeout=30)
        pods_at_kill = _live_pods_for(workdir)
        _check(len(pods_at_kill) >= 2,
               f"expected >=2 live pods surviving the operator kill, "
               f"found {pods_at_kill}")

        op2 = spawn_operator("2")
        wait_status(lambda st: st.get("converged")
                    and st.get("desired_version") == v2
                    and st.get("effective_version") == v2,
                    300, "the restarted operator to finish the "
                    "rollout")
        time.sleep(0.5)                     # post-roll traffic on v2
        load_stop.set()
        lt.join(timeout=60)

        _check(result.get("requests", 0) > 50,
               f"load generator barely ran: {result}")
        _check(result["fivexx"] == 0,
               f"{result['fivexx']} 5xx across the operator restart: "
               f"{result['fivexx_sample']}")
        _check(result["errors"] == 0,
               f"client errors across the restart: "
               f"{result['error_sample']}")
        # the durable event ring spans BOTH operator lives: the
        # successor must have adopted, not re-spawned — exactly two
        # v1 starts ever, and at least two adoptions
        events = store.events("pool")
        kinds = [e["kind"] for e in events]
        _check(kinds.count("replica_adopted") >= 2,
               f"successor did not adopt the live pods: {kinds}")
        v1_starts = [e for e in events if e["kind"] == "replica_start"
                     and f"v{v1} " in e["msg"] + " "]
        _check(len(v1_starts) == 2,
               f"v1 replicas were re-spawned (duplicates): "
               f"{[e['msg'] for e in v1_starts]}")
        # graceful teardown: SIGTERM drains the fleet, zero leaks
        op2.send_signal(signal.SIGTERM)
        rc = op2.wait(timeout=120)
        _check(rc == 0, f"operator exited rc={rc} on SIGTERM")
        leaked = _live_pods_for(workdir)
        _check(not leaked, f"leaked pods after teardown: {leaked}")
    finally:
        import signal as _sig

        for p in procs:
            if p.poll() is None:
                p.kill()
        for pid, _ in _live_pods_for(workdir):
            try:
                os.kill(pid, _sig.SIGKILL)
            except OSError:
                pass
        shutil.rmtree(td, ignore_errors=True)


def scenario_poison_rollback() -> None:
    """Push an artifact whose replica can never come up: respawns are
    backoff-spaced (provably >= the configured base), the rollout
    auto-rolls-back to last-good after H2O_TPU_POOL_ROLLOUT_RETRIES
    failures, the old replicas stay READY throughout, and the load
    generator records zero 5xx — a bad push degrades to 'nothing
    happened' instead of a wedged pool."""
    from h2o_kubernetes_tpu_torch import persist
    from tools.score_load import run_load_multi

    base_backoff = 0.4
    retries = 4
    saved = {k: os.environ.get(k) for k in
             ("H2O_TPU_POOL_BACKOFF_BASE", "H2O_TPU_POOL_BACKOFF_MAX",
              "H2O_TPU_POOL_ROLLOUT_RETRIES")}
    os.environ["H2O_TPU_POOL_BACKOFF_BASE"] = str(base_backoff)
    os.environ["H2O_TPU_POOL_BACKOFF_MAX"] = "5"
    os.environ["H2O_TPU_POOL_ROLLOUT_RETRIES"] = str(retries)
    fx = _PoolFixture("poison")
    try:
        # poison v2 IN the registry: the blob no longer matches its
        # indexed digest, so every push of it fails verification and
        # the surge replica can never reach READY
        path = fx.registry.artifact_path("scorer", fx.v2)
        persist.write_bytes(path, b"POISON" + persist.read_bytes(path))

        load_stop = threading.Event()
        result: dict = {}

        def drive():
            result.update(run_load_multi(
                fx.rec.endpoints, "pm", fx.feature_cols,
                concurrency=3, rows_per_request=8,
                stop_event=load_stop))

        lt = threading.Thread(target=drive, daemon=True)
        lt.start()
        time.sleep(1.0)                 # load in flight on v1
        fx.store.apply_update("pool", version=fx.v2)

        # wait for the auto-rollback, sampling old-replica readiness
        # the whole way: the bad push must never disturb them
        ready_samples: list[int] = []
        deadline = time.monotonic() + 120
        rolled = False
        while time.monotonic() < deadline:
            st = fx.store.get_status("pool")
            ready_samples.append(st.get("ready", 0))
            if any(e["kind"] == "rollout_rolled_back"
                   for e in fx.store.events("pool")):
                rolled = True
                break
            time.sleep(0.1)
        _check(rolled, "rollout never rolled back: "
               f"{fx.event_kinds()} {fx.store.get_status('pool')}")
        _check(fx.rec.wait_converged(timeout=60),
               "pool did not re-converge on last-good after the "
               f"rollback: {fx.store.get_status('pool')}")
        time.sleep(1.0)                 # post-rollback traffic window
        load_stop.set()
        lt.join(timeout=60)

        _check(result.get("requests", 0) > 50,
               f"load generator barely ran: {result}")
        _check(result["fivexx"] == 0,
               f"{result['fivexx']} 5xx during the poisoned rollout: "
               f"{result['fivexx_sample']}")
        _check(result["errors"] == 0,
               f"client errors during the poisoned rollout: "
               f"{result['error_sample']}")
        _check(ready_samples and min(ready_samples) >= 2,
               f"old replicas dipped below spec count during the bad "
               f"push: min ready {min(ready_samples or [0])}")

        events = fx.store.events("pool")
        kinds = [e["kind"] for e in events]
        st = fx.store.get_status("pool")
        _check(st.get("rollout", {}).get("pinned_version") == fx.v1
               and st.get("effective_version") == fx.v1
               and st.get("desired_version") == fx.v2,
               f"status does not pin last-good v{fx.v1}: {st}")
        _check("replica_cordon" not in kinds,
               "a READY old replica was cordoned during the failed "
               f"rollout: {kinds}")
        # respawns provably backoff-spaced: starts 3+ of the poisoned
        # version must be >= base (then >= 2*base) apart — a hot
        # respawn loop fails here
        v2_starts = [e["t"] for e in events
                     if e["kind"] == "replica_start"
                     and f"v{fx.v2} " in e["msg"] + " "]
        _check(len(v2_starts) == retries,
               f"expected {retries} poisoned spawns before rollback, "
               f"got {len(v2_starts)}: {kinds}")
        gaps = [b - a for a, b in zip(v2_starts, v2_starts[1:])]
        _check(all(g >= base_backoff - 0.02 for g in gaps[1:]),
               f"respawns not backoff-spaced (base {base_backoff}s): "
               f"gaps {[round(g, 3) for g in gaps]}")
        _check("crash_loop_backoff" in kinds,
               f"no crash_loop_backoff event surfaced: {kinds}")
        # the pool is parked, not wedged: no further poisoned spawns
        n_before = len(v2_starts)
        time.sleep(2.0)
        v2_starts_after = [
            e for e in fx.store.events("pool")
            if e["kind"] == "replica_start"
            and f"v{fx.v2} " in e["msg"] + " "]
        _check(len(v2_starts_after) == n_before,
               "pool kept re-trying the rolled-back version")
        # replicas still serve the last-good artifact
        versions = sorted(r.loaded_version() for r in fx.rec.replicas)
        _check(versions == [fx.v1, fx.v1],
               f"replicas not on last-good v{fx.v1}: {versions}")
    finally:
        fx.close()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


class _ShardedFixture:
    """A converged tenant-SHARDED fleet: ``shards`` shard
    groups of ``replicas_per_shard`` subprocess pods each, a
    ``tenants``-key catalog rendezvous-placed across them (the first
    ``head`` keys replicated on every shard), every pod under a
    ``budget_bytes`` scorer-cache byte budget, and (optionally) the
    device-free front-door router over the pool's routing table. A
    handful of distinct base GBMs rotate across the tenant keys, as in
    the tenant-storm fixture. ``shards=1`` degenerates to the everyone-has-everything
    baseline pool (the router bench's direct leg)."""

    def __init__(self, tag: str, tenants: int = 1000, shards: int = 3,
                 head: int = 10, replicas_per_shard: int = 1,
                 budget_bytes: int | None = None, base_variants: int = 3,
                 with_router: bool = True,
                 startup_deadline: float = 600.0,
                 warm_buckets: tuple = (128,)):
        import shutil  # noqa: F401 — close() uses it

        import numpy as np

        import h2o_kubernetes_tpu_torch as h2o
        from h2o_kubernetes_tpu_torch import GBM
        from h2o_kubernetes_tpu_torch.operator import (ModelRegistry,
                                                 PoolStore,
                                                 ScorerPoolSpec,
                                                 ShardedPool,
                                                 start_router)

        # hundreds of sequential artifact pushes per shard replica:
        # the stock 180s startup deadline is sized for a handful
        self._env_saved = {"H2O_TPU_POOL_STARTUP_DEADLINE":
                           os.environ.get(
                               "H2O_TPU_POOL_STARTUP_DEADLINE")}
        os.environ["H2O_TPU_POOL_STARTUP_DEADLINE"] = \
            str(startup_deadline)
        self.td = tempfile.mkdtemp(prefix=f"chaos_{tag}_")
        rng = np.random.default_rng(0)
        n = 400
        cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
                for i in range(4)}
        cols["y"] = np.where(cols["x0"] - cols["x1"] > 0, "late",
                             "ontime")
        self.feature_cols = [f"x{i}" for i in range(4)]
        fr = h2o.Frame.from_arrays(cols, device="cpu")
        self.registry = ModelRegistry(os.path.join(self.td,
                                                   "registry"))
        nv = max(1, min(base_variants, tenants))
        arts = []
        for b in range(nv):
            m = GBM(ntrees=2 + b, max_depth=2, seed=b + 1).train(
                y="y", training_frame=fr)
            self.registry.publish(m, f"t{b}")
            arts.append(f"t{b}")
        self.tenant_keys = [f"m{i:03d}" for i in range(tenants)]
        extra = tuple((arts[i % nv], 1, k)
                      for i, k in enumerate(self.tenant_keys)
                      if i > 0)
        if budget_bytes is None:
            # a quarter of the catalog's charge on one replica
            budget_bytes = _catalog_charge(
                self.registry, [(arts[0], 1, self.tenant_keys[0])]
                + list(extra)) // 4
        self.budget_bytes = budget_bytes
        self.store = PoolStore()
        self.store.apply(ScorerPoolSpec(
            name="pool", artifact=arts[0], version=1,
            model_key=self.tenant_keys[0],
            replicas=replicas_per_shard, shards=shards,
            head_models=max(1, min(head, tenants)), tail_replicas=1,
            warm_buckets=tuple(warm_buckets), extra_artifacts=extra,
            env={"H2O_TPU_SCORER_CACHE_BYTES": str(budget_bytes)}))
        self.pool = ShardedPool(self.store, self.registry, "pool",
                                log_dir=os.path.join(self.td, "logs"),
                                device=DEVICE)
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=self.pool.run, args=(self.stop,),
            kwargs={"interval": 0.25}, daemon=True)
        self.thread.start()
        self.router_srv = None
        self.router = None
        self.router_url = None
        try:
            _check(self.pool.wait_converged(
                timeout=startup_deadline + 120),
                f"sharded pool never converged: "
                f"{self.store.get_status('pool')} "
                f"(pod logs under {self.td}/logs)")
            if with_router:
                self.router_srv, self.router = start_router(
                    self.pool.routing_table)
                self.router_url = ("http://127.0.0.1:"
                                   f"{self.router_srv.server_address[1]}")
        except BaseException:
            # raising out of __init__ skips the drill's try/finally —
            # tear the pods down here (logs kept for diagnosis)
            self.close(keep_dir=True)
            raise

    def replica_urls(self) -> list:
        urls = []
        for rec in self.pool.recs.values():
            with rec._lock:
                urls.extend(r.url for r in rec.replicas
                            if r.state != "DEAD")
        return urls

    def event_kinds(self) -> list:
        return [e["kind"] for e in self.store.events("pool")]

    def close(self, keep_dir: bool = False) -> None:
        import shutil

        try:
            if self.router is not None:
                self.router.stop()
            if self.router_srv is not None:
                self.router_srv.shutdown()
                self.router_srv.server_close()
        finally:
            # stop the loop BEFORE tearing pods down: a live
            # _replace_once pass would read the dying fleet as a mass
            # shard-loss and spray shard_down events into the ring
            self.stop.set()
            self.thread.join(timeout=15)
            try:
                self.pool.shutdown(timeout=90)
            finally:
                for k, v in self._env_saved.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v
                if not keep_dir:
                    shutil.rmtree(self.td, ignore_errors=True)


def _score_via_router(url: str, key: str, body: dict,
                      attempts: int = 6, sleep: float = 0.4):
    """POST one scoring request through the router, retrying briefly
    (re-placement pushes may still be landing); returns the last HTTP
    status observed."""
    import urllib.error
    import urllib.request

    code = None
    for _ in range(attempts):
        req = urllib.request.Request(
            f"{url}/3/Predictions/models/{key}",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status
        except urllib.error.HTTPError as e:
            code = e.code
            e.read()
        except Exception:  # noqa: BLE001 — transport: retry
            code = -1
        time.sleep(sleep)
    return code


def scenario_router_shard_kill() -> None:
    """The sharded fleet's acceptance drill: a 3-shard fleet serving a
    1000-tenant Zipf storm through the front-door router loses one
    whole shard mid-run (SIGKILL + its capacity scaled to zero — the
    node pool is gone). Contracts proven:

    - ZERO 5xx for the replicated head tenants across the kill (the
      router fails over inside the retry budget);
    - the victim's tail tenants surface as TYPED degraded 503s
      (placement_pending) — never raw 5xx lies — while the reconciler
      re-places each one onto a surviving shard via a targeted push,
      and every one of them scores 200 through the router WHILE the
      home shard is still gone;
    - per-replica scorer-cache ``resident_bytes`` never exceeds the
      byte budget at any sampled instant;
    - every cross-shard retry was token-backed (``retries ==
      retry_budget.granted`` on the router's /3/Stats) and bounded —
      a dying shard cannot amplify load onto survivors;
    - re-enabling the shard's capacity reconverges the pool
      (shard_down → tenant_replaced* → shard_recovered in events)."""
    import signal

    from tools.score_load import _get_json, _make_bodies, run_load_zipf

    tenants = int(os.environ.get("H2O_TPU_DRILL_ROUTER_TENANTS",
                                 "1000"))
    head_n = 10
    saved = {k: os.environ.get(k) for k in
             ("H2O_TPU_ROUTER_RETRY_BUDGET",
              "H2O_TPU_ROUTER_HEALTH_INTERVAL")}
    # burst sized for the in-flight failover wave at the kill instant
    # (the budget must bound amplification, not starve legitimate
    # failover); sweeps fast so the ring reflects the kill quickly
    os.environ["H2O_TPU_ROUTER_RETRY_BUDGET"] = "20"
    os.environ["H2O_TPU_ROUTER_HEALTH_INTERVAL"] = "0.25"
    fx = _ShardedFixture("rshard", tenants=tenants, shards=3,
                         head=head_n)
    budget = fx.budget_bytes
    try:
        head_keys = fx.tenant_keys[:head_n]

        # live residency watcher over every pod (budget contract is
        # "never exceeded WHILE the storm runs", sampled, not final)
        resid = {"samples": 0, "max": 0, "exceeded": 0}
        watch_stop = threading.Event()

        def watcher():
            while not watch_stop.is_set():
                for u in fx.replica_urls():
                    st = _get_json(u + "/3/Stats", timeout=2.0)
                    sc = (st or {}).get("scorer_cache") or {}
                    rb = int(sc.get("resident_bytes") or 0)
                    if st:
                        resid["samples"] += 1
                        resid["max"] = max(resid["max"], rb)
                        if rb > budget:
                            resid["exceeded"] += 1
                watch_stop.wait(0.5)

        wt = threading.Thread(target=watcher, daemon=True)
        wt.start()

        storm_out: dict = {}
        storm_stop = threading.Event()

        def storm():
            storm_out.update(run_load_zipf(
                [fx.router_url], fx.tenant_keys, fx.feature_cols,
                concurrency=6, rows_per_request=8, seconds=30.0,
                zipf_s=1.1, seed=0, router=True,
                stop_event=storm_stop))

        st_thread = threading.Thread(target=storm, daemon=True)
        st_thread.start()
        time.sleep(6.0)                    # storm established

        # victim: any shard that uniquely holds tail tenants
        victim = next(sid for sid in fx.pool.recs
                      if set(fx.pool.plan.keys_for(sid))
                      - set(head_keys))
        orphans = sorted(set(fx.pool.plan.keys_for(victim))
                         - set(head_keys))
        _check(len(orphans) >= max(2, (tenants - head_n) // 10),
               f"victim shard {victim} holds only {len(orphans)} tail "
               "tenants — fixture shape wrong")
        vrec = fx.pool.recs[victim]
        with vrec._lock:
            victims = list(vrec.replicas)
        for r in victims:
            if r.pid():
                try:
                    os.kill(r.pid(), signal.SIGKILL)
                except OSError:
                    pass
        # the node pool behind the shard is GONE: no capacity to
        # respawn into until recovery is re-enabled below
        fx.store.apply_update(victim, replicas=0)

        # the event ring is BOUNDED (256): ~330 tenant_replaced
        # events will evict the earlier shard_down entry, so the
        # event contract is checked against an incremental union of
        # snapshots, not one final read
        seen_kinds: set = set()

        # the reconciler re-places every orphan via targeted pushes
        deadline = time.monotonic() + 420
        while time.monotonic() < deadline:
            seen_kinds.update(fx.event_kinds())
            if all(k in fx.pool.overrides for k in orphans):
                break
            time.sleep(0.5)
        missing = [k for k in orphans if k not in fx.pool.overrides]
        _check(not missing,
               f"{len(missing)}/{len(orphans)} tail tenants never "
               f"re-placed (sample {missing[:5]}): "
               f"{fx.store.get_status('pool')}")

        # every orphan serves through the router off a SURVIVOR while
        # the home shard is still dead
        _check(not fx.pool.shard_healthy(victim),
               "victim shard resurrected before re-placement was "
               "verified — drill invalid")
        body = _make_bodies(fx.feature_cols, 4, seed=1, pool=1)[0]
        failed = []
        for k in orphans:
            code = _score_via_router(fx.router_url, k, body)
            if code != 200:
                failed.append((k, code))
        _check(not failed,
               f"{len(failed)} re-placed tenants not serving via "
               f"survivors (sample {failed[:5]})")

        storm_stop.set()
        st_thread.join(timeout=120)
        watch_stop.set()
        wt.join(timeout=10)

        _check(storm_out.get("requests", 0) > 200,
               f"Zipf storm barely ran: {storm_out}")
        _check(storm_out["errors"] == 0,
               f"client transport errors during the storm: "
               f"{storm_out['error_sample']} (router: "
               f"{(_get_json(fx.router_url + '/3/Stats') or {}).get('stats')})")
        head_5xx = sum(storm_out["by_model"][k]["fivexx"]
                       for k in head_keys)
        _check(head_5xx == 0,
               f"{head_5xx} 5xx on replicated HEAD tenants across the "
               f"shard kill: {storm_out['fivexx_sample']}")
        _check(storm_out.get("degraded", 0) > 0,
               "no typed degraded 503 observed — the kill window "
               "never exercised degraded mode (storm/kill timing "
               "broken)")
        _check(resid["samples"] > 10, "residency watcher never ran")
        _check(resid["exceeded"] == 0 and resid["max"] <= budget,
               f"scorer-cache resident bytes exceeded the "
               f"{budget}B budget: {resid}")

        rst = _get_json(fx.router_url + "/3/Stats", timeout=5.0)
        _check(rst is not None, "router /3/Stats unreachable")
        rstats, rbudget = rst["stats"], rst["retry_budget"]
        _check(rstats["retries"] == rbudget["granted"],
               f"cross-shard retries not token-backed: {rstats} "
               f"{rbudget}")
        _check(rstats["retries"] <= 200,
               f"retry amplification past the budget's intent: "
               f"{rstats}")
        _check(rstats["degraded_503"] > 0,
               f"router never served the typed degraded 503: {rstats}")

        # recovery: capacity returns, the shard reloads its catalog
        # and the pool reconverges
        fx.store.apply_update(victim, replicas=1)
        _check(fx.pool.wait_converged(timeout=600),
               f"pool never reconverged after shard recovery: "
               f"{fx.store.get_status('pool')}")
        code = _score_via_router(fx.router_url, orphans[0], body)
        _check(code == 200,
               f"native tenant not serving after shard recovery "
               f"(HTTP {code})")
        # the recovery event lands on the loop's NEXT replace pass —
        # poll briefly instead of racing it
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            seen_kinds.update(fx.event_kinds())
            if "shard_recovered" in seen_kinds:
                break
            time.sleep(0.25)
        seen_kinds.update(fx.event_kinds())
        for needed in ("shard_down", "tenant_replaced",
                       "shard_recovered"):
            _check(needed in seen_kinds,
                   f"event '{needed}' missing from the pool's event "
                   f"log: {sorted(seen_kinds)}")
    finally:
        fx.close()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def scenario_trace_failover() -> None:
    """Fleet-telemetry acceptance drill: kill a replica
    under the router, then send one traced scoring request whose
    round-robin primary is the corpse. Asserts the trace id survives
    the intra-shard failover retry (router span record: >=1
    transport_error attempt, exactly ONE terminal `forwarded`
    dispatch), the survivor's /3/Trace/{id} carries the full
    queue/batch/dispatch span decomposition with exactly one dispatch,
    and /metrics on the router + survivor expose the failover/request
    counters plus the build-info block — the end-to-end proof that one
    scrape + one trace id explain a request that crossed a dying
    fleet."""
    import signal
    import urllib.request

    from h2o_kubernetes_tpu_torch.operator.router import start_router
    from h2o_kubernetes_tpu_torch.runtime import telemetry

    fx = _PoolFixture("tracefail")
    saved_hi = os.environ.get("H2O_TPU_ROUTER_HEALTH_INTERVAL")
    # freeze the health ring after the initial sweep: the drill needs
    # the dead replica still listed READY so the REQUEST performs the
    # failover (not the sweep quietly removing the corpse first)
    os.environ["H2O_TPU_ROUTER_HEALTH_INTERVAL"] = "3600"
    srv = router = None
    try:
        victim, survivor = fx.rec.replicas[0], fx.rec.replicas[1]
        # victim FIRST in the shard's replica list: round-robin starts
        # at 0, so the first routed request's primary is the corpse
        table = {"keys": {"pm": ["s0"]},
                 "shards": {"s0": [victim.url, survivor.url]}}
        srv, router = start_router(table)
        rurl = f"http://127.0.0.1:{srv.server_address[1]}"
        _check(router.any_shard_healthy(),
               "router never saw a healthy shard")
        os.kill(victim.pid(), signal.SIGKILL)
        deadline = time.monotonic() + 10
        while victim.alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        _check(not victim.alive(), "SIGKILL did not kill the victim")

        body = json.dumps({"rows": [
            {c: 0.25 for c in fx.feature_cols}] * 4}).encode()
        req = urllib.request.Request(
            f"{rurl}/3/Predictions/models/pm", data=body,
            method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            _check(r.status == 200,
                   f"routed request not 200: {r.status}")
            tid = r.headers.get("X-H2O-Trace-Id")
            payload = json.loads(r.read())
        _check(bool(tid), "router response carries no X-H2O-Trace-Id")
        _check("predict" in payload or "pontime" in payload,
               f"unexpected scoring payload keys: "
               f"{sorted(payload)[:6]}")

        # router half of the trace: the failover is VISIBLE — the dead
        # primary's attempt recorded, exactly one terminal dispatch
        with urllib.request.urlopen(f"{rurl}/3/Trace/{tid}",
                                    timeout=30) as r:
            rtrace = json.loads(r.read())
        disp = [s for s in rtrace["spans"] if s["name"] == "dispatch"]
        fwd = [s for s in disp if s["outcome"] == "forwarded"]
        terr = [s for s in disp
                if s["outcome"] == "transport_error"]
        _check(len(fwd) == 1,
               f"want exactly 1 terminal forwarded dispatch, got "
               f"{len(fwd)}: {rtrace['spans']}")
        _check(len(terr) >= 1,
               f"dead-primary attempt not recorded: {rtrace['spans']}")

        # survivor half: same trace id, full per-hop decomposition,
        # exactly one device dispatch for the whole failover story
        with urllib.request.urlopen(
                f"{survivor.url}/3/Trace/{tid}", timeout=30) as r:
            strace = json.loads(r.read())
        names = [s["name"] for s in strace["spans"]]
        for want in ("admission", "queue", "assemble", "dispatch",
                     "total"):
            _check(want in names,
                   f"survivor trace missing span '{want}': {names}")
        _check(names.count("dispatch") == 1,
               f"survivor recorded {names.count('dispatch')} device "
               f"dispatches for one request: {names}")

        # /metrics on both hops: failover counters + build identity
        with urllib.request.urlopen(f"{rurl}/metrics",
                                    timeout=30) as r:
            rmet = telemetry.parse_prometheus_text(r.read().decode())

        def rv(name, **lbls):
            return rmet.get((name, tuple(sorted(lbls.items()))), 0.0)

        _check(rv("h2o_stats_router_stats_transport_errors") >= 1,
               "router /metrics missing the transport-error count")
        _check(rv("h2o_stats_router_stats_failovers") >= 1,
               "router /metrics missing the failover count")
        # per-tenant no-double-count: asserted on THIS router's own
        # counters (snapshot + /3/Stats by_model), NOT the global
        # registry label — earlier drills in the same process (the
        # 1000-tenant shard-kill) legitimately fill the capped
        # top-K label set, rolling a one-request tenant into `other`
        snap = router.snapshot()
        _check(snap["by_model"].get("pm") == 1
               and snap["stats"]["forwarded"] == 1,
               "tenant forwarded counter != 1 after one request "
               f"(by_model={snap['by_model']}, "
               f"forwarded={snap['stats']['forwarded']})")
        _check(any(k[0] == "h2o_build_info" for k in rmet),
               "router /metrics missing h2o_build_info")
        with urllib.request.urlopen(f"{survivor.url}/metrics",
                                    timeout=30) as r:
            smet = telemetry.parse_prometheus_text(r.read().decode())
        sm = {k[0] for k in smet}
        for want in ("h2o_stats_batcher_requests", "h2o_build_info",
                     "h2o_request_phase_seconds_bucket"):
            _check(want in sm, f"survivor /metrics missing {want}")
        with urllib.request.urlopen(f"{survivor.url}/3/Stats",
                                    timeout=30) as r:
            st = json.loads(r.read())
        _check(isinstance(st.get("build"), dict)
               and st["build"].get("version")
               and st["build"].get("pid"),
               f"survivor /3/Stats missing the build block: "
               f"{st.get('build')}")

        # both hops read as what they are off one scrape each (the
        # JAX package's tools/fleet_top.py does this; it imports that
        # package, so the drill reads the two documents itself)
        with urllib.request.urlopen(f"{rurl}/healthz", timeout=30) as r:
            rh = json.loads(r.read())
        _check(rh.get("router") is True and rh.get("alive"),
               f"the router's /healthz does not name a router: {rh}")
        _check((st.get("batcher") or {}).get("requests", 0) >= 1,
               f"the survivor's /3/Stats counts no request: "
               f"{st.get('batcher')}")
    finally:
        if saved_hi is None:
            os.environ.pop("H2O_TPU_ROUTER_HEALTH_INTERVAL", None)
        else:
            os.environ["H2O_TPU_ROUTER_HEALTH_INTERVAL"] = saved_hi
        if router is not None:
            router.stop()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        fx.close()


def scenario_router_ha_kill() -> None:
    """The highly-available front door's drill: the whole FRONT DOOR goes highly
    available. A 3-shard fleet is run by TWO ``operator.run --ha``
    replicas (lease-fenced: exactly one reconciles) and fronted by TWO
    stateless router processes reading the store-backed routing table.
    Under a live Zipf storm the drill:

    - floods one tail tenant with 1 ms-deadline requests until its
      per-tenant 504 pressure sustains and the holder REBALANCES it
      (make-before-break: the destination serves bitwise-identical
      predictions while the source still serves);
    - SIGKILLs one router AND the lease holder simultaneously: the
      storm fails over to the surviving router with zero client
      errors, the standby takes the lease (epoch+1) within TTL +
      heartbeat of the dead holder's last renewal, adopts every pod
      (same pids — zero respawns), RESUMES the in-flight move, and a
      routing publish fenced on the dead holder's epoch is provably
      rejected (StaleGenerationError);
    - after the move's dwell the NEW holder retires the source (the
      move record survived takeover through the status doc);
    - then loses a whole shard (loss-driven overrides re-place its
      tenants onto survivors) and recovers it: failback EMPTIES the
      overrides once the home shard is provably healthy again;
    - end to end: zero 5xx on the replicated head tenants, zero
      client transport errors, and ``retries == granted`` on the
      surviving router."""
    import re
    import shutil
    import signal
    import subprocess

    import numpy as np

    import h2o_kubernetes_tpu_torch as h2o
    from h2o_kubernetes_tpu_torch import GBM
    from h2o_kubernetes_tpu_torch.operator import (DurablePoolStore,
                                             ModelRegistry,
                                             ScorerPoolSpec,
                                             StaleGenerationError)
    from tools.score_load import _get_json, _make_bodies, run_load_zipf

    tenants = int(os.environ.get("H2O_TPU_DRILL_HA_TENANTS", "60"))
    head_n = 6
    ttl, hb = 4.0, 0.5
    retire_s, failback_s = 8.0, 4.0
    td = tempfile.mkdtemp(prefix="chaos_rhakill_")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    storedir = os.path.join(td, "store")
    workdir = os.path.join(td, "work")
    regdir = os.path.join(td, "registry")
    procs: dict = {}
    # subprocess-only env: the drill process itself keeps its own
    ha_env = dict(
        os.environ,
        H2O_TPU_LEASE_TTL=str(ttl), H2O_TPU_LEASE_HEARTBEAT=str(hb),
        H2O_TPU_REBALANCE="1", H2O_TPU_REBALANCE_SUSTAIN="2",
        H2O_TPU_REBALANCE_COOLDOWN="2",
        H2O_TPU_REBALANCE_RETIRE_S=str(retire_s),
        H2O_TPU_REBALANCE_FAILBACK_S=str(failback_s),
        H2O_TPU_POOL_STARTUP_DEADLINE="600",
        H2O_TPU_ROUTER_RETRY_BUDGET="20",
        H2O_TPU_ROUTER_HEALTH_INTERVAL="0.25",
        H2O_TPU_ROUTER_TABLE_INTERVAL="0.25")
    try:
        rng = np.random.default_rng(0)
        n = 400
        cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
                for i in range(4)}
        cols["y"] = np.where(cols["x0"] - cols["x1"] > 0, "late",
                             "ontime")
        feature_cols = [f"x{i}" for i in range(4)]
        fr = h2o.Frame.from_arrays(cols, device="cpu")
        registry = ModelRegistry(regdir)
        arts = []
        for b in range(2):
            m = GBM(ntrees=2 + b, max_depth=2, seed=b + 1).train(
                y="y", training_frame=fr)
            registry.publish(m, f"t{b}")
            arts.append(f"t{b}")
        keys = [f"m{i:03d}" for i in range(tenants)]
        head_keys = keys[:head_n]
        extra = tuple((arts[i % 2], 1, k)
                      for i, k in enumerate(keys) if i > 0)
        store = DurablePoolStore(storedir)
        store.apply(ScorerPoolSpec(
            name="pool", artifact=arts[0], version=1,
            model_key=keys[0], replicas=1, shards=3,
            head_models=head_n, tail_replicas=1, warm_buckets=(128,),
            extra_artifacts=extra))

        def spawn_operator(tag: str):
            log = open(os.path.join(td, f"operator_{tag}.log"), "ab")
            p = subprocess.Popen(
                [sys.executable, "-m",
                 "h2o_kubernetes_tpu_torch.operator.run",
                 "--store", storedir, "--registry", regdir,
                 "--pool", "pool", "--workdir", workdir,
                 "--interval", "0.25", "--ha", "--holder-id", tag,
                 "--device", DEVICE],
                cwd=repo, env=ha_env, stdout=log, stderr=log,
                start_new_session=True)
            procs[tag] = p
            return p

        def spawn_router(tag: str) -> str:
            logp = os.path.join(td, f"{tag}.log")
            log = open(logp, "ab")
            p = subprocess.Popen(
                [sys.executable, "-m",
                 "h2o_kubernetes_tpu_torch.operator.router",
                 "--store", storedir, "--pool", "pool", "--port", "0"],
                cwd=repo, env=ha_env, stdout=log, stderr=log,
                start_new_session=True)
            procs[tag] = p
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                with open(logp, "rb") as f:
                    txt = f.read().decode(errors="replace")
                mm = re.search(r"ROUTER_UP port=(\d+)", txt)
                if mm:
                    return f"http://127.0.0.1:{mm.group(1)}"
                _check(p.poll() is None,
                       f"{tag} died at startup: {txt[-400:]}")
                time.sleep(0.2)
            raise ChaosFailure(f"{tag} never printed ROUTER_UP")

        def wait_status(pred, timeout: float, what: str) -> dict:
            deadline = time.monotonic() + timeout
            st = store.get_status("pool") or {}
            while time.monotonic() < deadline:
                st = store.get_status("pool") or {}
                if pred(st):
                    return st
                time.sleep(0.25)
            raise ChaosFailure(f"timed out waiting for {what}: {st} "
                               f"(logs under {td})")

        spawn_operator("op-a")
        spawn_operator("op-b")
        st = wait_status(lambda s: s.get("converged"), 600,
                         "the HA fleet to converge")
        lease = store.get_lease("pool")
        _check(lease is not None and not lease.get("released")
               and lease.get("holder") in ("op-a", "op-b"),
               f"no live lease after convergence: {lease}")
        rdoc = store.get_routing("pool")
        _check(rdoc is not None
               and int(rdoc.get("table_generation", 0)) >= 1
               and rdoc.get("keys"),
               f"holder never published a routing table: {rdoc}")

        url_a = spawn_router("router-a")
        url_b = spawn_router("router-b")
        body = _make_bodies(feature_cols, 8, seed=1, pool=1)[0]
        for u in (url_a, url_b):
            code = _score_via_router(u, keys[0], body)
            _check(code == 200,
                   f"store-backed router {u} not serving the head "
                   f"tenant (HTTP {code})")
        # N routers, ONE table: both converge on the store generation
        gens = [(_get_json(u + "/3/Stats", timeout=5.0) or {})
                .get("table_generation") for u in (url_a, url_b)]
        _check(gens[0] is not None and gens[0] == gens[1]
               and gens[0] >= rdoc["table_generation"],
               f"routers disagree on table_generation: {gens} vs "
               f"store {rdoc['table_generation']}")

        storm_out: dict = {}
        storm_stop = threading.Event()

        def storm():
            storm_out.update(run_load_zipf(
                [url_a, url_b], keys, feature_cols, concurrency=4,
                rows_per_request=8, seconds=900.0, zipf_s=1.1, seed=0,
                router=True, stop_event=storm_stop))

        st_thread = threading.Thread(target=storm, daemon=True)
        st_thread.start()
        time.sleep(4.0)                     # storm established

        # -- phase 1: sustained-pressure rebalance (make-before-break)
        hot = next(k for k in reversed(keys) if k not in head_keys
                   and len(rdoc["keys"].get(k) or ()) == 1)
        hot_src = rdoc["keys"][hot][0]
        src_reps = [r for r in st["shards"][hot_src]["replicas"]
                    if r["state"] == "READY"]
        _check(src_reps, f"no READY replica on shard {hot_src}")
        src_url = f"http://127.0.0.1:{src_reps[0]['port']}"
        flood_stop = threading.Event()

        def flood():
            # 1 ms deadlines 504 inside the hot shard's batcher: the
            # per-tenant deadline_504 counter attributes the pressure
            # to `hot` alone — nobody else sheds
            while not flood_stop.is_set():
                _post_raw(src_url, hot, body,
                          headers={"X-H2O-Deadline-Ms": "1"},
                          timeout=10.0)
                time.sleep(0.02)

        fl = threading.Thread(target=flood, daemon=True)
        fl.start()
        mv = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            stx = store.get_status("pool") or {}
            mv = ((stx.get("placement") or {}).get("moves")
                  or {}).get(hot)
            if mv:
                break
            time.sleep(0.3)
        flood_stop.set()
        fl.join(timeout=10)
        _check(mv is not None,
               f"sustained 504 pressure on '{hot}' never triggered a "
               f"rebalance move: {store.get_status('pool')}")
        _check(mv["src"] == hot_src and mv["state"] == "serving",
               f"move record wrong: {mv} (expected src={hot_src}, "
               "state=serving)")
        dst = mv["dst"]

        # make-before-break: while the move is `serving`, BOTH shards
        # serve the tenant and the destination's predictions are
        # bitwise-identical to the source's
        stx = store.get_status("pool")
        dst_reps = [r for r in stx["shards"][dst]["replicas"]
                    if r["state"] == "READY"]
        _check(dst_reps, f"move destination {dst} has no READY "
               "replica — the 'make' half did not hold")
        dst_url = f"http://127.0.0.1:{dst_reps[0]['port']}"
        c_src, b_src = _post_raw(src_url, hot, body)
        c_dst, b_dst = _post_raw(dst_url, hot, body)
        _check(c_src == 200 and c_dst == 200,
               f"mid-move scoring failed: src HTTP {c_src}, "
               f"dst HTTP {c_dst}")
        _check(b_src == b_dst,
               "make-before-break violated: destination predictions "
               f"differ from source (src {b_src[:80]!r} vs dst "
               f"{b_dst[:80]!r})")
        # the routing table prefers dst while src still serves
        deadline = time.monotonic() + 15
        pref: list = []
        while time.monotonic() < deadline:
            rdoc = store.get_routing("pool") or {}
            pref = list((rdoc.get("keys") or {}).get(hot) or ())
            if pref and pref[0] == dst and hot_src in pref:
                break
            time.sleep(0.25)
        _check(pref and pref[0] == dst and hot_src in pref,
               f"mid-move routing should prefer {dst} with {hot_src} "
               f"still serving, got {pref}")

        # -- phase 2: SIGKILL a router AND the lease holder together
        lease = store.get_lease("pool")
        holder, old_epoch = lease["holder"], int(lease["epoch"])
        standby = "op-b" if holder == "op-a" else "op-a"
        pods_before = sorted(p for p, _ in _live_pods_for(workdir))
        procs["router-a"].kill()
        procs[holder].kill()
        lease_at_kill = store.get_lease("pool")   # final heartbeat
        new_lease = None
        deadline = time.monotonic() + ttl + 60
        while time.monotonic() < deadline:
            new_lease = store.get_lease("pool")
            if new_lease and new_lease.get("holder") == standby:
                break
            time.sleep(0.1)
        _check(new_lease is not None
               and new_lease.get("holder") == standby,
               f"standby {standby} never took the lease: {new_lease}")
        _check(int(new_lease["epoch"]) == old_epoch + 1,
               f"takeover must bump the epoch exactly once: "
               f"{old_epoch} -> {new_lease['epoch']}")
        lag = float(new_lease["acquired"]) \
            - float(lease_at_kill["renewed"])
        _check(lag <= ttl + hb + 2.0,
               f"takeover took {lag:.1f}s from the dead holder's last "
               f"heartbeat (ttl={ttl:g} hb={hb:g})")

        # the fence: a routing publish carrying the DEAD holder's
        # epoch must be rejected — split-brain resolves to one writer
        try:
            store.publish_routing("pool", {"keys": {}, "shards": {}},
                                  epoch=old_epoch)
            raise ChaosFailure(
                "a routing publish fenced on the deposed holder's "
                "epoch was ACCEPTED — split-brain is possible")
        except StaleGenerationError:
            pass

        # adoption, not respawn: the new holder converges on the SAME
        # pod pids and its status carries the new epoch
        wait_status(lambda s: s.get("converged")
                    and s.get("lease_epoch") == old_epoch + 1,
                    300, "the new holder to adopt and reconverge")
        pods_after = sorted(p for p, _ in _live_pods_for(workdir))
        _check(pods_after == pods_before,
               f"takeover changed the pod set (respawn/leak): "
               f"{pods_before} -> {pods_after}")
        seen_kinds = set()
        for pool_name in ["pool"] + list(stx["shards"]):
            try:
                seen_kinds.update(e["kind"]
                                  for e in store.events(pool_name))
            except KeyError:
                pass
        _check("replica_adopted" in seen_kinds,
               f"no replica_adopted event after takeover: "
               f"{sorted(seen_kinds)}")

        # -- phase 3: the NEW holder retires the in-flight move (the
        # move record survived takeover through the status doc)
        deadline = time.monotonic() + 120
        retired = False
        while time.monotonic() < deadline:
            stx = store.get_status("pool") or {}
            m3 = ((stx.get("placement") or {}).get("moves")
                  or {}).get(hot)
            if m3 and m3.get("state") == "retired":
                retired = True
                break
            time.sleep(0.3)
        _check(retired,
               f"the new holder never retired the move of '{hot}': "
               f"{(stx.get('placement') or {}).get('moves')}")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rdoc = store.get_routing("pool") or {}
            pref = list((rdoc.get("keys") or {}).get(hot) or ())
            if pref and pref[0] == dst and hot_src not in pref:
                break
            time.sleep(0.25)
        _check(pref and pref[0] == dst and hot_src not in pref,
               f"retired source {hot_src} still routed for '{hot}': "
               f"{pref}")
        code = _score_via_router(url_b, hot, body)
        _check(code == 200, f"moved tenant '{hot}' not serving via "
               f"the surviving router after retirement (HTTP {code})")

        # -- phase 4: loss-driven overrides, then failback hygiene
        rdoc = store.get_routing("pool")
        stx = store.get_status("pool")
        orphan_by_sid = {
            sid: [k for k in keys if k not in head_keys and k != hot
                  and list(rdoc["keys"].get(k) or ()) == [sid]]
            for sid in stx["shards"] if sid != dst}
        vsid = max(orphan_by_sid, key=lambda s: len(orphan_by_sid[s]))
        orphans = orphan_by_sid[vsid]
        _check(len(orphans) >= 2,
               f"shard {vsid} uniquely holds only {len(orphans)} "
               "tail tenants — fixture shape wrong")
        for r in stx["shards"][vsid]["replicas"]:
            if r.get("pid"):
                try:
                    os.kill(r["pid"], signal.SIGKILL)
                except OSError:
                    pass
        store.apply_update(vsid, replicas=0)   # the node pool is gone
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            stx = store.get_status("pool") or {}
            ov = (stx.get("placement") or {}).get("overrides") or {}
            if all(k in ov for k in orphans):
                break
            time.sleep(0.5)
        ov = (stx.get("placement") or {}).get("overrides") or {}
        missing = [k for k in orphans if k not in ov]
        _check(not missing,
               f"{len(missing)}/{len(orphans)} lost tenants never "
               f"re-placed (sample {missing[:5]}): {stx}")
        for k in orphans[:3]:
            code = _score_via_router(url_b, k, body)
            _check(code == 200,
                   f"re-placed tenant '{k}' not serving via a "
                   f"survivor (HTTP {code})")
        # recovery: capacity returns; once the home shard is provably
        # healthy for H2O_TPU_REBALANCE_FAILBACK_S the override copies
        # age out — the overrides map EMPTIES
        store.apply_update(vsid, replicas=1)
        wait_status(lambda s: s.get("converged"), 600,
                    "the recovered shard to reconverge")
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            stx = store.get_status("pool") or {}
            ov = (stx.get("placement") or {}).get("overrides") or {}
            if not ov:
                break
            time.sleep(0.5)
        _check(not ov,
               f"failback never emptied the overrides: {ov}")
        seen_kinds.update(e["kind"] for e in store.events("pool"))
        _check("tenant_failback" in seen_kinds,
               f"no tenant_failback event: {sorted(seen_kinds)}")
        code = _score_via_router(url_b, orphans[0], body)
        _check(code == 200,
               f"failed-back tenant not serving from its home shard "
               f"(HTTP {code})")

        # -- epilogue: the storm's end-to-end contracts
        storm_stop.set()
        st_thread.join(timeout=120)
        _check(storm_out.get("requests", 0) > 300,
               f"Zipf storm barely ran: {storm_out}")
        _check(storm_out["errors"] == 0,
               f"client transport errors across the HA kill: "
               f"{storm_out['error_sample']}")
        _check(storm_out.get("target_failovers", 0) > 0,
               "the router kill never exercised client-side target "
               "failover — the drill timing is broken")
        head_5xx = sum(storm_out["by_model"][k]["fivexx"]
                       for k in head_keys)
        _check(head_5xx == 0,
               f"{head_5xx} 5xx on replicated HEAD tenants across the "
               f"router+holder kill: {storm_out['fivexx_sample']}")
        rst = _get_json(url_b + "/3/Stats", timeout=5.0)
        _check(rst is not None,
               "surviving router /3/Stats unreachable")
        _check(rst["stats"]["retries"] ==
               rst["retry_budget"]["granted"],
               f"retries not token-backed on the surviving router: "
               f"{rst['stats']} {rst['retry_budget']}")
        final_gen = (store.get_routing("pool")
                     or {}).get("table_generation")
        _check(rst.get("table_generation") is not None
               and rst["table_generation"] <= final_gen,
               f"surviving router claims a table generation the store "
               f"never published: {rst.get('table_generation')} > "
               f"{final_gen}")
    finally:
        import signal as _sig

        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            try:
                p.wait(timeout=15)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for pid, _ in _live_pods_for(workdir):
            try:
                os.kill(pid, _sig.SIGKILL)
            except OSError:
                pass
        shutil.rmtree(td, ignore_errors=True)


SCENARIOS = {
    "rolling-update": scenario_rolling_update,
    "replica-kill": scenario_replica_kill,
    "tenant-storm": scenario_tenant_storm,
    "operator-restart": scenario_operator_restart,
    "poison-rollback": scenario_poison_rollback,
    "router-shard-kill": scenario_router_shard_kill,
    "trace-failover": scenario_trace_failover,
    "router-ha-kill": scenario_router_ha_kill,
}


def main(argv: list[str]) -> int:
    global DEVICE
    import argparse

    ap = argparse.ArgumentParser(description="fleet drills on port pods")
    ap.add_argument("names", nargs="*", default=["all"],
                    help=f"drills ({', '.join(SCENARIOS)}) or 'all'")
    ap.add_argument("--card", action="store_true",
                    help="pods serve on the CUDA card (default: cpu)")
    ap.add_argument("--json", default=None,
                    help="write each drill's outcome and seconds here")
    args = ap.parse_args(argv)
    DEVICE = "cuda" if args.card else "cpu"
    names = args.names
    if names == ["all"]:
        names = list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"unknown drill(s): {', '.join(unknown)} — choose from "
              f"{', '.join(SCENARIOS)} or 'all'", file=sys.stderr)
        return 2
    from h2o_kubernetes_tpu_torch.runtime.telemetry import build_info

    print(f"[chaos] build={json.dumps(build_info())} device={DEVICE}",
          flush=True)
    results, rc = [], 0
    for name in names:
        t0 = time.monotonic()
        outcome = "PASS"
        try:
            SCENARIOS[name]()
        except ChaosFailure as e:
            outcome = "FAIL"
            print(f"[chaos] {name}: FAIL — {e}", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 — a crash is also a fail
            import traceback

            traceback.print_exc()
            outcome = "ERROR"
            print(f"[chaos] {name}: ERROR — {e!r}", file=sys.stderr)
        dt = time.monotonic() - t0
        results.append({"drill": name, "outcome": outcome,
                         "seconds": round(dt, 1), "device": DEVICE})
        print(f"[chaos] {name}: {outcome} ({dt:.1f}s)", flush=True)
        if outcome != "PASS":
            rc = 1
            break
    reached = sorted(m for m in sys.modules if m in (
        "jax", "h2o_kubernetes_tpu") or m.startswith(
        ("jax.", "h2o_kubernetes_tpu.")))
    if reached:
        print(f"[chaos] the drills reached the JAX package: {reached}",
              file=sys.stderr)
        rc = 1
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
