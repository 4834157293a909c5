"""Level-triggered reconcile loop over real subprocess scorer pods.

The controller pattern of the reference operator (deployment/
controller.rs watches the H2O CRD and converges StatefulSets), applied
to the serving fleet: every pass re-derives actions from OBSERVED
state (live processes, /healthz, /readyz) against the current spec —
no edge memory, so a missed event can never wedge the pool. The loop
converges on:

- **replica death** — a pod whose process exited (OOM-kill, SIGKILL,
  crash) is recorded (``replica_died``) and replaced next pass;
- **spec resize** — ``replicas`` up spawns, down cordons + drains the
  excess (never a hard kill of a serving replica);
- **artifact change** — ``version`` bump rolls surge-one: spawn ONE
  fresh replica on the new artifact, push + warm it (readyz flips only
  after the pow2 buckets are warmed), and only once it is READY
  cordon one old-version replica, wait the deregister grace (routers
  drop the endpoint; stragglers still get served — that is how the
  drill holds zero 5xx), then SIGTERM it into the drain path;
- **operator restart** — replicas drop pid/port manifests under the
  pool workdir; a fresh Reconciler ADOPTS the live pods it finds
  there (identity-probed via /3/Stats) instead of spawning
  duplicates, before its first reconcile pass;
- **crash loops** — respawns of a failing version are exponentially
  backoff-spaced (``H2O_TPU_POOL_BACKOFF_*``), and a rollout whose
  new version keeps failing readiness auto-rolls-back to the pinned
  last-good version (``H2O_TPU_POOL_ROLLOUT_RETRIES``) — old
  replicas are never disturbed.

Pods are REAL subprocesses running the rest.py serving entry via
``python -m h2o_kubernetes_tpu_torch.operator.pod``: own lifecycle state
machine, SIGTERM drain, breaker, admission queue — exactly what a
kubelet would run; swapping the Popen for a pod template against a
kube API server changes ``ScorerReplica`` only. Pods serve on the CUDA
card (``--device cuda``) unless the ``Reconciler``, ``ShardedPool`` or
``ScorerReplica`` is given ``device="cpu"``; without a card the
constructor raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

from dataclasses import replace as _dc_replace

from ..runtime.retry import _env_float
from .placement import (PlacementPlan, move_destination,
                        plan_placement, shard_preference)
from .probe import probe_json
from .registry import ModelRegistry
from .spec import PoolStore, ScorerPoolSpec, StaleGenerationError

__all__ = ["Reconciler", "ScorerReplica", "AdoptedReplica",
           "ShardedPool", "PENDING", "STARTING", "LOADING", "READY",
           "CORDONED", "DRAINING", "DEAD"]

PENDING = "PENDING"        # created, not yet spawned
STARTING = "STARTING"      # process up, waiting for /healthz
LOADING = "LOADING"        # artifact push + warm-up in flight
READY = "READY"            # /readyz green (artifact warmed)
CORDONED = "CORDONED"      # readiness off, serving stragglers (grace)
DRAINING = "DRAINING"      # SIGTERM sent, drain in progress
DEAD = "DEAD"              # process gone (observed or forced)

# states that count toward (future) serving capacity — cordoned and
# draining replicas are on their way OUT and never count
CAPACITY_STATES = (STARTING, LOADING, READY)


def _interval() -> float:
    return max(0.05, _env_float("H2O_TPU_POOL_RECONCILE_INTERVAL", 0.5))


def _startup_deadline() -> float:
    return max(1.0, _env_float("H2O_TPU_POOL_STARTUP_DEADLINE", 180.0))


def _deregister_grace() -> float:
    return max(0.0, _env_float("H2O_TPU_POOL_DEREGISTER_GRACE", 0.75))


def _probe_timeout() -> float:
    """Per-probe cap on every reconciler health/readyz//3/Stats
    scrape: one hung replica must not stall the whole pass (and with
    it death-detection for its siblings). Shared with the router's
    health sweeps — operator/probe.py is the one implementation."""
    from .probe import probe_timeout

    return probe_timeout()


def _backoff_base() -> float:
    return max(0.0, _env_float("H2O_TPU_POOL_BACKOFF_BASE", 0.5))


def _backoff_cap() -> float:
    return max(0.1, _env_float("H2O_TPU_POOL_BACKOFF_MAX", 30.0))


def _backoff_window() -> float:
    """Seconds a failure stays in the backoff history; a version that
    has run clean this long respawns immediately again."""
    return max(1.0, _env_float("H2O_TPU_POOL_BACKOFF_WINDOW", 120.0))


def _rollout_retries() -> int:
    return max(1, int(_env_float("H2O_TPU_POOL_ROLLOUT_RETRIES", 3)))


def _rebalance_enabled() -> bool:
    """Hot-shard rebalancing kill switch (default OFF: moving tenants
    under load is an operator policy, not a default behavior)."""
    return _env_float("H2O_TPU_REBALANCE", 0.0) > 0


def _rebalance_sustain() -> int:
    """Consecutive pressure passes before a move fires — one shed
    burst must not trigger a tenant migration."""
    return max(1, int(_env_float("H2O_TPU_REBALANCE_SUSTAIN", 3)))


def _rebalance_cooldown() -> float:
    """Seconds between moves, fleet-wide: rebalancing converges one
    tenant at a time, never a thundering migration."""
    return max(0.0, _env_float("H2O_TPU_REBALANCE_COOLDOWN", 30.0))


def _rebalance_retire_s() -> float:
    """make-before-break dwell: how long the SOURCE keeps serving a
    moved tenant after the destination went live (routers refresh
    their table within a health sweep; this must outlast one)."""
    return max(0.0, _env_float("H2O_TPU_REBALANCE_RETIRE_S", 5.0))


def _rebalance_failback_s() -> float:
    """How long a re-placed tenant's home shard must stay healthy
    before the override copies age out (failback hygiene)."""
    return max(0.0, _env_float("H2O_TPU_REBALANCE_FAILBACK_S", 30.0))


def _log_max_bytes() -> int:
    return int(_env_float("H2O_TPU_POOL_LOG_MAX_BYTES", 8 << 20))


def _log_keep() -> int:
    return max(2, int(_env_float("H2O_TPU_POOL_LOG_KEEP", 16)))


def _pod_device(device=None) -> str:
    """The ``--device`` a pod is started with: ``None`` is the card
    (raises without one), ``"cpu"`` the CPU. Checked here so a pool
    without a card fails at construction, not as a crash-looping pod;
    the controller itself opens no CUDA context."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the pods; "
                           "pass device='cpu' to run them on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return str(dev)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ScorerReplica:
    """One subprocess scorer pod + this controller's view of it.

    All process/HTTP interaction lives here so the Reconciler is pure
    orchestration — tests drive it with fake replicas implementing
    this surface."""

    def __init__(self, rid: str, version: int, spec: ScorerPoolSpec,
                 log_dir: str | None = None,
                 manifest_dir: str | None = None,
                 pool: str | None = None, port: int | None = None,
                 device=None):
        self.rid = rid
        self.device = _pod_device(device)
        self.version = int(version)
        self.model_key = spec.model_key
        self.artifact = spec.artifact
        self.pool = pool or spec.name
        self.manifest_dir = manifest_dir
        # the FULL tenant set this replica must serve (primary pinned
        # to the rollout version + every extra artifact): pushed as
        # one required-set so /readyz can't flip mid-push
        self.artifacts = [(spec.artifact, int(version), spec.model_key,
                           spec.slo)]
        for ent in spec.all_artifacts()[1:]:
            self.artifacts.append(ent)
        # None = the replica resolves H2O_TPU_POOL_WARM_BUCKETS itself
        self.warm_buckets = None if spec.warm_buckets is None \
            else tuple(spec.warm_buckets)
        self.env_overrides = dict(spec.env)
        self.log_dir = log_dir
        self.port = _free_port() if port is None else int(port)
        self.proc: subprocess.Popen | None = None
        self.state = PENDING
        self.created_at = time.monotonic()
        self.cordoned_at = 0.0
        self.drain_at = 0.0
        self._log_f = None
        self._load_thread: threading.Thread | None = None
        self._load_err: str | None = None
        self._load_done = False

    # -- process --------------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def manifest_path(self) -> str | None:
        if not self.manifest_dir:
            return None
        return os.path.join(self.manifest_dir, f"{self.rid}.json")

    def _write_manifest(self) -> None:
        """Drop the pidfile/port manifest a restarted operator adopts
        from. Written by
        the controller at spawn (it knows rid/version) and rewritten
        by the pod itself once up (authoritative pid)."""
        path = self.manifest_path()
        if path is None:
            return
        os.makedirs(self.manifest_dir, exist_ok=True)
        doc = {"rid": self.rid, "pool": self.pool,
               "pid": self.proc.pid, "port": self.port,
               "version": self.version, "model_key": self.model_key,
               "created_at": time.time()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def _remove_manifest(self) -> None:
        path = self.manifest_path()
        if path:
            try:
                os.remove(path)
            except OSError:
                pass

    def _rotate_logs(self) -> None:
        """Size cap + rotate-on-respawn: an oversized log from a
        previous life of this rid rolls to `.1` before the fresh
        process reopens it. Dir-wide pruning is the RECONCILER's job
        (it knows which rids are live — see `_prune_logs`)."""
        if not self.log_dir:
            return
        mine = os.path.join(self.log_dir, f"{self.rid}.log")
        try:
            if os.path.getsize(mine) > _log_max_bytes():
                os.replace(mine, mine + ".1")
        except OSError:
            pass

    def spawn(self) -> None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env.update(self.env_overrides)
        env["H2O_TPU_POOL_REPLICA"] = "1"
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            self._rotate_logs()
            self._log_f = open(os.path.join(
                self.log_dir, f"{self.rid}.log"), "ab")
            out = self._log_f
        argv = [sys.executable, "-m",
                "h2o_kubernetes_tpu_torch.operator.pod",
                "--port", str(self.port),
                "--pool", self.pool, "--rid", self.rid,
                "--device", self.device]
        man = self.manifest_path()
        if man is not None:
            # on the pod's OWN cmdline so (a) it can rewrite the
            # manifest with its authoritative pid, and (b) the
            # test preflight can tell an ADOPTABLE orphan (live
            # manifest) from a leaked one (reap)
            argv += ["--manifest", man]
        self.proc = subprocess.Popen(
            argv, env=env, cwd=repo, stdout=out, stderr=out,
            start_new_session=True)
        if man is not None:
            self._write_manifest()
        self.state = STARTING
        self.created_at = time.monotonic()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def mark_dead(self) -> None:
        self.state = DEAD
        self._remove_manifest()
        if self._log_f is not None:
            try:
                self._log_f.close()
            except OSError:
                pass
            self._log_f = None

    # -- HTTP -----------------------------------------------------------------

    def _get_json(self, path: str, timeout: float | None = None):
        try:
            with urllib.request.urlopen(
                    self.url + path,
                    timeout=_probe_timeout() if timeout is None
                    else timeout) as r:
                return json.loads(r.read())
        except Exception:  # noqa: BLE001 — down/unready both read None
            return None

    def healthz_ok(self) -> bool:
        out = self._get_json("/healthz")
        return bool(out and out.get("alive"))

    def readyz_ok(self) -> bool:
        out = self._get_json("/readyz")
        return bool(out and out.get("ready"))

    def stats(self) -> dict | None:
        # the shared probe helper (3 attempts inside one probe
        # timeout each): an autoscale scrape that lands mid scoring
        # burst must not read a healthy replica as gone
        return probe_json(self.url, "/3/Stats", retries=3)

    def loaded_version(self) -> int | None:
        out = self._get_json("/3/ModelRegistry")
        if not out:
            return None
        info = (out.get("models") or {}).get(self.model_key)
        return info.get("version") if info else None

    # -- artifact push (background: warm-up builds take seconds) -----------

    def start_load(self, registry: ModelRegistry) -> None:
        self.state = LOADING

        def push():
            try:
                # the whole tenant set (primary + extras), required-
                # set declared first: readiness flips only after
                # EVERY artifact is loaded + warmed
                registry.push_many(self.url, self.artifacts,
                                   warm_buckets=self.warm_buckets,
                                   timeout=_startup_deadline())
            except Exception as e:  # noqa: BLE001 — reconciler decides
                self._load_err = repr(e)[:300]
            finally:
                self._load_done = True

        self._load_thread = threading.Thread(
            target=push, name=f"h2o-torch-pool-push-{self.rid}",
            daemon=True)
        self._load_thread.start()

    def load_finished(self) -> bool:
        return self._load_done

    def load_error(self) -> str | None:
        return self._load_err

    # -- retirement -----------------------------------------------------------

    def cordon(self) -> None:
        """Endpoint removal: readiness off, admission stays open."""
        try:
            req = urllib.request.Request(
                self.url + "/3/Cordon",
                data=json.dumps({"reason": "rollout"}).encode(),
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5.0):
                pass
        except Exception:  # noqa: BLE001 — a dead pod cordons itself
            pass
        self.state = CORDONED
        self.cordoned_at = time.monotonic()

    def terminate(self) -> None:
        """SIGTERM → the pod's drain path (flush batcher, settle
        jobs, exit 0 inside H2O_TPU_DRAIN_TIMEOUT)."""
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.terminate()
            except ProcessLookupError:
                pass
        self.state = DRAINING
        self.drain_at = time.monotonic()

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.kill()
            except ProcessLookupError:
                pass


class AdoptedReplica(ScorerReplica):
    """A live pod inherited from a DEAD operator: same HTTP surface,
    but there is no Popen handle — liveness is pid-probed and signals
    go through os.kill. Everything else (push, cordon, the state
    machine) behaves exactly like a spawned replica, so adoptees ride
    the normal convergence path (a stale-version adoptee is cordoned +
    replaced by the standard surge-one rollout)."""

    def __init__(self, manifest: dict, version: int,
                 spec: ScorerPoolSpec, log_dir: str | None = None,
                 manifest_dir: str | None = None, device=None):
        super().__init__(manifest["rid"], version, spec,
                         log_dir=log_dir, manifest_dir=manifest_dir,
                         pool=manifest.get("pool"),
                         port=manifest["port"], device=device)
        self._pid = int(manifest["pid"])

    def spawn(self) -> None:   # pragma: no cover — adoptees exist
        raise RuntimeError("an adopted replica is already running")

    def alive(self) -> bool:
        try:
            os.kill(self._pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:   # pragma: no cover — exists, not ours
            return True

    def pid(self) -> int | None:
        return self._pid

    def terminate(self) -> None:
        import signal

        try:
            os.kill(self._pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        self.state = DRAINING
        self.drain_at = time.monotonic()

    def kill(self) -> None:
        import signal

        try:
            os.kill(self._pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


class Reconciler:
    """Converge a pool of ScorerReplicas to its ScorerPoolSpec."""

    def __init__(self, store: PoolStore, registry: ModelRegistry,
                 pool: str, log_dir: str | None = None,
                 replica_factory=None, workdir: str | None = None,
                 adopted_factory=None, device=None):
        self.store = store
        self.device = _pod_device(device)
        self.registry = registry
        self.pool = pool
        # workdir: the pool's on-disk anchor — pod manifests (and, by
        # default, logs) live under it so a RESTARTED operator can
        # find its predecessor's pods. No workdir = no adoption
        # (a pool that does not survive its controller).
        self.workdir = workdir
        self.manifest_dir = os.path.join(workdir, "pods") \
            if workdir else None
        self.log_dir = log_dir if log_dir is not None else (
            os.path.join(workdir, "logs") if workdir else None)
        # injectable for tests: factory(rid, version, spec) -> replica
        self.replica_factory = replica_factory or (
            lambda rid, version, spec: ScorerReplica(
                rid, version, spec, log_dir=self.log_dir,
                manifest_dir=self.manifest_dir, pool=self.pool,
                device=self.device))
        self.adopted_factory = adopted_factory or (
            lambda manifest, version, spec: AdoptedReplica(
                manifest, version, spec, log_dir=self.log_dir,
                manifest_dir=self.manifest_dir, device=self.device))
        self.replicas: list = []
        self._seq = 0
        self._last_totals: dict | None = None   # autoscale deltas
        # shard-aware autoscale: when set (ShardedPool wires it to the
        # shard's placed tenant set), the cumulative pressure counters
        # come from THOSE tenants' per-model stats — the shard whose
        # tenants shed scales, not whichever shard shares a counter
        self.autoscale_keys: set | None = None
        self._lock = threading.Lock()           # replicas list mutation
        self._stopped = False                   # shutdown() flips it
        self._adopted = False                   # adopt_existing ran
        # crash-loop backoff: version -> recent failure monotonics
        # (windowed — spacing) and cumulative counts (rollback trigger)
        self._failures: dict[int, list[float]] = {}
        self._fail_counts: dict[int, int] = {}
        self._backoff_announced: float = 0.0
        # rollout rollback: failed spec version -> pinned last-good
        self._rollback: dict[int, int] = {}
        self._last_good: int | None = None
        # a restarted operator resumes rollback/last-good state from
        # the durable store's status instead of re-trying a version
        # that already rolled back
        st = store.get_status(pool)
        if st.get("last_good_version") is not None:
            self._last_good = int(st["last_good_version"])
        ro = st.get("rollout") or {}
        if ro.get("failed_version") is not None and \
                ro.get("pinned_version") is not None:
            self._rollback[int(ro["failed_version"])] = \
                int(ro["pinned_version"])

    # -- events / status ------------------------------------------------------

    def _event(self, kind: str, msg: str = "") -> None:
        self.store.record_event(self.pool, kind, msg)
        # re-registered through the fleet-telemetry registry too:
        # the durable store keeps the bounded event ring, /metrics
        # (h2o_operator_events_total{event=...}) keeps the rates
        from ..runtime.telemetry import count_event

        count_event(kind)
        from ..diagnostics import log

        log.warning("operator[%s]: %s %s", self.pool, kind, msg)

    def endpoints(self) -> list[str]:
        """Routable endpoint URLs — the Service-endpoints analog.
        Cordoned/draining replicas are OUT the instant they cordon;
        not-yet-ready ones are included (the load generator's
        readiness poller filters on /readyz, like kube-proxy on
        endpoint readiness)."""
        with self._lock:
            return [r.url for r in self.replicas
                    if r.state in CAPACITY_STATES]

    def status(self) -> dict:
        with self._lock:
            reps = list(self.replicas)
        return {
            "replicas": [{"id": r.rid, "state": r.state,
                          "version": r.version, "port": r.port,
                          "pid": r.pid()} for r in reps],
            "ready": sum(1 for r in reps if r.state == READY),
        }

    def _want_version(self, spec: ScorerPoolSpec) -> int:
        """The version this pool should actually converge on: the
        spec's, unless that version auto-rolled-back — then the pinned
        last-good version until the spec moves to a NEW version."""
        return self._rollback.get(spec.version, spec.version)

    def converged(self, spec: ScorerPoolSpec | None = None) -> bool:
        if spec is None:
            spec, _ = self.store.get(self.pool)
        want = self._want_version(spec)
        with self._lock:
            reps = list(self.replicas)
        # alive() is checked HERE, not just at reconcile time: a
        # replica SIGKILLed an instant ago is still READY in controller
        # state until the next pass observes it, and a wait_converged
        # racing that pass must not declare victory over a dead pod
        current_ready = [r for r in reps if r.state == READY
                         and r.version == want and r.alive()]
        leftovers = [r for r in reps if r.state != DEAD
                     and not (r.state == READY
                              and r.version == want
                              and r.alive())]
        return len(current_ready) == spec.replicas and not leftovers

    # -- adoption (operator restart) ------------------------------------------

    def _probe_stats(self, url: str) -> dict | None:
        """GET /3/Stats off a candidate adoptee — identity fields
        (pool/replica/pid), lifecycle state, and loaded model versions
        in one device-free scrape, through the shared probe helper
        (probe timeout + 3 attempts: one timed-out scrape under a
        scoring burst must not get a healthy pod killed). Injectable
        for tests."""
        return probe_json(url, "/3/Stats", retries=3)

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(int(pid), 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:   # pragma: no cover
            return True

    def scan_manifests(self) -> list[dict]:
        """Valid pod manifests under the pool workdir (pidfile/port
        records dropped at spawn). Unparseable files are removed —
        only the atomic writer produces them, so garbage is foreign."""
        if not self.manifest_dir:
            return []
        out = []
        try:
            names = sorted(os.listdir(self.manifest_dir))
        except OSError:
            return []
        for n in names:
            if not n.endswith(".json"):
                continue
            path = os.path.join(self.manifest_dir, n)
            try:
                with open(path) as f:
                    doc = json.load(f)
                if not all(k in doc for k in
                           ("rid", "pool", "pid", "port")):
                    raise ValueError("missing keys")
            except (OSError, ValueError):
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            if doc.get("pool") == self.pool:
                out.append(doc)
        return out

    def adopt_existing(self) -> int:
        """Adopt this pool's still-live pods after an operator restart
        instead of spawning duplicates. For every
        manifest: dead pid → stale, cleaned up; live + identity match
        (pool/rid/pid off /3/Stats) → adopted in its OBSERVED state —
        READY at its loaded version (a stale version is then rolled
        through normal convergence), cordoned stays CORDONED (drains
        after the grace), mid-load orphans restart the push as
        STARTING; identity mismatch → the process is left alone but
        the manifest is dropped (port reuse by a stranger); live but
        unresponsive → killed (it cannot serve and nothing else will
        ever reap it). Returns the number of pods adopted. Runs once,
        BEFORE the first reconcile pass (run() enforces the order)."""
        self._adopted = True
        if not self.manifest_dir:
            return 0
        spec, _ = self.store.get(self.pool)
        want = self._want_version(spec)
        adopted = 0
        with self._lock:
            known = {r.rid for r in self.replicas}
        for man in self.scan_manifests():
            rid, pid, port = man["rid"], man["pid"], man["port"]
            if rid in known:
                continue
            path = os.path.join(self.manifest_dir, f"{rid}.json")
            if not self._pid_alive(pid):
                self._event("adoption_stale",
                            f"{rid} manifest pid {pid} is gone — "
                            "cleaned up")
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            # _probe_stats retries internally (the shared probe
            # helper): killing a live pod on ONE timed-out scrape
            # (GIL-bound scoring burst, transient reset) would break
            # the 'data plane never notices' contract adoption exists
            # for
            st = self._probe_stats(f"http://127.0.0.1:{port}")
            ident = (st or {}).get("identity") or {}
            if st is not None and (
                    ident.get("pool") != self.pool
                    or ident.get("replica") != rid
                    or (ident.get("pid") is not None
                        and int(ident["pid"]) != int(pid))):
                self._event("adoption_foreign",
                            f"{rid}: port {port} answers as "
                            f"{ident.get('pool')}/{ident.get('replica')}"
                            " — not ours, manifest dropped")
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            if st is None:
                age = time.time() - float(man.get("created_at") or 0)
                if 0 <= age <= _startup_deadline():
                    # live pid, HTTP not up YET: spawned moments
                    # before the old operator died — adopt as
                    # STARTING; the normal startup deadline replaces
                    # it if it never comes up
                    r = self.adopted_factory(man, want, spec)
                    r.created_at = time.monotonic()
                    r.state = STARTING
                    with self._lock:
                        self.replicas.append(r)
                    adopted += 1
                    self._event("replica_adopted",
                                f"{rid} pid {pid} port {port} adopted "
                                "(still booting)")
                    continue
                # live pid, dead HTTP, well past any boot window: it
                # can never serve and no other process will ever reap
                # it — kill, then replace via the normal spawn path
                self._event("adoption_unresponsive",
                            f"{rid} pid {pid} alive but /3/Stats "
                            f"unreachable after {age:.0f}s — killing")
                try:
                    import signal

                    os.kill(int(pid), signal.SIGKILL)
                except OSError:
                    pass
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            loaded = ((st.get("registry") or {})
                      .get(spec.model_key) or {}).get("version")
            cordoned = (st.get("cordoned") or
                        any("cordon" in str(rs)
                            for rs in st.get("reasons") or ()))
            if st.get("ready") and loaded is not None:
                r = self.adopted_factory(man, int(loaded), spec)
                r.state = READY
                note = f"READY v{loaded}"
            elif cordoned:
                r = self.adopted_factory(
                    man, int(loaded or man.get("version") or want),
                    spec)
                r.cordoned_at = time.monotonic()
                r.state = CORDONED
                note = "cordoned — resuming drain"
            else:
                # mid-load orphan: its pusher died with the old
                # operator; adopt at the TARGET version and re-drive
                # the push through the normal STARTING path (the load
                # route is idempotent)
                r = self.adopted_factory(man, want, spec)
                r.created_at = time.monotonic()
                r.state = STARTING
                note = "mid-load — re-pushing"
            with self._lock:
                self.replicas.append(r)
            adopted += 1
            self._event("replica_adopted",
                        f"{rid} pid {pid} port {port} adopted "
                        f"({note})")
        # rid sequence must clear every adopted rid or a fresh spawn
        # would collide with a live pod's identity
        with self._lock:
            for r in self.replicas:
                tail = r.rid.rsplit("-", 1)[-1]
                if tail.isdigit():
                    self._seq = max(self._seq, int(tail))
        return adopted

    # -- crash-loop backoff + rollout rollback --------------------------------

    def _record_failure(self, version: int) -> None:
        """One non-graceful replica failure (unexpected exit, load
        failure, startup timeout) of `version`: feeds BOTH the
        windowed backoff history (respawn spacing) and the cumulative
        per-version count (the rollback trigger)."""
        now = time.monotonic()
        window = _backoff_window()
        hist = self._failures.setdefault(int(version), [])
        hist[:] = [t for t in hist if now - t <= window]
        hist.append(now)
        self._fail_counts[int(version)] = \
            self._fail_counts.get(int(version), 0) + 1

    def _backoff_remaining(self, version: int, now: float) -> float:
        """Seconds until a replacement of `version` may spawn. The
        FIRST failure in the window replaces immediately (a one-off
        OOM-kill must not slow recovery — the replica-kill drill's
        contract); from the second on, base·2^(n-2) capped at
        H2O_TPU_POOL_BACKOFF_MAX — a crash loop becomes spaced
        respawns instead of a hot loop."""
        hist = self._failures.get(int(version))
        if not hist:
            return 0.0
        window = _backoff_window()
        hist[:] = [t for t in hist if now - t <= window]
        n = len(hist)
        if n < 2:
            return 0.0
        delay = min(_backoff_cap(), _backoff_base() * (2 ** (n - 2)))
        return max(0.0, hist[-1] + delay - now)

    def _maybe_rollback(self, spec: ScorerPoolSpec) -> None:
        """Auto-rollback: when the rollout's new version has failed
        its warm-up/readiness H2O_TPU_POOL_ROLLOUT_RETRIES times and a
        last-good version exists, pin the pool to last-good. Old
        replicas are never disturbed; the spec stays at the failed
        version (the operator's declared intent is preserved and a
        NEW version bump supersedes the pin)."""
        want = spec.version
        if want in self._rollback or self._last_good is None \
                or self._last_good == want:
            return
        if self._fail_counts.get(want, 0) < _rollout_retries():
            return
        self._rollback = {want: self._last_good}
        self._event("rollout_rolled_back",
                    f"v{want} failed readiness "
                    f"{self._fail_counts[want]} times — pool pinned "
                    f"to last-good v{self._last_good}; push a new "
                    "version to retry")

    # -- the loop -------------------------------------------------------------

    def _prune_logs(self) -> None:
        """Cap the pool log dir so a crash-looping pod cannot fill the
        disk the durable store lives on: keep the newest
        H2O_TPU_POOL_LOG_KEEP files, but NEVER delete a live
        replica's open log (its fd would keep writing to an unlinked
        inode and the crash-diagnosis artifact would be silently
        lost)."""
        if not self.log_dir:
            return
        with self._lock:
            live = {r.rid for r in self.replicas if r.state != DEAD}
        try:
            logs = sorted(
                (os.path.join(self.log_dir, n)
                 for n in os.listdir(self.log_dir)
                 if ".log" in n
                 and n.split(".log", 1)[0] not in live),
                key=lambda p: os.path.getmtime(p))
        except OSError:
            return
        for stale in logs[:max(0, len(logs) - _log_keep())]:
            try:
                os.remove(stale)
            except OSError:
                pass

    def _spawn(self, version: int, spec: ScorerPoolSpec):
        self._prune_logs()
        with self._lock:
            if self._stopped:
                return None
            self._seq += 1
            rid = f"{self.pool}-{self._seq}"
        r = self.replica_factory(rid, version, spec)
        r.spawn()
        with self._lock:
            if self._stopped:
                # shutdown() completed between the check above and the
                # Popen: the torn-down pool must not gain a live pod
                # nothing will ever terminate — kill it right here
                r.kill()
                r.mark_dead()
                return None
            self.replicas.append(r)
        self._event("replica_start",
                    f"{rid} v{version} port={getattr(r, 'port', '?')}")
        return r

    def reconcile_once(self) -> None:
        if self._stopped:
            # shutdown() won the race with a still-running run() loop:
            # reconciling now would re-provision the pool it just tore
            # down and leak pods past the caller's teardown
            return
        spec, gen = self.store.get(self.pool)
        now = time.monotonic()
        deadline = _startup_deadline()
        grace = _deregister_grace()

        # 1. observe process deaths (replica-kill converges from here)
        for r in list(self.replicas):
            if r.state in (DEAD, PENDING):
                continue
            if not r.alive():
                if r.state == DRAINING:
                    self._event("replica_exit",
                                f"{r.rid} drained and exited")
                elif r.state == CORDONED:
                    self._event("replica_exit",
                                f"{r.rid} exited while cordoned")
                else:
                    self._event("replica_died",
                                f"{r.rid} v{r.version} "
                                f"(port {r.port}) exited unexpectedly")
                    self._record_failure(r.version)
                r.mark_dead()
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r.state != DEAD]

        # 2. advance startups: healthz → push+warm → readyz
        for r in self.replicas:
            if r.state == STARTING:
                if r.healthz_ok():
                    r.start_load(self.registry)
                    buckets = "env default" if r.warm_buckets is None \
                        else str(list(r.warm_buckets))
                    self._event("replica_load",
                                f"{r.rid} pushing {r.artifact} "
                                f"v{r.version} + warming {buckets}")
                elif now - r.created_at > deadline:
                    self._event("replica_startup_timeout",
                                f"{r.rid} no /healthz after "
                                f"{deadline:.0f}s — replacing")
                    self._record_failure(r.version)
                    r.kill()
                    r.mark_dead()
            elif r.state == LOADING:
                err = r.load_error()
                if err is not None:
                    self._event("replica_load_failed",
                                f"{r.rid}: {err}")
                    self._record_failure(r.version)
                    r.kill()
                    r.mark_dead()
                elif r.load_finished() and r.readyz_ok():
                    r.state = READY
                    # the version provably serves: clear its failure
                    # history so one old flake can't feed a later
                    # rollback, and remember it as rollback target
                    self._failures.pop(r.version, None)
                    self._fail_counts.pop(r.version, None)
                    self._event("replica_ready",
                                f"{r.rid} v{r.version} warmed — "
                                "readyz green")
                elif now - r.created_at > deadline:
                    self._event("replica_startup_timeout",
                                f"{r.rid} not READY after "
                                f"{deadline:.0f}s — replacing")
                    self._record_failure(r.version)
                    r.kill()
                    r.mark_dead()
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r.state != DEAD]

        # 3. cordoned replicas past the deregister grace drain now;
        # wedged drains get SIGKILL well past the pod's own budget
        drain_budget = _env_float("H2O_TPU_DRAIN_TIMEOUT", 30.0)
        for r in self.replicas:
            if r.state == CORDONED and now - r.cordoned_at >= grace:
                r.terminate()
                self._event("replica_drain",
                            f"{r.rid} SIGTERM after {grace:.2f}s "
                            "deregister grace")
            elif r.state == DRAINING and \
                    now - r.drain_at > drain_budget + 15.0:
                self._event("replica_drain_wedged",
                            f"{r.rid} still alive "
                            f"{drain_budget + 15:.0f}s after SIGTERM "
                            "— SIGKILL")
                r.kill()

        # 4. converge version + count (surge-one rolling update).
        # A rollout whose new version keeps failing rolls back to the
        # pinned last-good version; respawns of a crash-looping
        # version are backoff-spaced instead of hot-looped.
        self._maybe_rollback(spec)
        want = self._want_version(spec)
        # stale replicas that never went READY are superseded work —
        # kill outright, nothing routes to them
        for r in list(self.replicas):
            if r.version != want and r.state in (STARTING, LOADING):
                self._event("replica_superseded",
                            f"{r.rid} v{r.version} superseded by "
                            f"v{want} before READY")
                r.kill()
                r.mark_dead()
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r.state != DEAD]
        capacity = [r for r in self.replicas
                    if r.state in CAPACITY_STATES]
        current = [r for r in capacity if r.version == want]
        stale_ready = [r for r in capacity
                       if r.version != want and r.state == READY]
        ready = [r for r in capacity if r.state == READY]

        backoff_left = 0.0
        if len(current) < spec.replicas and \
                len(capacity) < spec.replicas + 1:
            backoff_left = self._backoff_remaining(want, now)
            if backoff_left <= 0.0:
                # scale up / replace dead / surge the rollout — one
                # spawn per pass keeps the surge at one
                self._spawn(want, spec)
            elif now >= self._backoff_announced:
                n = len(self._failures.get(want, ()))
                self._event("crash_loop_backoff",
                            f"v{want} failed {n}x recently — next "
                            f"respawn in {backoff_left:.2f}s")
                # announce once per wait, not every 0.5s pass
                self._backoff_announced = now + backoff_left
        elif stale_ready and len(ready) > spec.replicas:
            # a new-version replica is READY beyond the desired count:
            # retire ONE old-version replica — cordon first (routers
            # drop the endpoint), drain after the grace (step 3)
            victim = stale_ready[0]
            victim.cordon()
            self._event("replica_cordon",
                        f"{victim.rid} v{victim.version} cordoned "
                        f"(rollout to v{want})")
        elif not stale_ready and len(current) > spec.replicas:
            # spec resize down: prefer retiring a not-yet-ready spare
            spares = [r for r in current if r.state != READY]
            if spares:
                victim = spares[-1]
                self._event("replica_scaled_down",
                            f"{victim.rid} (not yet ready) stopped — "
                            f"replicas={spec.replicas}")
                victim.kill()
                victim.mark_dead()
            else:
                victim = current[-1]
                victim.cordon()
                self._event("replica_cordon",
                            f"{victim.rid} cordoned (scale down to "
                            f"{spec.replicas})")
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r.state != DEAD]

        # 5. publish observed status (generation-fenced: if another
        # controller bumped the spec since this pass read it, OUR view
        # is stale — drop the write, the next pass re-reads)
        conv = self.converged(spec)
        if conv:
            # every desired replica READY on the effective version:
            # this version provably serves — the rollback target
            self._last_good = want
        st = self.status()
        by_version: dict[str, int] = {}
        for r in st["replicas"]:
            if r["state"] == READY:
                by_version[str(r["version"])] = \
                    by_version.get(str(r["version"]), 0) + 1
        status = {
            "generation_observed": gen,
            "desired_replicas": spec.replicas,
            "desired_version": spec.version,
            "effective_version": want,
            "last_good_version": self._last_good,
            "ready_by_version": by_version,
            "converged": conv,
            **st,
        }
        if spec.version in self._rollback:
            status["rollout"] = {
                "failed_version": spec.version,
                "pinned_version": self._rollback[spec.version],
                "state": "rolled_back",
            }
        if backoff_left > 0.0:
            status["crash_loop"] = {
                "version": want,
                "recent_failures": len(self._failures.get(want, ())),
                "next_spawn_in": round(backoff_left, 3),
            }
        from .spec import StaleGenerationError

        try:
            self.store.set_status(self.pool, status, fence=gen)
        except StaleGenerationError:
            pass

    def run(self, stop: threading.Event,
            interval: float | None = None) -> None:
        """Blocking loop (callers thread it); autoscale piggybacks on
        the same cadence when the spec opts in. Adoption runs FIRST:
        reconciling before the predecessor's pods are adopted would
        spawn duplicates of every live pod."""
        if not self._adopted:
            try:
                self.adopt_existing()
            except Exception as e:  # noqa: BLE001 — loop must start
                self._event("adoption_error", repr(e)[:300])
        while not stop.is_set():
            try:
                self.reconcile_once()
                self.autoscale_once()
            except Exception as e:  # noqa: BLE001 — the loop survives
                self._event("reconcile_error", repr(e)[:300])
            stop.wait(interval if interval is not None else _interval())

    def wait_converged(self, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.converged():
                return True
            time.sleep(0.1)
        return self.converged()

    def shutdown(self, timeout: float = 60.0) -> None:
        """Drain every replica (tests/drills teardown): stop
        reconciling first (a racing run() pass must not re-provision
        what this tears down), SIGTERM all, SIGKILL stragglers at the
        deadline."""
        with self._lock:
            # one atomic step: after this, _spawn either sees _stopped
            # (and kills its own pod) or its replica is in this
            # snapshot — no pod can fall between the two
            self._stopped = True
            reps = list(self.replicas)
        for r in reps:
            if r.state not in (DEAD,):
                r.terminate()
        deadline = time.monotonic() + timeout
        for r in reps:
            while r.alive() and time.monotonic() < deadline:
                time.sleep(0.1)
            if r.alive():
                r.kill()
            r.mark_dead()
        with self._lock:
            self.replicas = []

    # -- autoscale ------------------------------------------------------------

    def autoscale_once(self) -> int | None:
        """Scrape /3/Stats off READY replicas and apply the autoscale
        signal to the spec (when ``spec.autoscale``); returns the new
        desired count or None when disabled/unchanged."""
        spec, _ = self.store.get(self.pool)
        if not spec.autoscale:
            return None
        with self._lock:
            ready = [r for r in self.replicas if r.state == READY]
        samples = [s for s in (r.stats() for r in ready) if s]
        from .autoscale import desired_replicas

        desired, why, totals = desired_replicas(
            spec, samples, self._last_totals,
            model_keys=self.autoscale_keys)
        self._last_totals = totals
        if desired != spec.replicas:
            self.store.apply_update(self.pool, replicas=desired)
            self._event("autoscale",
                        f"replicas {spec.replicas} -> {desired} "
                        f"({why})")
            return desired
        return None


# ---------------------------------------------------------------------------
# Sharded pools: placement + re-placement over child reconcilers
# ---------------------------------------------------------------------------


class ShardedPool:
    """A tenant-sharded fleet: one child Reconciler per shard, each
    converging a child pool that holds only the tenants placement put
    there (operator/placement.py — rendezvous hashing, the Zipf head
    replicated on every shard, the tail on ``tail_replicas``), plus
    the failure half:

    - **shard health** is derived from the children's observed state
      (a shard with zero live READY replicas is DOWN);
    - **re-placement**: a tail tenant whose every placed shard is down
      is re-placed onto the next surviving shard in its rendezvous
      preference order — a TARGETED ``registry.push`` of that one
      artifact to the survivor's live replicas (never a full-catalog
      re-push), the survivor's child spec extended so future spawns of
      that shard keep serving it, and the routing table extended so
      the router finds it (the degraded-503 window closes);
    - **shard-aware autoscale**: each child reconciler autoscales its
      OWN shard from its own replicas' /3/Stats, with the pressure
      counters attributed to the shard's placed tenants
      (``Reconciler.autoscale_keys``) — the shard whose tenants shed
      scales, not the pool.

    The level-triggered discipline carries over: every pass re-derives
    placement health from observed state; ``overrides`` (re-placements
    already pushed) are the only memory, and re-deriving them costs an
    idempotent push at worst. The parent pool's spec is the single
    declarative input — child specs are derived, and a parent change
    (version bump, resize) re-derives and re-applies them, so rolling
    updates ride the existing surge-one machinery per shard."""

    def __init__(self, store: PoolStore, registry: ModelRegistry,
                 pool: str, workdir: str | None = None,
                 log_dir: str | None = None, replica_factory=None,
                 device=None):
        self.store = store
        self.registry = registry
        self.pool = pool
        self.device = _pod_device(device)
        self.workdir = workdir
        self.log_dir = log_dir
        self.replica_factory = replica_factory
        self.recs: dict[str, Reconciler] = {}
        self.plan: PlacementPlan | None = None
        # key -> tuple of EXTRA shard ids the tenant was re-placed
        # onto (appended to the plan's preference order for routing)
        self.overrides: dict[str, tuple] = {}
        self._gen_seen: int | None = None
        self._parent_replicas: int | None = None
        self._lock = threading.Lock()
        self._down_since: dict[str, float] = {}
        # run()-managed child reconciler threads, one per shard, each
        # with its OWN stop event so a shard removed by a spec change
        # can be stopped + drained without touching its siblings
        self._child_threads: dict[str, threading.Thread] = {}
        self._child_stops: dict[str, threading.Event] = {}
        # shards that have served at least once: re-placement (and the
        # degraded accounting) applies to shards that were LOST, never
        # to shards still converging toward their first READY replica
        # — re-placing a booting shard's tenants would double-place
        # the whole catalog on every cold start
        self._ever_healthy: set = set()
        # a RESTARTED controller resumes re-placement state from the
        # durable status it published (as the rollback pin is):
        # without this, the restart would re-derive child specs from
        # the plan alone — clobbering the survivors' extended specs —
        # and a shard that died BEFORE the restart would read as
        # "still converging" forever, leaving its tenants degraded
        # with no recovery path
        # HA: the lease epoch this controller reconciles under (None =
        # not lease-managed, the single-controller mode). Every routing
        # publish is fenced on it; a fence rejection marks the
        # controller DEPOSED — it stops reconciling and leaves its pods
        # for the new holder to adopt (split-brain ends with exactly
        # one writer, and no pod is ever killed by the loser).
        self.lease_epoch: int | None = None
        self.deposed = False
        # hot-shard rebalancing state: key -> {"src", "dst", "t",
        # "state": serving|retired, "retired": [aged-out sources]}.
        # Deliberately SEPARATE from `overrides`: overrides are
        # loss-driven copies that failback removes once the home shard
        # recovers; moves are load-driven placements that persist (a
        # reverse move is the same primitive, not a failback).
        self.moves: dict[str, dict] = {}
        self._tenant_prev: dict[str, dict] = {}   # sid -> per-key totals
        self._pressure_hits: dict[str, int] = {}  # sid -> consecutive
        self._healthy_since: dict[str, float] = {}
        self._last_move_t = 0.0
        st = store.get_status(pool)
        pl = st.get("placement") or {}
        self.overrides = {k: tuple(v) for k, v in
                          (pl.get("overrides") or {}).items()}
        self._ever_healthy = set(pl.get("ever_healthy") or ())
        # moves resume like overrides do: a restarted (or takeover)
        # controller must keep serving moved tenants from their
        # destination, not snap placement back to the plan
        self.moves = {k: dict(v) for k, v in
                      (pl.get("moves") or {}).items()}
        self._ensure_children()

    # -- derivation -----------------------------------------------------------

    def _event(self, kind: str, msg: str = "") -> None:
        self.store.record_event(self.pool, kind, msg)
        # re-registered through the fleet-telemetry registry too:
        # the durable store keeps the bounded event ring, /metrics
        # (h2o_operator_events_total{event=...}) keeps the rates
        from ..runtime.telemetry import count_event

        count_event(kind)
        from ..diagnostics import log

        log.warning("operator[%s]: %s %s", self.pool, kind, msg)

    def shard_ids(self, spec: ScorerPoolSpec | None = None) -> list:
        if spec is None:
            spec, _ = self.store.get(self.pool)
        return [f"{self.pool}-s{i}" for i in range(max(1, spec.shards))]

    @staticmethod
    def _catalog(spec: ScorerPoolSpec) -> dict:
        """model_key -> (artifact, version, model_key, slo), catalog
        (= popularity) order preserved by dict insertion."""
        return {ent[2]: tuple(ent) for ent in spec.all_artifacts()}

    def _derive_plan(self, spec: ScorerPoolSpec) -> PlacementPlan:
        return plan_placement(list(self._catalog(spec)),
                              self.shard_ids(spec),
                              head=spec.head_models,
                              tail_replicas=spec.tail_replicas)

    def _child_spec(self, spec: ScorerPoolSpec, sid: str,
                    plan: PlacementPlan) -> ScorerPoolSpec:
        catalog = self._catalog(spec)
        keys = [k for k in plan.keys_for(sid)]
        for key, extra_sids in self.overrides.items():
            if sid in extra_sids and key not in keys and key in catalog:
                keys.append(key)
        for key, mv in self.moves.items():
            if key not in catalog:
                continue
            if mv.get("dst") == sid and key not in keys:
                keys.append(key)
            if sid in (mv.get("retired") or ()) and key in keys:
                # retired move source: future spawns of this shard no
                # longer carry the tenant — the destination owns it
                keys.remove(key)
        extra = tuple(catalog[k] for k in keys if k != spec.model_key)
        replicas = spec.replicas
        try:
            cur, _ = self.store.get(sid)
            if spec.autoscale or spec.replicas == self._parent_replicas:
                # keep the child's own width when (a) it autoscales
                # itself, or (b) the PARENT's replicas field did not
                # change — a reapply triggered by some other field
                # (version bump, head tweak) or by a re-placement
                # spec extension must not clobber a directly-resized
                # child (an operator's capacity-zero on a lost shard,
                # a survivor scaled up mid-incident). An explicit
                # parent resize still flows into every shard.
                replicas = cur.replicas
        except KeyError:
            pass
        return _dc_replace(
            spec, name=sid, replicas=replicas, extra_artifacts=extra,
            shards=1, head_models=min(1, len(keys) or 1),
            tail_replicas=1)

    def _recs_snapshot(self) -> dict:
        """Stable view of the child map: _ensure_children mutates it
        under the lock when the shard set changes, and the router's
        request path iterates it (routing_table) — iterating the live
        dict would RuntimeError mid-reconfiguration."""
        with self._lock:
            return dict(self.recs)

    def _ensure_children(self) -> None:
        """Derive + apply the child specs and build one Reconciler per
        shard. Re-runs whenever the parent spec generation moved (a
        version bump or resize flows into every child, riding the
        normal per-shard surge-one rollout); a shard REMOVED by the
        change is stopped, drained, and deleted from the store — its
        tenants already live in the re-derived plan of the survivors."""
        spec, gen = self.store.get(self.pool)
        if gen == self._gen_seen and self.recs:
            return
        removed: list = []
        with self._lock:
            if gen == self._gen_seen and self.recs:
                return
            plan = self._derive_plan(spec)
            # a changed shard SET invalidates the overrides (they name
            # shards that may no longer exist); a same-shape reapply
            # keeps them — orphans are re-detected level-triggered
            # either way, re-placement is idempotent
            if self.plan is not None and \
                    self.plan.shards != plan.shards:
                self.overrides.clear()
            self.plan = plan
            want = set(self.shard_ids(spec))
            for sid in sorted(set(self.recs) - want):
                removed.append((sid, self.recs.pop(sid)))
                self._ever_healthy.discard(sid)
                self._down_since.pop(sid, None)
            for sid in self.shard_ids(spec):
                child = self._child_spec(spec, sid, plan)
                self.store.apply(child)
                if sid not in self.recs:
                    wd = os.path.join(self.workdir, sid) \
                        if self.workdir else None
                    ld = os.path.join(self.log_dir, sid) \
                        if self.log_dir else None
                    self.recs[sid] = Reconciler(
                        self.store, self.registry, sid, log_dir=ld,
                        workdir=wd,
                        replica_factory=self.replica_factory,
                        device=self.device)
                self._set_autoscale_keys(sid)
            self._gen_seen = gen
            self._parent_replicas = spec.replicas
        for sid, rec in removed:
            ev = self._child_stops.pop(sid, None)
            if ev is not None:
                ev.set()
            self._child_threads.pop(sid, None)
            self._event("shard_removed",
                        f"{sid} left the shard set — draining")
            # drain outside the lock and off this thread: retiring a
            # shard's pods can take a full drain window and must not
            # stall routing_table() or the surviving shards' loop
            threading.Thread(target=self._retire_child,
                             args=(sid, rec), daemon=True).start()

    def _retire_child(self, sid: str, rec: "Reconciler") -> None:
        try:
            rec.shutdown(timeout=90)
        finally:
            try:
                self.store.delete(sid)
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass

    def _set_autoscale_keys(self, sid: str) -> None:
        keys = set(self.plan.keys_for(sid)) if self.plan else set()
        keys.update(k for k, sids in self.overrides.items()
                    if sid in sids)
        for k, mv in self.moves.items():
            if mv.get("dst") == sid:
                keys.add(k)
            if sid in (mv.get("retired") or ()):
                keys.discard(k)
        self.recs[sid].autoscale_keys = keys

    # -- health + re-placement ------------------------------------------------

    def shard_healthy(self, sid: str) -> bool:
        """A shard serves iff it has at least one live READY replica —
        derived from the child's OBSERVED state (the reconciler just
        probed these pods), no extra HTTP."""
        rec = self.recs.get(sid)
        if rec is None:
            return False
        with rec._lock:
            reps = list(rec.replicas)
        return any(r.state == READY and r.alive() for r in reps)

    def _placed_shards(self, key: str) -> tuple:
        base = (self.plan.assignments.get(key, ())
                + self.overrides.get(key, ()))
        mv = self.moves.get(key)
        if mv:
            gone = set(mv.get("retired") or ())
            base = tuple(s for s in base if s not in gone)
            if mv.get("state") == "serving":
                # make-before-break window: the source MUST keep
                # serving (even a source that itself entered via an
                # earlier move and is not in the plan)
                src = mv.get("src")
                if src and src not in base:
                    base = base + (src,)
            dst = mv.get("dst")
            if dst:
                # destination first: preference position 0 is what
                # actually moves the traffic off the hot shard
                base = (dst,) + tuple(s for s in base if s != dst)
        return base

    def _health_maps(self) -> tuple[dict, dict]:
        """(actual, effective) shard health. ``actual`` is the live
        has-a-READY-replica answer (push targets use it); ``effective``
        additionally treats a shard as not-down while it (a) has NEVER
        been healthy — a cold-starting shard is converging, not lost —
        or (b) has not finished pod ADOPTION yet: a restarted
        controller's children inherit live pods on their first pass,
        and judging a shard lost in the window before that pass would
        spuriously re-place a healthy fleet's whole catalog."""
        actual = {sid: self.shard_healthy(sid)
                  for sid in (self.plan.shards if self.plan else ())}
        for sid, ok in actual.items():
            if ok:
                self._ever_healthy.add(sid)
        effective = {}
        for sid, ok in actual.items():
            rec = self.recs.get(sid)
            adopted = bool(rec is not None and rec._adopted)
            effective[sid] = (ok or sid not in self._ever_healthy
                              or not adopted)
        return actual, effective

    def pending_orphans(self) -> list:
        """Tenants currently unservable: every placed shard was lost.
        The router 503s these with the ``placement_pending`` hint
        until re-placement (or shard recovery) closes the gap."""
        if self.plan is None:
            return []
        _, effective = self._health_maps()
        return [k for k in self.plan.assignments
                if not any(effective.get(s) for s in
                           self._placed_shards(k))]

    def _push_tenant(self, key: str, sid: str,
                     spec: ScorerPoolSpec) -> bool:
        """Targeted push of ONE tenant's artifact to every live READY
        replica of ``sid`` (each replica must hold the full shard
        set). Returns False on any failure — the level-triggered loop
        retries next pass. Deliberately does NOT touch the replica's
        required-model set: extending it mid-push would flip a serving
        replica unready; the child-spec update below covers future
        spawns instead."""
        ent = self._catalog(spec).get(key)
        rec = self.recs.get(sid)
        if ent is None or rec is None:
            return False
        with rec._lock:
            targets = [r for r in rec.replicas
                       if r.state == READY and r.alive()]
        if not targets:
            return False
        name, version, model_key, slo = ent
        buckets = None if spec.warm_buckets is None \
            else list(spec.warm_buckets)
        for r in targets:
            try:
                self.registry.push(r.url, name, int(version), model_key,
                                   warm_buckets=buckets, slo=slo)
            except Exception as e:  # noqa: BLE001 — retry next pass
                self._event("tenant_replace_failed",
                            f"'{key}' -> {sid} ({r.rid}): "
                            f"{repr(e)[:200]}")
                return False
        return True

    def _replace_once(self) -> int:
        """One re-placement pass: every orphaned tenant (all placed
        shards down) is pushed onto the first HEALTHY shard in its
        rendezvous preference order. Catalog order = popularity order,
        so the hottest orphans close their degraded window first.
        Returns the number of tenants re-placed this pass."""
        if self.plan is None:
            return 0
        spec, _ = self.store.get(self.pool)
        actual, effective = self._health_maps()
        for sid, down in ((s, not ok) for s, ok in effective.items()):
            if down and sid not in self._down_since:
                self._down_since[sid] = time.monotonic()
                self._event("shard_down",
                            f"{sid} has no live READY replica")
            elif not down and sid in self._down_since:
                dt = time.monotonic() - self._down_since.pop(sid)
                self._event("shard_recovered",
                            f"{sid} serving again after {dt:.1f}s")
        if not any(actual.values()):
            return 0          # nowhere to re-place onto
        moved = 0
        for key in list(self.plan.assignments):
            placed = self._placed_shards(key)
            if any(effective.get(s) for s in placed):
                continue
            # re-check live health before each push: if the home
            # shard recovered mid-loop, the remaining orphans are
            # served again and need no re-placement
            actual, effective = self._health_maps()
            if any(effective.get(s) for s in placed):
                continue
            for sid in shard_preference(key, self.plan.shards):
                if sid in placed or not actual.get(sid):
                    continue
                if self._push_tenant(key, sid, spec):
                    self.overrides[key] = \
                        self.overrides.get(key, ()) + (sid,)
                    moved += 1
                    self._event(
                        "tenant_replaced",
                        f"'{key}' re-placed onto {sid} (home "
                        f"shard(s) {list(placed)} down)")
                    # durable intent: future spawns of the survivor
                    # carry the tenant (same version — no rollout)
                    try:
                        self.store.apply(
                            self._child_spec(spec, sid, self.plan))
                    except Exception as e:  # noqa: BLE001
                        self._event("tenant_replace_spec_error",
                                    repr(e)[:200])
                    self._set_autoscale_keys(sid)
                break
        return moved

    # -- hot-shard rebalancing (make-before-break moves) ----------------------

    def _move_tenant(self, key: str, src: str, dst: str,
                     spec: ScorerPoolSpec) -> bool:
        """Make-before-break move of one tenant: the destination's
        live replicas get the artifact FIRST (``registry.push``
        returns only once loaded AND warmed — that IS the destination
        READY-verification), then the move lands in the routing table
        with the destination in preference position 0 while the source
        still serves, and ``_retire_moves`` drops the source only
        after ``H2O_TPU_REBALANCE_RETIRE_S``. Reversible: a later move
        in the opposite direction is the same primitive."""
        if not self._push_tenant(key, dst, spec):
            return False
        old = self.moves.get(key) or {}
        self.moves[key] = {"src": src, "dst": dst, "t": time.time(),
                           "state": "serving",
                           "retired": list(old.get("retired") or ())}
        self._event("tenant_move",
                    f"'{key}' moving {src} -> {dst} (sustained "
                    "pressure); source keeps serving until retire")
        # durable intent for the destination: future spawns carry the
        # tenant (same artifact version — no rollout rides on a move)
        try:
            self.store.apply(self._child_spec(spec, dst, self.plan))
        except Exception as e:  # noqa: BLE001 — level-triggered retry
            self._event("tenant_move_spec_error", repr(e)[:200])
        self._set_autoscale_keys(dst)
        return True

    def _retire_moves(self) -> int:
        """Deferred break half: a serving move whose dwell elapsed —
        and whose destination still serves — retires its source. The
        source's child spec and autoscale attribution drop the tenant;
        the next routing publish drops it from the table."""
        retired = 0
        spec = None
        for key, mv in list(self.moves.items()):
            if mv.get("state") != "serving":
                continue
            if time.time() - float(mv.get("t") or 0.0) < \
                    _rebalance_retire_s():
                continue
            if not self.shard_healthy(mv.get("dst", "")):
                continue        # never break before make held
            src = mv.get("src")
            mv["state"] = "retired"
            mv["retired"] = list(mv.get("retired") or ()) + [src]
            retired += 1
            self._event("tenant_move_retired",
                        f"'{key}' source {src} retired — "
                        f"{mv['dst']} is the tenant's home now")
            if src in self.recs:
                if spec is None:
                    spec, _ = self.store.get(self.pool)
                try:
                    self.store.apply(
                        self._child_spec(spec, src, self.plan))
                except Exception as e:  # noqa: BLE001
                    self._event("tenant_move_spec_error",
                                repr(e)[:200])
                self._set_autoscale_keys(src)
        return retired

    def _failback_once(self) -> int:
        """Failback hygiene for LOSS-driven re-placements: once every
        home shard of an overridden tenant has been provably healthy
        for ``H2O_TPU_REBALANCE_FAILBACK_S``, the override copies age
        out of the survivor's child spec and the routing table —
        instead of lingering until the next plan rebuild. (Load-driven
        ``moves`` are exempt: they ARE the intended placement.)"""
        if self.plan is None:
            return 0
        now = time.monotonic()
        actual, _ = self._health_maps()
        for sid, ok in actual.items():
            if ok:
                self._healthy_since.setdefault(sid, now)
            else:
                self._healthy_since.pop(sid, None)
        if not self.overrides:
            return 0
        wait = _rebalance_failback_s()
        spec = None
        dropped = 0
        for key in list(self.overrides):
            home = self.plan.assignments.get(key, ())
            if not home or not all(
                    self._healthy_since.get(s) is not None
                    and now - self._healthy_since[s] >= wait
                    for s in home):
                continue
            extras = self.overrides.pop(key)
            dropped += 1
            self._event("tenant_failback",
                        f"'{key}' home shard(s) {list(home)} healthy "
                        f">= {wait:g}s — override copies on "
                        f"{list(extras)} age out")
            if spec is None:
                spec, _ = self.store.get(self.pool)
            for sid in extras:
                if sid in self.recs:
                    try:
                        self.store.apply(
                            self._child_spec(spec, sid, self.plan))
                    except Exception as e:  # noqa: BLE001
                        self._event("tenant_failback_spec_error",
                                    repr(e)[:200])
                    self._set_autoscale_keys(sid)
        return dropped

    def _rebalance_once(self) -> int:
        """Sustained-pressure move trigger (``H2O_TPU_REBALANCE``, off
        by default): per shard, the per-tenant shed/504 deltas of its
        OWN placed tenants (the shard-aware autoscale counters) must
        show pressure for ``H2O_TPU_REBALANCE_SUSTAIN`` consecutive
        passes; then the hottest movable tenant on that shard moves to
        the first healthy non-placed shard in its rendezvous
        preference. One move per cooldown window, fleet-wide."""
        if self.plan is None or not _rebalance_enabled():
            return 0
        from .autoscale import pressure_by_model

        spec, _ = self.store.get(self.pool)
        actual, _ = self._health_maps()
        now = time.monotonic()
        head = set(self.plan.head_keys)
        moved = 0
        for sid, rec in self._recs_snapshot().items():
            with rec._lock:
                ready = [r for r in rec.replicas if r.state == READY]
            samples = [s for s in (r.stats() for r in ready) if s]
            per = pressure_by_model(samples, rec.autoscale_keys)
            prev = self._tenant_prev.get(sid)
            self._tenant_prev[sid] = per
            if prev is None:
                continue
            delta = {k: v - prev.get(k, 0) for k, v in per.items()}
            if any(v < 0 for v in delta.values()):
                continue     # counter reset (replica restart) — hold
            delta = {k: v for k, v in delta.items() if v > 0}
            if not delta:
                self._pressure_hits[sid] = 0
                continue
            hits = self._pressure_hits.get(sid, 0) + 1
            self._pressure_hits[sid] = hits
            if hits < _rebalance_sustain():
                continue
            if now - self._last_move_t < _rebalance_cooldown() and \
                    self._last_move_t > 0.0:
                continue
            for key in sorted(delta, key=delta.get, reverse=True):
                if key in head:
                    continue     # the head is everywhere already
                if self.moves.get(key, {}).get("state") == "serving":
                    continue     # one move at a time per tenant
                placed = self._placed_shards(key)
                if sid not in placed:
                    continue
                dst = move_destination(key, self.plan.shards,
                                       exclude=placed, healthy=actual)
                if dst is None:
                    continue     # nowhere better to go — hold
                if self._move_tenant(key, sid, dst, spec):
                    self._last_move_t = time.monotonic()
                    self._pressure_hits[sid] = 0
                    moved += 1
                break
        return moved

    # -- routing publication (the N-router contract) --------------------------

    def _publish_routing(self) -> None:
        """Publish the routing table through the store, fenced on this
        controller's lease epoch. A fence rejection means a newer
        holder took over: this controller is DEPOSED — it stops
        reconciling and leaves its pods for the new holder to adopt
        (split-brain resolves to exactly one writer; no pod dies)."""
        if self.deposed:
            return
        table = self.routing_table()
        try:
            gen = self.store.publish_routing(self.pool, table,
                                             epoch=self.lease_epoch)
        except StaleGenerationError as e:
            self.deposed = True
            self._event("controller_deposed", repr(e)[:200])
            return
        except Exception as e:  # noqa: BLE001 — publish retries
            self._event("routing_publish_error", repr(e)[:200])
            return
        from ..runtime.telemetry import REGISTRY

        REGISTRY.gauge(
            "h2o_operator_table_generation",
            "routing-table generation last published by this "
            "controller").set(float(gen))

    # -- the loop -------------------------------------------------------------

    def reconcile_once(self) -> None:
        """Test-driving entry: one parent sync + one pass of every
        child + one re-placement sweep + status publish. Adoption
        first, same as Reconciler.run — shard-loss judgment is gated
        on it (_health_maps)."""
        self._ensure_children()
        for rec in self._recs_snapshot().values():
            if not rec._adopted:
                try:
                    rec.adopt_existing()
                except Exception as e:  # noqa: BLE001 — pass must run
                    self._event("adoption_error", repr(e)[:200])
            rec.reconcile_once()
            rec.autoscale_once()
        self._replace_once()
        self._rebalance_once()
        self._retire_moves()
        self._failback_once()
        self._publish_status()
        self._publish_routing()

    def _sync_child_threads(self, interval: float | None) -> None:
        """Every shard in the child map gets a running reconciler
        thread — including shards ADDED by a mid-run spec change (a
        thread list built once before the loop would leave a new
        shard's pods unspawned forever, its tenants 503ing with no
        recovery path). Each thread has its own stop event so shard
        removal stops exactly one."""
        for sid, rec in self._recs_snapshot().items():
            t = self._child_threads.get(sid)
            if t is not None and t.is_alive():
                continue
            ev = self._child_stops.get(sid)
            if ev is None or ev.is_set():
                ev = threading.Event()
                self._child_stops[sid] = ev
            t = threading.Thread(target=rec.run, args=(ev,),
                                 kwargs={"interval": interval},
                                 name=f"h2o-torch-shard-{sid}",
                                 daemon=True)
            t.start()
            self._child_threads[sid] = t

    def run(self, stop: threading.Event,
            interval: float | None = None) -> None:
        """Blocking loop: children run on their own threads (each the
        normal Reconciler.run with adoption-first), this thread owns
        parent sync, re-placement, and parent status."""
        self._ensure_children()
        self._sync_child_threads(interval)
        while not stop.is_set():
            try:
                self._ensure_children()
                self._sync_child_threads(interval)
                self._replace_once()
                self._rebalance_once()
                self._retire_moves()
                self._failback_once()
                self._publish_status()
                self._publish_routing()
            except Exception as e:  # noqa: BLE001 — the loop survives
                self._event("shard_loop_error", repr(e)[:300])
            if self.deposed:
                # a newer lease holder owns the fleet: stop
                # reconciling, leave every pod running — the new
                # holder adopts them off their manifests
                break
            stop.wait(interval if interval is not None else _interval())
        for ev in list(self._child_stops.values()):
            ev.set()
        for t in list(self._child_threads.values()):
            t.join(timeout=10)

    def converged(self) -> bool:
        recs = self._recs_snapshot()
        if not recs:
            return False
        return all(rec.converged() for rec in recs.values())

    def wait_converged(self, timeout: float = 240.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.converged():
                return True
            time.sleep(0.1)
        return self.converged()

    def shutdown(self, timeout: float = 60.0) -> None:
        for ev in list(self._child_stops.values()):
            ev.set()
        threads = [threading.Thread(
            target=rec.shutdown, kwargs={"timeout": timeout},
            daemon=True) for rec in self._recs_snapshot().values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 10)

    # -- the router's view ----------------------------------------------------

    def routing_table(self) -> dict:
        """The router input: every key's shard preference order (plan
        + re-placement overrides appended) and every shard's current
        endpoint URLs. Device-free and cheap — safe to call per
        health sweep."""
        if self.plan is None:
            return {"keys": {}, "shards": {}}
        return {
            "keys": {k: list(self._placed_shards(k))
                     for k in self.plan.assignments},
            "shards": {sid: rec.endpoints()
                       for sid, rec in self._recs_snapshot().items()},
        }

    def endpoints(self) -> list:
        out = []
        for rec in self._recs_snapshot().values():
            out.extend(rec.endpoints())
        return out

    def _publish_status(self) -> None:
        shards = {}
        for sid, rec in self._recs_snapshot().items():
            st = rec.status()
            shards[sid] = {
                "ready": st["ready"],
                "converged": rec.converged(),
                "healthy": self.shard_healthy(sid),
                "tenants": len(rec.autoscale_keys or ()),
                "replicas": st["replicas"],
            }
        orphans = self.pending_orphans()
        status = {
            "sharded": True,
            "shards": shards,
            "converged": bool(self.recs) and all(
                s["converged"] for s in shards.values()),
            "placement": {
                "catalog": len(self.plan.assignments)
                if self.plan else 0,
                "head": len(self.plan.head_keys) if self.plan else 0,
                # overrides + ever_healthy ARE the re-placement state
                # a restarted controller resumes from (see __init__)
                "overrides": {k: list(v)
                              for k, v in self.overrides.items()},
                "ever_healthy": sorted(self._ever_healthy),
                "moves": {k: dict(v) for k, v in self.moves.items()},
            },
            "lease_epoch": self.lease_epoch,
            "degraded_tenants": orphans[:64],
            "degraded_count": len(orphans),
        }
        try:
            self.store.set_status(self.pool, status)
        except Exception:  # noqa: BLE001 — status is best-effort
            pass
