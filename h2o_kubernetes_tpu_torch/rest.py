"""REST server of the PyTorch port: a multi-tenant scorer replica and
the H2O REST API, on one CUDA card.

Replica surface (what the operator's pods, router and autoscaler read):

- ``GET /healthz`` — liveness (true through DRAINING);
- ``GET /readyz`` — readiness: SERVING ∧ breaker not open ∧ healthy ∧
  every ``READINESS_GATES`` predicate ∧ not cordoned;
- ``GET /3/Stats`` — one scrape: readiness and the lifecycle, the
  replica's ``IDENTITY``, the scorer cache's residency
  (``models/base.py``: the byte-budgeted LRU of device state), the
  batcher, the REST counters, per-model counters, fairness, the
  registry and the build;
- ``GET /metrics`` — the same stat groups as Prometheus text, plus the
  request-phase histograms (``runtime/telemetry.py``);
- ``GET /3/Trace/{id}`` — one request's spans (admission, queue,
  assemble, dispatch, total) from the bounded trace ring;
- ``GET /3/ModelRegistry``; ``POST /3/ModelRegistry/load`` (a MOJO-v2
  tree artifact, inline ``artifact_b64`` or a ``path`` read through
  ``persist.py``, optional ``sha256`` (409 on a mismatch),
  ``warm_buckets`` and a default ``slo``), ``POST
  /3/ModelRegistry/require`` (the tenant set readiness waits for);
- ``POST /3/Cordon``, ``POST /3/Uncordon``;
- ``GET /3/Kernels`` and ``POST /3/Kernels/reset`` — the process's
  launches of the hand-written kernels (B1-B4), so a caller counts
  what a pod ran;
- ``POST /3/Predictions/models/{key}`` and ``.../contributions`` —
  JSON rows in, predictions or per-row TreeSHAP out, through the
  micro-batcher under an SLO class (``X-H2O-SLO``), a per-model queue
  share, a per-model rate limit and an optional ``X-H2O-Deadline-Ms``.

H2O REST API (the JAX package's client verbs): ``/3/Cloud``,
``/kubernetes/isLeaderNode`` and ``/3/IsLeaderNode``, ``/3/Timeline``,
``/3/Jobs``, ``/3/Frames[/{key}[/summary]]``,
``/3/Models[/{key}[/mojo]]``, ``POST /3/ImportFiles`` and ``/3/Parse``,
``POST /3/ModelBuilders/{algo}``, ``POST /3/AutoML`` and
``/99/AutoMLBuilder`` (``GET /3/AutoML/{project}``), ``POST
/99/Grid/{algo}`` (``GET /99/Grids/{id}``), ``POST
/3/Predictions/models/{m}/frames/{f}``, ``DELETE /3/Frames/{key}``,
``/3/Models/{key}`` and ``/3/DKV``, and the Flow UI at ``/`` (the
port's own copy, ``flow/index.html``). Builds run on worker threads
under an ``automl.Job``; frames and models live in this module's
stores, on the server's device.

Start a server with ``start_server(port, host, device=None)``;
``device=None`` is the CUDA card (raises without one unless
``device="cpu"``). Stop it with ``stop_server(srv)``. The serving
policies read their ``H2O_TPU_*`` knobs on every call (the JAX
package's names and defaults).
"""

from __future__ import annotations

import base64
import hashlib
import inspect
import json
import math
import os
import sys
import threading
import time
import traceback
import urllib.parse
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .runtime import health, lifecycle, telemetry
from .runtime.backend import resolve_device
from .runtime.health import ClusterHealthError
from .runtime.lifecycle import CircuitOpenError, NodeDrainingError
from .runtime.retry import _env_float

__all__ = ["ScoreBatcher", "BATCHER", "MODELS", "FRAMES", "AUTOML", "GRIDS",
           "REGISTRY_MODELS", "REQUIRED_MODEL_IDS", "READINESS_GATES",
           "IDENTITY", "SLO_CLASSES", "STATS", "MODEL_STATS",
           "JsonHttpHandler", "QueueFullError", "install_pool_replica_gate",
           "reset_rate_buckets", "start_server", "stop_server"]


class QueueFullError(RuntimeError):
    """The scoring admission queue is full — load shed (REST: 429 +
    Retry-After) instead of queueing into latency collapse."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class _DeadlineExpired(Exception):
    """The request's X-H2O-Deadline-Ms (or SLO-class) budget ran out
    (REST: 504)."""


FRAMES: dict[str, object] = {}     # key -> Frame
MODELS: dict[str, object] = {}     # key -> Model
AUTOML: dict[str, object] = {}     # project_name -> AutoML
GRIDS: dict[str, object] = {}      # grid_id -> GridSearch
_ID_LOCK = threading.Lock()
_MODEL_SEQ = 0

# extra predicates AND-ed into /readyz: name -> () -> (ok, reason)
READINESS_GATES: dict[str, object] = {}

# model_id -> {name, version, algo, slo, warmed_buckets, contributions,
# warm_baseline, loaded_at} for artifacts loaded over
# /3/ModelRegistry/load. `warm_baseline` is the model's own (misses -
# promotions) right after warm-up, so /3/Stats reports
# warm_cache_misses = (misses - promotions) - baseline: a rebuild after
# a byte-budget eviction never reads as a first-request miss.
REGISTRY_MODELS: dict[str, dict] = {}

# model_ids that must ALL be loaded and warmed before the registry gate
# passes (POST /3/ModelRegistry/require); empty = ">= 1 artifact"
REQUIRED_MODEL_IDS: set[str] = set()

# who this replica is (pool, replica id, pid, port, started_at), set by
# the operator's pod entry and reported on /3/Stats
IDENTITY: dict = {}

# REST counters: 504s from expired budgets, requests admitted while the
# node could not serve readiness (cordon excluded) and rate-limit
# rejections; incremented under _STATS_LOCK (handler threads race)
STATS = {"deadline_504": 0, "scored_while_unready": 0, "rate_limited": 0}
_STATS_LOCK = threading.Lock()


def _bump_stat(key: str) -> None:
    with _STATS_LOCK:
        STATS[key] += 1


# -- SLO classes + per-model fairness ----------------------------------------
#
# Every scoring request carries an SLO class (X-H2O-SLO, else the
# model's registry default, else H2O_TPU_SLO_DEFAULT) that sets its
# dispatch priority inside a batch window, the share of the admission
# queue one model of that class may hold, and an implicit deadline for
# latency-class traffic. H2O_TPU_SCORE_FAIRNESS=0 turns the share cap
# and the priority order off: the unfair FIFO baseline the storm
# measures against (a policy a user sets, as in the JAX package).

SLO_CLASSES: dict[str, dict] = {
    "interactive": {"priority": 0, "deadline_ms": 500.0,
                    "queue_share": 0.25},
    "standard": {"priority": 1, "deadline_ms": None, "queue_share": 0.5},
    "batch": {"priority": 2, "deadline_ms": None, "queue_share": 1.0},
    # the contributions route's own class: TreeSHAP is heavier per row,
    # so it dispatches behind latency traffic and holds at most half
    "explain": {"priority": 2, "deadline_ms": None, "queue_share": 0.5},
}

# model_key -> per-tenant serving counters (GET /3/Stats "models")
MODEL_STATS: dict[str, dict] = {}


def _fairness_on() -> bool:
    """H2O_TPU_SCORE_FAIRNESS (default on)."""
    return os.environ.get("H2O_TPU_SCORE_FAIRNESS", "1") != "0"


def _default_slo() -> str:
    raw = (os.environ.get("H2O_TPU_SLO_DEFAULT") or "standard").lower()
    return raw if raw in SLO_CLASSES else "standard"


def _model_queue_share(cls: dict) -> float:
    """Fraction of the admission queue ONE model may hold:
    H2O_TPU_SCORE_MODEL_QUEUE_SHARE when set (> 0, one override for
    every class), else the SLO class's own share."""
    share = _env_float("H2O_TPU_SCORE_MODEL_QUEUE_SHARE", 0.0)
    return min(share, 1.0) if share > 0 else cls["queue_share"]


def _slo_class(name: str | None) -> dict:
    return SLO_CLASSES.get(name or "", SLO_CLASSES["standard"])


def _model_stats(key: str, slo: str | None = None) -> dict:
    """The per-model counter record (created on first touch); caller
    holds _STATS_LOCK."""
    rec = MODEL_STATS.get(key)
    if rec is None:
        rec = {"slo": slo or _default_slo(), "requests": 0, "shed": 0,
               "deadline_504": 0, "breaker_rejects": 0, "batches": 0,
               "rows": 0, "rate_limited": 0, "contrib_requests": 0,
               "contrib_batches": 0, "contrib_rows": 0}
        MODEL_STATS[key] = rec
    elif slo:
        rec["slo"] = slo
    return rec


def _bump_model_stat(key: str | None, stat: str, n: int = 1,
                     slo: str | None = None) -> None:
    if key is None:
        return
    with _STATS_LOCK:
        _model_stats(key, slo)[stat] += n


# -- per-tenant rate limits --------------------------------------------------
#
# A token bucket per model key at admission, before the queue and the
# fairness share: H2O_TPU_MODEL_RATE_LIMIT requests/s per model key
# (0/unset = off), a burst of one second. Exhaustion is a 429 with a
# Retry-After of the bucket's refill time.

_RATE_BUCKETS: dict[str, list] = {}     # model_key -> [tokens, last]
_RATE_LOCK = threading.Lock()
_bucket_now = time.monotonic            # tests freeze the bucket clock


def _model_rate_limit() -> float:
    return max(0.0, _env_float("H2O_TPU_MODEL_RATE_LIMIT", 0.0))


def _rate_limit_admit(model_key: str | None, slo: str | None) -> None:
    """Take one token from ``model_key``'s bucket or raise the 429."""
    rate = _model_rate_limit()
    if rate <= 0 or model_key is None:
        return
    from .runtime.retry import bucket_take

    with _RATE_LOCK:
        retry = bucket_take(_RATE_BUCKETS, model_key, rate, _bucket_now())
        if retry == 0.0:
            return
    _bump_stat("rate_limited")
    _bump_model_stat(model_key, "rate_limited", slo=slo)
    raise QueueFullError(
        f"model '{model_key}' is over its rate limit "
        f"(H2O_TPU_MODEL_RATE_LIMIT={rate:g}/s); retry after the "
        "bucket refills", retry_after=retry)


def reset_rate_buckets() -> None:
    with _RATE_LOCK:
        _RATE_BUCKETS.clear()


def _request_slo(headers) -> str | None:
    """SLO class from X-H2O-SLO, or None; an unknown class is a 400."""
    raw = headers.get("X-H2O-SLO")
    if raw is None:
        return None
    name = str(raw).strip().lower()
    if name not in SLO_CLASSES:
        raise ValueError(
            f"unknown X-H2O-SLO class {raw!r} "
            f"(known: {', '.join(sorted(SLO_CLASSES))})")
    return name


def _resolve_slo(mkey: str, header_slo: str | None) -> str:
    """The header wins, else the model's registry default, else
    H2O_TPU_SLO_DEFAULT."""
    if header_slo:
        return header_slo
    info = REGISTRY_MODELS.get(mkey)
    if info and info.get("slo") in SLO_CLASSES:
        return info["slo"]
    return _default_slo()


def _resolve_contrib_slo(header_slo: str | None) -> str:
    """Contributions get their own class by default (``explain``;
    H2O_TPU_CONTRIB_SLO_DEFAULT re-tunes it); the header still wins, and
    the model's scoring default does not apply."""
    if header_slo:
        return header_slo
    raw = (os.environ.get("H2O_TPU_CONTRIB_SLO_DEFAULT")
           or "explain").lower()
    return raw if raw in SLO_CLASSES else "explain"


def _registry_gate():
    if REQUIRED_MODEL_IDS:
        missing = sorted(REQUIRED_MODEL_IDS - set(REGISTRY_MODELS))
        if missing:
            return False, (f"required artifact(s) not loaded+warmed "
                           f"yet: {missing[:4]}")
        return True, ""
    if REGISTRY_MODELS:
        return True, ""
    return False, "no model artifact loaded+warmed yet"


def install_pool_replica_gate() -> None:
    """Make /readyz require warmed registry artifacts (scorer-pool
    replicas; start_server installs it when H2O_TPU_POOL_REPLICA=1)."""
    READINESS_GATES["model-registry"] = _registry_gate


def _ready_state(ignore_cordon: bool = False) -> tuple[bool, list, dict]:
    """(ready, reasons, lifecycle status), shared by /readyz and
    /3/Stats. ``ignore_cordon`` gives serving capability: a cordoned
    node is routing-unready but still serves stragglers."""
    st = lifecycle.status()
    reasons = []
    if st["state"] != lifecycle.SERVING:
        reasons.append(f"state={st['state']}")
    if st["breaker"]["state"] == "open":
        reasons.append("breaker=open")
    if not st["healthy"]:
        reasons.append("node unhealthy")
    for name, gate in list(READINESS_GATES.items()):
        try:
            ok, why = gate()
        except Exception as e:  # noqa: BLE001 — a buggy gate reads
            ok, why = False, f"error: {e!r}"    # unready, never a 500
        if not ok:
            reasons.append(f"gate:{name}: {why}")
    if not ignore_cordon and st.get("cordoned"):
        reasons.append(f"cordoned: {st['cordoned']}")
    return (not reasons), reasons, st


# ---------------------------------------------------------------------------
# Scoring micro-batcher
# ---------------------------------------------------------------------------

def _row_cap(env: str) -> int:
    """A H2O_TPU_*_MAX_ROWS knob as an int cap; <= 0 or inf reads as
    uncapped. Never raises (it runs on the dispatcher thread)."""
    v = _env_float(env, 100_000.0)
    if not math.isfinite(v) or v <= 0:
        return sys.maxsize
    return max(1, int(v))


def _score_row_cap() -> int:
    return _row_cap("H2O_TPU_SCORE_MAX_ROWS")


def _contrib_row_cap() -> int:
    return _row_cap("H2O_TPU_CONTRIB_MAX_ROWS")


class _ScoreJob:
    __slots__ = ("model", "X", "offset", "event", "out", "err",
                 "deadline", "key", "slo", "kind", "span")

    def __init__(self, model, X, offset, key=None, slo=None,
                 kind="score", span=None):
        self.model = model
        self.X = X
        self.offset = offset
        self.event = threading.Event()
        self.out = None
        self.err = None
        self.deadline = float("inf")
        self.key = key          # model key (per-tenant accounting)
        self.slo = slo          # SLO class name (fairness + priority)
        self.kind = kind        # "score" | "contrib" (dispatch target)
        self.span = span        # trace marks dict, or None

    def mark(self, name: str) -> None:
        if self.span is not None:
            self.span[name] = time.monotonic()


class ScoreBatcher:
    """Collects concurrent scoring requests into per-(model, kind)
    batches: one padded device dispatch per group and window. With
    fairness on, one model's share of the admission queue is capped by
    its SLO class and groups dispatch in SLO-priority order (smallest
    first within a class), so a hot model's flood cannot starve a tail
    model out of its deadline."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending: list[_ScoreJob] = []
        self._inflight: list[_ScoreJob] = []
        self._pending_by_key: dict[str, int] = {}
        self._thread: threading.Thread | None = None
        self._stopped = False
        self.stats = {"requests": 0, "batches": 0, "batched_rows": 0,
                      "max_batch_requests": 0, "shed": 0,
                      "fairness_shed": 0}

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="h2o-torch-score-batcher",
                daemon=True)
            self._thread.start()

    @staticmethod
    def _queue_max() -> int:
        """H2O_TPU_SCORE_QUEUE_MAX admission bound; <= 0 = unbounded."""
        v = _env_float("H2O_TPU_SCORE_QUEUE_MAX", 256.0)
        return sys.maxsize if v <= 0 else max(1, int(v))

    def submit(self, model, X: np.ndarray, offset=None,
               timeout: float | None = None,
               deadline: float | None = None,
               model_key: str | None = None,
               slo: str | None = None,
               kind: str = "score",
               span: dict | None = None) -> np.ndarray:
        """Enqueue one scoring request; blocks until its slice of the
        batched result (or raises: health/breaker/drain fail-fast, rate
        limit, queue-full or fair-share shed, deadline, timeout).
        ``deadline`` is an absolute ``time.monotonic()`` instant; a
        deadline-less request of a latency class gets the class's
        implicit one. ``span`` collects the phase marks (admit/enqueue/
        pop/dispatch_start/dispatch_end) of the request's trace."""
        if span is not None:
            span["admit"] = time.monotonic()
        if self._stopped or not lifecycle.accepting():
            raise NodeDrainingError(
                f"node {lifecycle.state()}: draining — new scoring "
                "requests are not admitted")
        if not health.healthy():
            raise ClusterHealthError(
                f"node unhealthy: {health.health_status()['error']} — "
                "scoring refused (fail-fast, not queued)")
        # an OPEN breaker rejects at the front door; check() never
        # claims the half-open probe slot (the dispatch does)
        try:
            lifecycle.BREAKER.check()
        except CircuitOpenError:
            _bump_model_stat(model_key, "breaker_rejects", slo=slo)
            raise
        # the rate limit bounds admission RATE, before any queue slot
        _rate_limit_admit(model_key, slo)
        cls = _slo_class(slo)
        if deadline is None and cls["deadline_ms"]:
            deadline = time.monotonic() + cls["deadline_ms"] / 1000.0
        if timeout is None:
            timeout = _env_float("H2O_TPU_SCORE_TIMEOUT", 60.0)
        job = _ScoreJob(model, X, offset, key=model_key, slo=slo,
                        kind=kind, span=span)
        job.deadline = time.monotonic() + timeout
        if deadline is not None:
            job.deadline = min(job.deadline, deadline)
        wait_s = max(0.0, job.deadline - time.monotonic())
        with self._cond:
            if self._stopped or not lifecycle.accepting():
                raise NodeDrainingError(
                    f"node {lifecycle.state()}: draining — new scoring "
                    "requests are not admitted")
            self._shed_check(model_key, slo)
            if model_key is not None and _fairness_on():
                self._pending_by_key[model_key] = \
                    self._pending_by_key.get(model_key, 0) + 1
            self._ensure_thread()
            self._pending.append(job)
            job.mark("enqueue")
            self.stats["requests"] += 1
            _bump_model_stat(
                model_key,
                "contrib_requests" if kind == "contrib" else "requests",
                slo=slo)
            self._cond.notify_all()
        # admitted while not serving-capable (state or a readiness
        # gate; cordon excluded): counted for the autoscaler
        unready = lifecycle.state() != lifecycle.SERVING
        if not unready:
            for _name, gate in list(READINESS_GATES.items()):
                try:
                    ok, _why = gate()
                except Exception:  # noqa: BLE001 — a buggy gate reads
                    ok = False     # unready, as in _ready_state
                if not ok:
                    unready = True
                    break
        if unready:
            _bump_stat("scored_while_unready")
        if not job.event.wait(wait_s):
            if deadline is not None and time.monotonic() >= deadline:
                _bump_model_stat(model_key, "deadline_504", slo=slo)
                raise _DeadlineExpired(
                    "request deadline expired while queued in the "
                    "micro-batcher (X-H2O-Deadline-Ms / SLO class "
                    "deadline) — dropped unscored")
            raise TimeoutError(
                f"scoring request timed out after {wait_s:.0f}s in "
                "the micro-batcher (H2O_TPU_SCORE_TIMEOUT / "
                "X-H2O-Deadline-Ms)")
        if job.err is not None:
            raise job.err
        return job.out

    def _shed_check(self, model_key: str | None, slo: str | None) -> None:
        """Raise the 429 (counted) when the queue is full or, with
        fairness on, when ``model_key`` holds its SLO class's share of
        it. Caller holds ``_cond``."""
        qmax = self._queue_max()
        if len(self._pending) >= qmax:
            self.stats["shed"] += 1
            _bump_model_stat(model_key, "shed", slo=slo)
            raise QueueFullError(
                f"scoring admission queue is full "
                f"({len(self._pending)} pending, "
                f"H2O_TPU_SCORE_QUEUE_MAX={qmax}); "
                "shed — retry with backoff", retry_after=1.0)
        if model_key is not None and _fairness_on():
            cap_m = max(1, int(qmax * _model_queue_share(_slo_class(slo))))
            if self._pending_by_key.get(model_key, 0) >= cap_m:
                # fairness_shed, not the global `shed` the autoscaler
                # scales on: a hot tenant pinned at its share is the
                # cap working, not capacity pressure
                self.stats["fairness_shed"] += 1
                _bump_model_stat(model_key, "shed", slo=slo)
                raise QueueFullError(
                    f"model '{model_key}' holds its fair share of the "
                    f"scoring queue ({cap_m} of {qmax}, SLO class "
                    f"{slo or _default_slo()}); shed — retry with "
                    "backoff (H2O_TPU_SCORE_FAIRNESS=0 disables)",
                    retry_after=0.5)

    def probe(self, model_key: str | None, slo: str | None) -> None:
        """The admission checks of ``submit`` that need no payload (queue
        full, the model's fair share), made before a request's body is
        parsed: a request the queue would shed costs no JSON parse —
        under a hot tenant's flood the parses of its shed requests would
        otherwise take the interpreter from the dispatcher. Raises as
        ``submit`` does, counted once; ``submit`` checks again."""
        with self._cond:
            self._shed_check(model_key, slo)

    def stop(self, timeout: float | None = 30.0) -> None:
        """Drain-path shutdown: refuse new submits, let the dispatcher
        flush everything already queued, then stop it. Jobs still
        pending past ``timeout`` are failed, never left hanging."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        with self._cond:
            leftovers, self._pending = self._pending, []
            self._pending_by_key.clear()
            stuck = [j for j in self._inflight if not j.event.is_set()]
        for job in leftovers + stuck:
            job.err = NodeDrainingError(
                "node draining: scoring request could not be flushed "
                "before the drain deadline")
            job.event.set()

    def reset(self) -> None:
        """Back to accepting; the dispatcher respawns on next submit."""
        with self._cond:
            self._stopped = False

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._pending:
                    return
            win = _env_float("H2O_TPU_SCORE_BATCH_US", 2000.0) / 1e6
            if win > 0 and not self._stopped:
                time.sleep(min(win, 1.0))    # collect concurrent arrivals
            with self._cond:
                batch, self._pending = self._pending, []
                # fairness counts queue occupancy: popped jobs free it
                self._pending_by_key.clear()
                self._inflight = batch
            self._dispatch(batch)
            with self._cond:
                self._inflight = []

    def _dispatch(self, batch: list[_ScoreJob]) -> None:
        now = time.monotonic()
        live = []
        for job in batch:
            if now > job.deadline:
                job.err = TimeoutError("scoring request abandoned "
                                       "(client wait expired)")
                job.event.set()
            else:
                job.mark("pop")
                live.append(job)
        groups: dict[tuple, list[_ScoreJob]] = {}
        for job in live:
            # kind in the key: score and contrib dispatches never mix
            groups.setdefault(
                (id(job.model), job.offset is not None, job.kind),
                []).append(job)
        ordered = list(groups.values())
        if _fairness_on() and len(ordered) > 1:
            # SLO priority, smallest group first within a class: a tail
            # model's small interactive request goes to the device
            # before the hot model's coalesced flood
            ordered.sort(key=lambda jobs: (
                min(_slo_class(j.slo)["priority"] for j in jobs),
                sum(j.X.shape[0] for j in jobs)))
        # the per-request row cap also bounds the COALESCED dispatch
        cap = _score_row_cap()
        for jobs in ordered:
            while jobs:
                rows = 0
                chunk = []
                while jobs and (not chunk
                                or rows + jobs[0].X.shape[0] <= cap):
                    rows += jobs[0].X.shape[0]
                    chunk.append(jobs.pop(0))
                self._score_group(chunk)

    def _score_group(self, jobs: list[_ScoreJob]) -> None:
        try:
            if not health.healthy():
                raise ClusterHealthError(
                    f"node unhealthy: {health.health_status()['error']} "
                    "— queued scoring request dropped (fail-fast)")
            model = jobs[0].model
            contrib = jobs[0].kind == "contrib"
            self.stats["batches"] += 1
            self.stats["max_batch_requests"] = max(
                self.stats["max_batch_requests"], len(jobs))
            if jobs[0].key is not None:
                _bump_model_stat(jobs[0].key, "contrib_batches" if contrib
                                 else "batches")
                _bump_model_stat(jobs[0].key,
                                 "contrib_rows" if contrib else "rows",
                                 sum(j.X.shape[0] for j in jobs))

            def dispatch(X, offset=None):
                for j in jobs:
                    j.mark("dispatch_start")
                try:
                    if contrib:
                        return model.contrib_numpy(X)
                    return model.score_numpy(X, offset=offset)
                finally:
                    for j in jobs:
                        j.mark("dispatch_end")

            if len(jobs) == 1:
                jobs[0].out = dispatch(jobs[0].X, offset=jobs[0].offset)
            else:
                X = np.concatenate([j.X for j in jobs])
                off = None
                if jobs[0].offset is not None:
                    off = np.concatenate([j.offset for j in jobs])
                self.stats["batched_rows"] += X.shape[0]
                out = dispatch(X, offset=off)
                lo = 0
                for j in jobs:
                    hi = lo + j.X.shape[0]
                    j.out = out[lo:hi]
                    lo = hi
        except BaseException as e:  # noqa: BLE001 — every waiter
            for j in jobs:          # must be released, whatever died
                j.err = e
        finally:
            for j in jobs:
                j.event.set()


BATCHER = ScoreBatcher()


# -- telemetry registration --------------------------------------------------
#
# The dicts above stay the storage their hot paths mutate; /3/Stats is
# assembled from the registry snapshot and GET /metrics flattens the
# same groups (scorer_cache registers in models/base.py, lifecycle in
# runtime/lifecycle.py, timeline in diagnostics.py).

def _counters_snapshot() -> dict:
    with _STATS_LOCK:
        return dict(STATS)


def _model_stats_snapshot() -> dict:
    with _STATS_LOCK:
        return {k: dict(v) for k, v in MODEL_STATS.items()}


def _batcher_snapshot() -> dict:
    return {**BATCHER.stats, "queue_depth": BATCHER.queue_depth()}


def _registry_snapshot() -> dict:
    """Per-artifact registry state with the eviction-aware
    warm_cache_misses."""
    from .models.base import model_scorer_counters

    reg = {}
    for mid, info in list(REGISTRY_MODELS.items()):
        model = MODELS.get(mid)
        wcm = None
        if model is not None:
            ctr = model_scorer_counters(model)
            wcm = max(0, ctr["misses"] - ctr["promotions"]
                      - info.get("warm_baseline", 0))
        reg[mid] = {
            "name": info.get("name"),
            "version": info.get("version"),
            "algo": info.get("algo"),
            "slo": info.get("slo"),
            "warmed_buckets": info.get("warmed_buckets"),
            "contributions": info.get("contributions"),
            "warm_cache_misses": wcm,
        }
    return reg


telemetry.register_group("counters", _counters_snapshot)
telemetry.register_group("batcher", _batcher_snapshot)
telemetry.register_group("models", _model_stats_snapshot, labeled="model")
telemetry.register_group("registry", _registry_snapshot, labeled="model")
telemetry.register_group("identity", lambda: dict(IDENTITY))
telemetry.register_group("build", telemetry.build_info)


def _traced_submit(model, X, *, tid, t0, model_key, slo,
                   kind="score", offset=None, deadline=None):
    """BATCHER.submit with the request trace on both exits: a request
    that dies in the queue (shed, 504, breaker, timeout) lands in the
    ring and the histograms with its error name as the outcome."""
    marks: dict = {}
    try:
        out = BATCHER.submit(model, X, offset=offset, deadline=deadline,
                             model_key=model_key, slo=slo, kind=kind,
                             span=marks)
    except BaseException as e:
        telemetry.record_request_phases(
            tid, marks, t0 if t0 is not None else marks.get("admit"),
            time.monotonic(), model=model_key, slo=slo, kind=kind,
            outcome=type(e).__name__)
        raise
    telemetry.record_request_phases(
        tid, marks, t0 if t0 is not None else marks.get("admit"),
        time.monotonic(), model=model_key, slo=slo, kind=kind)
    return out


def _predict_via_batcher(model, frame, deadline=None, model_key=None,
                         slo=None, tid=None, t0=None):
    """Frame prediction through the micro-batcher (one possibly
    coalesced dispatch) for the inline-serving models up to 8,192 rows;
    everything else takes the model's own ``predict``."""
    from .models.base import Model

    if not getattr(model, "_serving_rows", False) \
            or type(model).predict is not Model.predict \
            or frame.nrows == 0 or frame.nrows > 8192:
        return model.predict(frame)
    X = model._design_matrix(frame).cpu().numpy()
    off = model._offset_of(frame)
    if off is not None:
        off = off.cpu().numpy()
    out = _traced_submit(model, X, tid=tid, t0=t0, model_key=model_key,
                         slo=slo, offset=off, deadline=deadline)
    return model._prediction_frame(out)


def _request_deadline(headers) -> float | None:
    """Absolute monotonic deadline from X-H2O-Deadline-Ms (the client's
    REMAINING budget in ms), or None. Unparseable -> ValueError (400);
    already <= 0 -> _DeadlineExpired (504)."""
    raw = headers.get("X-H2O-Deadline-Ms")
    if raw is None:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"bad X-H2O-Deadline-Ms {raw!r} (want milliseconds)") \
            from None
    if ms <= 0:
        raise _DeadlineExpired(
            f"request deadline already expired (X-H2O-Deadline-Ms="
            f"{ms:g}) — rejected without a dispatch")
    return time.monotonic() + ms / 1000.0


def _rows_to_matrix(model, rows, columns=None):
    """JSON scoring payload -> [n, F] float32 in TRAINING value space.

    `rows` is a list of per-row dicts (col -> value) or a list of
    lists with `columns` naming their order. Enum levels map through
    the training domain (unseen/None -> NaN = NA)."""
    names = model.feature_names
    if not isinstance(rows, list) or not rows:
        raise ValueError("'rows' must be a non-empty list")
    if isinstance(rows[0], dict):
        missing = [n for n in names if n not in rows[0]]
        if missing:
            raise ValueError(f"missing feature column(s) {missing} "
                             "(send null for NA, not absence)")

        def get(r, name):
            # direct indexing: a LATER row omitting a feature must
            # reject (KeyError -> 400), not silently score it as NA
            return r[name]
    else:
        if not columns:
            raise ValueError(
                "list-shaped rows need 'columns' naming their order")
        pos = {c: i for i, c in enumerate(columns)}
        missing = [n for n in names if n not in pos]
        if missing:
            raise ValueError(f"missing feature column(s) {missing}")

        def get(r, name):
            return r[pos[name]]

    n = len(rows)
    X = np.empty((n, len(names)), dtype=np.float32)
    doms = getattr(model, "feature_domains", {}) or {}
    # domain->code LUTs are request-invariant: cached per model (and
    # charged to, and evicted with, its serving state)
    luts = model.__dict__.setdefault("_serving_luts", {})
    for j, name in enumerate(names):
        dom = doms.get(name)
        if dom is not None:
            lut = luts.get(name)
            if lut is None:
                lut = {d: float(i) for i, d in enumerate(dom)}
                luts[name] = lut
            X[:, j] = [lut.get(str(v), np.nan)
                       if (v := get(r, name)) is not None else np.nan
                       for r in rows]
        else:
            X[:, j] = [float(v) if (v := get(r, name)) is not None
                       else np.nan for r in rows]
    return X


def _kernel_launches(reset: bool = False) -> dict:
    """GET /3/Kernels: this process's launches of the hand-written
    kernels since it started or since ``POST /3/Kernels/reset`` — B1 the
    single-tree histograms outside the partitioned regime, B2 the
    partitioned ones, B3 every launch over K > 1 trees, B4 the TreeSHAP
    kernel, and each by regime or variant. A fleet's pods are processes
    of their own, so this is how a caller counts the kernels they ran."""
    from .ops import histogram as hist_op
    from .ops import shap_kernel

    if reset:
        hist_op.reset_launches()
        shap_kernel.reset_launches()
    lau, bat = dict(hist_op.LAUNCHES), dict(hist_op.BATCHED_LAUNCHES)
    return {"b1": sum(lau[r] - bat[r] for r in lau if r != "partitioned"),
            "b2": lau["partitioned"] - bat["partitioned"],
            "b3": sum(bat.values()),
            "b4": shap_kernel.flat_shap_tab_kernel.launches,
            "histogram": lau, "histogram_batched": bat,
            "row_partition": hist_op.PARTITION_LAUNCHES["row_partition"],
            "shap_tab": dict(shap_kernel.LAUNCHES)}


def _is_leader() -> bool:
    """True on the leader (process 0). The operator injects
    H2O_TPU_PROCESS_ID into every pod; a one-process node is its own
    leader, and an unparseable index reads as not-leader (503)."""
    raw = os.environ.get("H2O_TPU_PROCESS_ID") or "0"
    try:
        return int(raw) == 0
    except ValueError:
        return False


def _cloud_status(device) -> dict:
    """GET /3/Cloud: one process on one device."""
    from . import __version__

    return {"version": __version__,
            "cloud_healthy": bool(health.health_status()["healthy"]),
            "cloud_size": 1, "mesh_shape": {"rows": 1},
            "process_count": 1, "devices": [str(device)]}


def _reap_jobs() -> None:
    """Fail RUNNING jobs whose worker thread died between polls, and —
    when H2O_TPU_JOB_TIMEOUT seconds is set > 0 — RUNNING jobs older
    than that (the job poll timeout): a poller never hangs on a job
    nobody will finish."""
    from .automl import JOBS

    timeout = _env_float("H2O_TPU_JOB_TIMEOUT", 0.0)
    for job in list(JOBS.values()):
        if job.status != "RUNNING":
            continue
        th = getattr(job, "_thread", None)
        if th is not None and not th.is_alive():
            job.failed("worker thread died between polls without "
                       "reporting a result")
        elif timeout > 0 and job.start_time and \
                time.time() - job.start_time > timeout:
            job.failed(f"server-side job-poll timeout: still RUNNING "
                       f"after {timeout:.0f}s (H2O_TPU_JOB_TIMEOUT)")


_ALGOS = ("gbm", "drf", "glm", "deeplearning", "xgboost", "word2vec",
          "kmeans", "naivebayes", "pca", "isolationforest", "glrm", "coxph",
          "aggregator", "targetencoder", "stackedensemble")


def _algo_estimator(algo: str):
    from .models.aggregator import Aggregator
    from .models.coxph import CoxPH
    from .models.deeplearning import DeepLearning
    from .models.drf import DRF
    from .models.gbm import GBM
    from .models.glm import GLM
    from .models.glrm import GLRM
    from .models.isolationforest import IsolationForest
    from .models.kmeans import KMeans
    from .models.naivebayes import NaiveBayes
    from .models.pca import PCA
    from .models.stackedensemble import StackedEnsemble
    from .models.targetencoder import TargetEncoder
    from .models.word2vec import Word2Vec
    from .models.xgboost import XGBoost

    return {
        "gbm": GBM, "drf": DRF, "glm": GLM, "deeplearning": DeepLearning,
        "xgboost": XGBoost, "word2vec": Word2Vec, "kmeans": KMeans,
        "naivebayes": NaiveBayes, "pca": PCA,
        "isolationforest": IsolationForest, "glrm": GLRM, "coxph": CoxPH,
        "aggregator": Aggregator, "targetencoder": TargetEncoder,
        "stackedensemble": StackedEnsemble,
    }[algo]


def _definite(obj):
    """Recursively replace non-finite floats with None (JSON null)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _definite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_definite(v) for v in obj]
    return obj


def _frame_schema(key: str, fr) -> dict:
    return {"frame_id": {"name": key}, "rows": fr.nrows,
            "columns": [{"label": n, "type": fr.vec(n).kind}
                        for n in fr.names]}


class JsonHttpHandler(BaseHTTPRequestHandler):
    """The JSON plumbing the REST node and the front-door scoring router
    (``operator/router.py``) share, so their error shapes, Retry-After
    semantics and drain-safe body discard cannot drift apart."""

    server_version = "h2o-torch-rest/1"

    def log_message(self, *a):       # quiet by default
        pass

    def _json(self, obj, code: int = 200, headers: dict | None = None):
        # metrics can be NaN: bare `NaN` is invalid JSON, so null it
        body = json.dumps(_definite(obj)).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str,
               retry_after: float | None = None):
        hdrs = None
        if retry_after is not None:
            # whole seconds, min 1: a zero would read "hammer now"
            hdrs = {"Retry-After": str(max(1, int(retry_after + 0.999)))}
        self._json({"__schema": "H2OErrorV3", "http_status": code,
                    "msg": msg}, code, headers=hdrs)

    def _discard_body(self) -> None:
        """Read and drop an unread body before an early error reply, so
        the client gets the response rather than a connection reset."""
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            return
        while n > 0:
            chunk = self.rfile.read(min(n, 1 << 20))
            if not chunk:
                break
            n -= len(chunk)


class _Handler(JsonHttpHandler):

    def _unhealthy_503(self) -> bool:
        """Send 503 + the health error on an unhealthy node (no doomed
        job is spawned). False when healthy."""
        if health.healthy():
            return False
        self._error(503, f"node unhealthy: "
                    f"{health.health_status()['error']} — restart the "
                    "serving process")
        return True

    def _params(self) -> dict:
        q = urllib.parse.urlparse(self.path).query
        out = {k: v[0] for k, v in urllib.parse.parse_qs(q).items()}
        ln = int(self.headers.get("Content-Length") or 0)
        if ln:
            raw = self.rfile.read(ln).decode()
            if "json" in self.headers.get("Content-Type", ""):
                body = json.loads(raw)
                if not isinstance(body, dict):
                    raise ValueError("JSON body must be an object")
                out.update(body)
            else:
                out.update({k: v[0] for k, v in
                            urllib.parse.parse_qs(raw).items()})
        return out

    def _send_bytes(self, body: bytes, ctype: str,
                    headers: dict | None = None) -> None:
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # -- routes --------------------------------------------------------------

    def do_GET(self):
        try:
            path = urllib.parse.urlparse(self.path).path.rstrip("/")
            if path == "/healthz":
                st = lifecycle.status()
                if st["state"] == lifecycle.TERMINATED:
                    return self._json({"alive": False, **st}, 503)
                return self._json({"alive": True, **st})
            if path == "/readyz":
                ready, reasons, st = _ready_state()
                if ready:
                    return self._json({"ready": True, **st})
                return self._json({"ready": False, "reasons": reasons,
                                   **st}, 503)
            if path == "/3/Stats":
                # device-free: safe to poll on a wedged node
                ready, reasons, st = _ready_state()
                snap = telemetry.group_snapshot((
                    "scorer_cache", "batcher", "counters", "models",
                    "registry"))
                return self._json({
                    "ready": ready, "reasons": reasons, **st,
                    "identity": dict(IDENTITY),
                    "scorer_cache": snap.get("scorer_cache", {}),
                    "batcher": snap.get("batcher", {}),
                    "counters": snap.get("counters", {}),
                    "models": snap.get("models", {}),
                    "fairness": _fairness_on(),
                    "registry": snap.get("registry", {}),
                    "build": telemetry.build_info()})
            if path == "/metrics":
                telemetry.write_metrics(self)
                return None
            if path.startswith("/3/Trace/"):
                tid = urllib.parse.unquote(path[len("/3/Trace/"):])
                rec = telemetry.TRACER.get(tid)
                if rec is None:
                    return self._error(
                        404, f"trace '{tid}' not in the ring (bounded "
                        "at H2O_TPU_TRACE_RING entries — old traces "
                        "age out)")
                return self._json(rec)
            if path == "/3/ModelRegistry":
                return self._json({
                    "models": {
                        mid: {k: v for k, v in info.items()
                              if k != "warm_baseline"}
                        for mid, info in REGISTRY_MODELS.items()},
                    "required": sorted(REQUIRED_MODEL_IDS)})
            if path in ("", "/flow", "/flow/index.html"):
                page = os.path.join(os.path.dirname(
                    os.path.abspath(__file__)), "flow", "index.html")
                with open(page, "rb") as f:
                    body = f.read()
                return self._send_bytes(body, "text/html; charset=utf-8")
            if path == "/3/Cloud":
                return self._json(_cloud_status(self.server.device))
            if path in ("/kubernetes/isLeaderNode", "/3/IsLeaderNode"):
                if _is_leader():
                    return self._json({"leader": True})
                return self._error(503, "not the leader node")
            if path == "/3/Kernels":
                return self._json({"launches": _kernel_launches()})
            if path == "/3/Timeline":
                from .diagnostics import timeline

                return self._json({"events": timeline.events()})
            if path.startswith("/3/AutoML/"):
                key = urllib.parse.unquote(path[len("/3/AutoML/"):])
                if key not in AUTOML:
                    return self._error(404, f"automl '{key}' not found")
                aml = AUTOML[key]
                lb = aml.leaderboard.as_list() if aml.leaderboard else []
                leader = lb[0]["model_id"] if lb else None
                return self._json({
                    "project_name": key,
                    "leader": {"name": leader},
                    "leaderboard": lb,
                    "sort_metric": aml.leaderboard.sort_metric
                    if aml.leaderboard else None})
            if path.startswith("/99/Grids/"):
                key = urllib.parse.unquote(path[len("/99/Grids/"):])
                if key not in GRIDS:
                    return self._error(404, f"grid '{key}' not found")
                g = GRIDS[key]
                return self._json({
                    "grid_id": {"name": key},
                    "model_ids": [{"name": m} for m in g.model_ids],
                    "summary": g.get_grid()})
            if path == "/3/Jobs":
                from .automl import jobs

                _reap_jobs()    # dead workers read as FAILED
                return self._json({"jobs": jobs()})
            if path == "/3/Frames":
                return self._json({"frames": [
                    _frame_schema(k, f) for k, f in FRAMES.items()]})
            if path.startswith("/3/Frames/"):
                key, _, verb = path[len("/3/Frames/"):].partition("/")
                key = urllib.parse.unquote(key)
                if key not in FRAMES:
                    return self._error(404, f"frame '{key}' not found")
                fr = FRAMES[key]
                if verb == "summary":
                    return self._json({"frame_id": {"name": key},
                                       "summary": {n: fr.vec(n).rollups()
                                                   for n in fr.names}})
                return self._json(_frame_schema(key, fr))
            if path == "/3/Models":
                return self._json({"models": [
                    {"model_id": {"name": k}, "algo": m.algo}
                    for k, m in MODELS.items()]})
            if path.startswith("/3/Models/"):
                key, _, verb = path[len("/3/Models/"):].partition("/")
                key = urllib.parse.unquote(key)
                if key not in MODELS:
                    return self._error(404, f"model '{key}' not found")
                m = MODELS[key]
                if verb == "mojo":
                    return self._mojo(key, m)
                if verb:
                    return self._error(404, f"no route for GET {path}")
                cvm = getattr(m, "cross_validation_metrics", None)
                out = {"model_id": {"name": key},
                       "algo": m.algo,
                       "nclasses": getattr(m, "nclasses", None),
                       "scoring_history":
                           getattr(m, "scoring_history", []),
                       "validation_metrics":
                           getattr(m, "validation_metrics", None),
                       "cross_validation_metrics":
                           cvm() if callable(cvm) else cvm}
                varimp = getattr(m, "varimp", None)
                if callable(varimp):
                    try:
                        out["variable_importances"] = {
                            k: float(v) for k, v in varimp().items()}
                    except Exception:   # noqa: BLE001 — detail is
                        pass            # best-effort, not the contract
                return self._json(out)
            return self._error(404, f"no route for GET {path}")
        except ClusterHealthError as e:
            return self._error(503, str(e))
        except Exception as e:       # noqa: BLE001 — a server bug is a 500
            traceback.print_exc()
            return self._error(500, repr(e))

    def _mojo(self, key: str, m):
        """GET /3/Models/{id}/mojo: the model's MOJO-v2 artifact bytes
        (a registry scorer serves its kept artifact parts)."""
        import tempfile

        from .mojo import export_mojo

        if hasattr(m, "export_artifact"):
            blob = m.export_artifact()
        else:
            # a fixed file name inside the tempdir: model keys come
            # verbatim from POST bodies (no ../ traversal)
            with tempfile.TemporaryDirectory() as td:
                p = export_mojo(m, os.path.join(td, "model.mojo"))
                with open(p, "rb") as f:
                    blob = f.read()
        # header filename: no path separators, quotes or control chars
        safe = "".join(c for c in key
                       if c.isalnum() or c in "._- ") or "model"
        return self._send_bytes(blob, "application/octet-stream", {
            "Content-Disposition": f'attachment; filename="{safe}.mojo"'})

    def do_POST(self):
        try:
            t0 = time.monotonic()   # the request trace's total span
            path = urllib.parse.urlparse(self.path).path.rstrip("/")
            # a draining node admits no new work of any kind
            if not lifecycle.accepting():
                self._discard_body()
                return self._error(
                    503, f"node {lifecycle.state()}: draining — not "
                    "accepting new work; route to a ready replica",
                    retry_after=lifecycle.remaining_drain_budget())
            try:
                deadline = _request_deadline(self.headers)
                slo = _request_slo(self.headers)
                tid = telemetry.trace_id_from(self.headers)
                self._shed_before_parse(path, slo, tid, t0)
                params = self._params()
            except ValueError as e:
                return self._error(400, str(e))
            if path == "/3/Kernels/reset":
                return self._json({"launches": _kernel_launches(True)})
            if path in ("/3/Cordon", "/3/Uncordon"):
                # device-free ops verbs, allowed on an unhealthy node
                if path == "/3/Cordon":
                    lifecycle.cordon(str(params.get("reason")
                                         or "operator"))
                else:
                    lifecycle.uncordon()
                ready, reasons, st = _ready_state()
                return self._json({"ready": ready, "reasons": reasons,
                                   **st})
            if path == "/3/ModelRegistry/require":
                ids = params.get("model_ids")
                if not isinstance(ids, list) or \
                        not all(isinstance(i, str) and i for i in ids):
                    return self._error(
                        400, "need 'model_ids' (list of model id "
                        "strings; [] clears the requirement)")
                # add the new ids first, then drop the stale ones: a
                # concurrent gate read sees a superset, never empty
                new_ids = set(ids)
                REQUIRED_MODEL_IDS.update(new_ids)
                REQUIRED_MODEL_IDS.intersection_update(new_ids)
                ok, why = _registry_gate()
                return self._json({"required": sorted(REQUIRED_MODEL_IDS),
                                   "satisfied": ok, "reason": why})
            if self._unhealthy_503():
                return None
            if path == "/3/ModelRegistry/load":
                return self._registry_load(params)
            if path in ("/3/ImportFiles", "/3/Parse"):
                return self._import(params)
            if path in ("/3/AutoML", "/99/AutoMLBuilder"):
                return self._build_automl(params)
            if path.startswith("/99/Grid/"):
                return self._build_grid(path[len("/99/Grid/"):], params)
            if path.startswith("/3/ModelBuilders/"):
                algo = path[len("/3/ModelBuilders/"):]
                if algo not in _ALGOS:
                    return self._error(404, f"unknown algo '{algo}'")
                return self._build_model(algo, params)
            if path.startswith("/3/Predictions/models/"):
                return self._predictions(
                    path[len("/3/Predictions/models/"):], params,
                    deadline, slo, tid, t0)
            return self._error(404, f"no route for POST {path}")
        except _DeadlineExpired as e:
            _bump_stat("deadline_504")
            return self._error(504, str(e))
        except QueueFullError as e:
            return self._error(429, str(e), retry_after=e.retry_after)
        except CircuitOpenError as e:
            return self._error(503, str(e), retry_after=e.retry_after)
        except (ClusterHealthError, TimeoutError) as e:
            return self._error(503, str(e))
        except Exception as e:  # noqa: BLE001 — a server bug is a 500
            traceback.print_exc()
            return self._error(500, f"{type(e).__name__}: {e}")

    def _shed_before_parse(self, path: str, slo, tid, t0) -> None:
        """The batcher's admission probe for an inline scoring request
        to a served model, before its body is read: a shed request's
        body is discarded unparsed and its 429 traced."""
        rest = path[len("/3/Predictions/models/"):]
        if not path.startswith("/3/Predictions/models/") or \
                "/frames/" in rest:
            return
        contrib = rest.endswith("/contributions")
        mkey = urllib.parse.unquote(
            rest[: -len("/contributions")] if contrib else rest)
        if mkey not in MODELS:
            return
        slo = _resolve_contrib_slo(slo) if contrib else \
            _resolve_slo(mkey, slo)
        try:
            BATCHER.probe(mkey, slo)
        except QueueFullError as e:
            self._discard_body()
            telemetry.record_request_phases(
                tid, {}, t0, time.monotonic(), model=mkey, slo=slo,
                kind="contrib" if contrib else "score",
                outcome=type(e).__name__)
            raise

    def _predictions(self, rest: str, params: dict, deadline, slo, tid, t0):
        if rest.endswith("/contributions") and "/frames/" not in rest:
            mkey = urllib.parse.unquote(rest[: -len("/contributions")])
            if mkey not in MODELS:
                return self._error(404, f"model '{mkey}' not found")
            return self._contrib_rows(MODELS[mkey], mkey, params,
                                      deadline, slo, tid, t0)
        mkey, sep, fpart = rest.partition("/frames/")
        mkey = urllib.parse.unquote(mkey)
        fpart = urllib.parse.unquote(fpart)
        if mkey not in MODELS:
            return self._error(404, f"model '{mkey}' not found")
        if not sep:
            return self._score_rows(MODELS[mkey], mkey, params, deadline,
                                    slo, tid, t0)
        if fpart not in FRAMES:
            return self._error(404, f"frame '{fpart}' not found")
        pred = _predict_via_batcher(MODELS[mkey], FRAMES[fpart],
                                    deadline=deadline, model_key=mkey,
                                    slo=_resolve_slo(mkey, slo),
                                    tid=tid, t0=t0)
        key = f"prediction_{mkey}_{fpart}"
        FRAMES[key] = pred
        return self._json({"predictions_frame": {"name": key},
                           **_frame_schema(key, pred)},
                          headers={"X-H2O-Trace-Id": tid})

    def do_DELETE(self):
        try:
            path = urllib.parse.urlparse(self.path).path.rstrip("/")
            if path.startswith("/3/Frames/"):
                key = urllib.parse.unquote(path[len("/3/Frames/"):])
                if FRAMES.pop(key, None) is None:
                    return self._error(404, f"frame '{key}' not found")
                return self._json({"frame_id": {"name": key},
                                   "removed": True})
            if path.startswith("/3/Models/"):
                key = urllib.parse.unquote(path[len("/3/Models/"):])
                if MODELS.pop(key, None) is None:
                    return self._error(404, f"model '{key}' not found")
                return self._json({"model_id": {"name": key},
                                   "removed": True})
            if path == "/3/DKV":          # remove-all (h2o DELETE /3/DKV)
                n = len(FRAMES) + len(MODELS) + len(AUTOML) + len(GRIDS)
                FRAMES.clear()
                MODELS.clear()
                AUTOML.clear()
                GRIDS.clear()
                return self._json({"removed": n})
            return self._error(404, f"no route for DELETE {path}")
        except Exception as e:       # noqa: BLE001
            traceback.print_exc()
            return self._error(500, repr(e))

    @staticmethod
    def _coerce(params: dict) -> dict:
        """Form-encoded values arrive as strings — JSON-decode the
        obvious scalars/lists ('50' -> 50, '[1,2]' -> [1,2])."""
        kw = {}
        for k, v in params.items():
            if isinstance(v, str):
                try:
                    v = json.loads(v)
                except (ValueError, TypeError):
                    pass
            kw[k] = v
        return kw

    def _import(self, params: dict):
        """POST /3/ImportFiles and /3/Parse: one path (globs allowed)
        parsed by ``frame/parse.py`` onto the server's device."""
        from .frame import import_file

        src = params.get("path") or params.get("source_frames")
        if isinstance(src, (list, tuple)):
            if not src:
                return self._error(400, "missing 'path'")
            if len(src) != 1:       # refuse, don't silently truncate
                return self._error(
                    400, "multi-file Parse is not supported over REST; "
                    "pass one path (globs allowed)")
            src = src[0]
        if not src or not isinstance(src, str):
            return self._error(400, "missing 'path'")
        key = params.get("destination_frame") or src.rsplit("/", 1)[-1]
        try:
            fr = import_file(src, device=self.server.device)
        except FileNotFoundError as e:
            return self._error(404, str(e))
        except ValueError as e:
            return self._error(400, str(e))
        FRAMES[key] = fr
        return self._json(_frame_schema(key, fr))

    def _registry_load(self, params: dict):
        """POST /3/ModelRegistry/load: take the artifact (inline
        ``artifact_b64``, or a ``path`` read through ``persist``), check
        its ``sha256`` when given (409 on a mismatch), load it onto the
        server's device, warm every pow2 bucket (contributions too when
        the artifact supports them), and only then publish it."""
        from . import persist
        from .models.base import model_scorer_counters
        from .operator.registry import load_artifact

        model_id = params.get("model_id")
        if not model_id or not isinstance(model_id, str):
            return self._error(400, "missing 'model_id'")
        slo = params.get("slo")
        if slo is not None and slo not in SLO_CLASSES:
            return self._error(
                400, f"unknown SLO class {slo!r} "
                f"(known: {', '.join(sorted(SLO_CLASSES))})")
        b64 = params.get("artifact_b64")
        path = params.get("path")
        if b64:
            try:
                blob = base64.b64decode(b64, validate=True)
            except Exception:  # noqa: BLE001 — binascii detail useless
                return self._error(400, "bad 'artifact_b64' (not valid "
                                   "base64)")
        elif path:
            try:
                blob = persist.read_bytes(str(path))
            except FileNotFoundError:
                return self._error(404, f"artifact not found at {path!r}")
            except (NotImplementedError, ValueError) as e:
                return self._error(400, str(e))
        else:
            return self._error(400, "need 'path' (persist-readable "
                               "artifact) or 'artifact_b64'")
        want_sha = params.get("sha256")
        if want_sha:
            got = hashlib.sha256(blob).hexdigest()
            if got != str(want_sha):
                return self._error(
                    409, f"artifact digest mismatch (got {got[:12]}, "
                    f"registry says {str(want_sha)[:12]}) — refusing "
                    "to serve a corrupted model")
        try:
            model = load_artifact(blob, device=self.server.device)
        except (ValueError, KeyError) as e:
            return self._error(400, f"unservable artifact: {e}")
        except Exception as e:  # noqa: BLE001 — zip/npz parse errors
            return self._error(400, f"unservable artifact: {e!r}")
        warm_contrib = model.contrib_support() is None
        try:
            warmed = model.warm_up(params.get("warm_buckets"),
                                   contributions=warm_contrib)
        except ValueError as e:
            return self._error(400, str(e))
        MODELS[model_id] = model
        ctr = model_scorer_counters(model)
        REGISTRY_MODELS[model_id] = {
            "name": params.get("name"),
            "version": params.get("version"),
            "algo": model.algo,
            "slo": slo,
            "warmed_buckets": warmed,
            "contributions": warm_contrib,
            "warm_baseline": ctr["misses"] - ctr["promotions"],
            "loaded_at": time.time(),
        }
        with _STATS_LOCK:
            _model_stats(model_id, slo)
        return self._json({"model_id": {"name": model_id},
                           "name": params.get("name"),
                           "version": params.get("version"),
                           "algo": model.algo,
                           "slo": slo,
                           "device": str(model.device),
                           "warmed_buckets": warmed,
                           "contributions": warm_contrib})

    def _score_rows(self, model, mkey: str, params: dict, deadline, slo,
                    tid, t0):
        """POST /3/Predictions/models/{key}: JSON rows in, predictions
        out, one micro-batched dispatch under the model's SLO class
        (header > registry default > H2O_TPU_SLO_DEFAULT)."""
        if not getattr(model, "_serving_rows", False):
            return self._error(
                400, f"model '{mkey}' ({getattr(model, 'algo', '?')}) "
                "does not support inline row scoring; use "
                f"/3/Predictions/models/{mkey}/frames/{{frame}}")
        rows = params.get("rows")
        if rows is None:
            return self._error(400, "missing 'rows' (JSON list of "
                               "row dicts, or lists + 'columns')")
        max_rows = _score_row_cap()
        if isinstance(rows, list) and len(rows) > max_rows:
            return self._error(
                413, f"{len(rows)} rows exceeds the per-request limit "
                f"of {max_rows} (H2O_TPU_SCORE_MAX_ROWS); split the "
                "batch or use the frames route")
        off = None
        oc = getattr(model, "offset_column", None)
        try:
            X = _rows_to_matrix(model, rows, params.get("columns"))
            if oc:
                if not isinstance(rows[0], dict):
                    raise ValueError(f"offset column '{oc}' needs "
                                     "dict-shaped rows")
                off = np.asarray(
                    [float(r[oc]) if r[oc] is not None else np.nan
                     for r in rows], dtype=np.float32)
        except (ValueError, TypeError, KeyError, IndexError) as e:
            return self._error(400, f"bad scoring payload: {e!r}")
        out = _traced_submit(model, X, tid=tid, t0=t0, model_key=mkey,
                             slo=_resolve_slo(mkey, slo), offset=off,
                             deadline=deadline)
        resp: dict = {"model_id": {"name": mkey}, "rows": len(rows)}
        if getattr(model, "nclasses", 1) > 1:
            dom = model.response_domain or \
                [str(i) for i in range(model.nclasses)]
            labels = out.argmax(axis=1)
            resp["predict"] = [dom[int(i)] for i in labels]
            for k, name in enumerate(dom):
                resp[f"p{name}"] = [float(v) for v in out[:, k]]
        else:
            out = np.asarray(out)
            if out.ndim > 1:     # e.g. autoencoder reconstruction
                resp["predict"] = [[float(v) for v in row] for row in out]
            else:
                resp["predict"] = [float(v) for v in out]
        return self._json(resp, headers={"X-H2O-Trace-Id": tid})

    def _contrib_rows(self, model, mkey: str, params: dict, deadline, slo,
                      tid, t0):
        """POST /3/Predictions/models/{key}/contributions: per-row
        TreeSHAP, [rows, F+1] with the bias term last, through the
        micro-batcher under the ``explain`` class. Every precondition
        failure is a clean 400."""
        support = getattr(model, "contrib_support", None)
        reason = support() if callable(support) else (
            f"model '{mkey}' ({getattr(model, 'algo', '?')}) does not "
            "support predict_contributions")
        if reason:
            return self._error(
                400, f"contributions unavailable for model '{mkey}': "
                f"{reason}")
        rows = params.get("rows")
        if rows is None:
            return self._error(400, "missing 'rows' (JSON list of "
                               "row dicts, or lists + 'columns')")
        max_rows = _contrib_row_cap()
        if isinstance(rows, list) and len(rows) > max_rows:
            return self._error(
                413, f"{len(rows)} rows exceeds the per-request limit "
                f"of {max_rows} (H2O_TPU_CONTRIB_MAX_ROWS); split the "
                "batch")
        try:
            X = _rows_to_matrix(model, rows, params.get("columns"))
        except (ValueError, TypeError, KeyError, IndexError) as e:
            return self._error(400, f"bad contributions payload: {e!r}")
        out = _traced_submit(model, X, tid=tid, t0=t0, model_key=mkey,
                             slo=_resolve_contrib_slo(slo),
                             kind="contrib", deadline=deadline)
        return self._json({
            "model_id": {"name": mkey}, "rows": len(rows),
            "columns": list(model.feature_names) + ["BiasTerm"],
            "contributions": [[float(v) for v in row] for row in out]},
            headers={"X-H2O-Trace-Id": tid})

    def _run_job(self, job, fn, sync_timeout: float):
        """Run fn on a worker thread under `job`, waiting up to
        sync_timeout (the job runs on past the wait — poll /3/Jobs)."""
        def run():
            try:
                fn()
                job.done()
            except BaseException as e:  # noqa: BLE001 — whatever kills
                # the worker lands on the job, never leaves it RUNNING
                traceback.print_exc()
                job.failed(repr(e))

        t = threading.Thread(target=run, name="h2o-torch-job",
                             daemon=True)
        t.start()
        # recorded after start: the reaper reads a not-yet-started
        # thread as dead
        job._thread = t
        _JOB_THREADS.add(t)
        t.join(timeout=sync_timeout)

    def _frame_arg(self, params: dict):
        training = params.pop("training_frame", None)
        if training not in FRAMES:
            self._error(404, f"frame '{training}' not found")
            return None, None
        return training, FRAMES[training]

    def _build_automl(self, params: dict):
        from .automl import AutoML, Job

        training, fr = self._frame_arg(params)
        if fr is None:
            return None
        y = params.pop("response_column", params.pop("y", None))
        if y is None:
            return self._error(400, "missing 'response_column'")
        sync_timeout = float(params.pop("_sync_timeout", 600))
        # ids stay strings: _coerce would turn '2024' into int 2024
        project = str(params.pop("project_name", "automl"))
        kw = self._coerce(params)
        kw["project_name"] = project
        kw.setdefault("verbosity", None)
        aml = AutoML(**kw)
        AUTOML[project] = aml
        job = Job(dest=f"{project}.rest",
                  description=f"AutoML on {training}")
        job.start()

        def run():
            aml.train(y=y, training_frame=fr)
            MODELS.update(aml.leaderboard.models)

        self._run_job(job, run, sync_timeout)
        return self._json({"job": {"dest": {"name": project},
                                   "status": job.status, "msg": job.msg},
                           "project_name": project})

    def _build_grid(self, algo: str, params: dict):
        from .automl import Job
        from .grid import GridSearch

        if algo not in _ALGOS:
            return self._error(404, f"unknown algo '{algo}'")
        training, fr = self._frame_arg(params)
        if fr is None:
            return None
        y = params.pop("response_column", params.pop("y", None))
        if y is None:
            # without it every combo fails into failed_params and the
            # grid reports DONE with zero models
            return self._error(400, "missing 'response_column'")
        sync_timeout = float(params.pop("_sync_timeout", 600))
        grid_id = str(params.pop("grid_id", "") or f"grid_{algo}")
        kw = self._coerce(params)
        hyper = kw.pop("hyper_parameters", None)
        if not isinstance(hyper, dict) or not hyper:
            return self._error(400, "missing 'hyper_parameters' (JSON "
                               "object of param -> list of values)")
        criteria = kw.pop("search_criteria", None)
        est = _algo_estimator(algo)(**kw)
        gs = GridSearch(est, hyper, grid_id=grid_id,
                        search_criteria=criteria)
        GRIDS[grid_id] = gs
        job = Job(dest=f"{grid_id}.rest",
                  description=f"grid {algo} on {training}")
        job.start()

        def run():
            gs.train(y=y, training_frame=fr)
            MODELS.update(gs.leaderboard.models)

        self._run_job(job, run, sync_timeout)
        return self._json({"job": {"dest": {"name": grid_id},
                                   "status": job.status, "msg": job.msg},
                           "grid_id": {"name": grid_id}})

    def _build_model(self, algo: str, params: dict):
        global _MODEL_SEQ
        from .automl import Job

        training, fr = self._frame_arg(params)
        if fr is None:
            return None
        y = params.pop("response_column", params.pop("y", None))
        sync_timeout = float(params.pop("_sync_timeout", 600))
        model_id = params.pop("model_id", None)
        if not model_id:
            with _ID_LOCK:
                _MODEL_SEQ += 1
                model_id = f"{algo}_{_MODEL_SEQ}"
        ignored = params.pop("ignored_columns", None)
        kw = self._coerce(params)
        if algo == "stackedensemble":
            # base models by id, from this server's model store
            ids = kw.get("base_models") or []
            if not ids:
                return self._error(400, "missing 'base_models'")
            missing = [i for i in ids if i not in MODELS]
            if missing:
                return self._error(404, f"base model(s) {missing} not "
                                   "found")
            kw["base_models"] = [MODELS[i] for i in ids]
        job = Job(dest=model_id,
                  description=f"{algo} on {training}").start()

        def run():
            est = _algo_estimator(algo)(**kw)
            args = {"training_frame": fr, "y": y,
                    "ignored_columns": ignored}
            accepted = inspect.signature(est.train).parameters
            MODELS[model_id] = est.train(**{
                k: v for k, v in args.items()
                if k in accepted and (v is not None
                                      or k == "training_frame")})

        self._run_job(job, run, sync_timeout)
        return self._json({"job": {"dest": {"name": model_id},
                                   "status": job.status, "msg": job.msg}})


# job worker threads the server started (stop_server joins them)
_JOB_THREADS: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()


class _Server(ThreadingHTTPServer):
    """One REST server on ``device``; its request threads are named
    ``h2o-torch-rest-req``."""

    request_queue_size = lifecycle.LISTEN_BACKLOG

    def __init__(self, addr, handler, device):
        super().__init__(addr, handler)
        self.device = device

    def process_request(self, request, client_address):
        t = threading.Thread(target=self.process_request_thread,
                             args=(request, client_address),
                             name="h2o-torch-rest-req", daemon=True)
        t.start()


_SERVERS: "weakref.WeakSet[_Server]" = weakref.WeakSet()


def _shutdown_servers() -> None:
    """Drain-path hook: stop every live server's accept loop and close
    its listening socket."""
    for srv in list(_SERVERS):
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:  # noqa: BLE001 — drain must not die on one
            pass
        _SERVERS.discard(srv)


def start_server(port: int = 54321, host: str = "127.0.0.1",
                 device=None, background: bool = True,
                 install_signals: bool = False) -> ThreadingHTTPServer:
    """Start the REST server (``port=0`` picks a free port; read it
    from ``server_address``). Frames, models and artifacts loaded
    through it live on ``device`` (None = the CUDA card; raises without
    one unless ``device="cpu"``). The node goes SERVING, and the
    server's shutdown is registered on the drain path.
    H2O_TPU_POOL_REPLICA=1 installs the registry readiness gate."""
    dev = resolve_device(device)
    srv = _Server((host, port), _Handler, dev)
    if os.environ.get("H2O_TPU_POOL_REPLICA") == "1":
        install_pool_replica_gate()
    lifecycle.mark_serving()
    _SERVERS.add(srv)
    lifecycle.register_shutdown(_shutdown_servers)
    if install_signals:
        lifecycle.install_sigterm(exit_on_drain=True)
    if background:
        threading.Thread(target=srv.serve_forever, name="h2o-torch-rest",
                         daemon=True).start()
    else:
        srv.serve_forever()
    return srv


def stop_server(srv, timeout: float = 10.0) -> None:
    """Stop a server started by ``start_server`` completely: its accept
    loop and listening socket, then the micro-batcher's dispatcher
    (flushed, then back to accepting for a later server), and join the
    job workers it started (each up to ``timeout``)."""
    srv.shutdown()
    srv.server_close()
    _SERVERS.discard(srv)
    BATCHER.stop(timeout=timeout)
    BATCHER.reset()
    for t in list(_JOB_THREADS):
        t.join(timeout)


if __name__ == "__main__":
    start_server(int(sys.argv[1]) if len(sys.argv) > 1 else 54321,
                 background=False, install_signals=True)
