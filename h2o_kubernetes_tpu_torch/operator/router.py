"""Device-free front-door scoring router over a tenant-sharded fleet.

The Service-with-a-brain the sharded catalog needs: clients keep one
URL and one verb (``POST /3/Predictions/models/{key}`` — the
``/contributions`` suffix rides along), the router resolves the key
through the placement table (``ShardedPool.routing_table()``: each
key's shard preference order — rendezvous order for the tail, every
shard for the Zipf head — plus each shard's live endpoints) and
forwards the request bytes. No torch op anywhere on this path: the router
process never touches a device, so it can sit in front of the fleet
on the cheapest node there is.

It rides the rest.py machinery rather than reinventing it:
``JsonHttpHandler`` (same JSON/error/Retry-After shapes, same
drain-safe body discard), the ``X-H2O-Deadline-Ms`` contract (parsed
at the front door, the REMAINING budget forwarded so the replica's
batcher sees the client's true deadline), ``X-H2O-SLO`` passthrough,
and the lifecycle drain gate.

The failure half — what makes it a robustness layer, not a proxy:

- **health**: a background sweep reads every replica's ``/3/Stats``
  through the shared probe helper (operator/probe.py: probe timeout +
  3 attempts per sweep, so a scoring burst cannot flap a shard out of
  the ring); a shard serves iff it has a ready replica.
- **failover**: a replicated key whose preferred shard is down (or
  whose dispatch dies mid-flight) moves to the next shard in its
  preference order instantly.
- **retry budget**: every cross-shard retry consumes a token from the
  TENANT's bucket (``H2O_TPU_ROUTER_RETRY_BUDGET`` retries/s, burst =
  1 s; 0 disables retries) — a dying shard cannot amplify its load
  onto the survivors. Replica ``Retry-After`` is honored: a 503's
  cooldown takes the replica out of the candidate set for that long,
  and when the budget (or the candidate list) is exhausted the
  upstream response is relayed WITH its Retry-After so clients back
  off too. Budget accounting is on ``GET /3/Stats``: every granted
  token is counted as a retry at the grant itself, so ``retries`` ==
  ``retry_budget.granted`` holds structurally — hedges included.
- **hedging** (kill switch, default off): ``H2O_TPU_ROUTER_HEDGE_MS``
  arms speculative re-dispatch for the ``interactive`` SLO class —
  when the primary shard has not answered inside the hedge window, a
  second request goes to the next replica shard and the first answer
  wins. Hedges consume retry-budget tokens (they are load
  amplification too).
- **degraded mode**: a tail tenant whose every placed shard is down
  gets a TYPED 503 — ``hint: placement_pending`` — while the
  reconciler re-places its artifact onto a survivor; the routing
  table picks the re-placement up on the next sweep and the window
  closes without the client ever seeing a 5xx that lies about being
  retryable.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

from ..runtime import lifecycle, telemetry
from ..runtime.retry import _env_float
from .probe import probe_json, probe_timeout

__all__ = ["ScoringRouter", "StoreRoutingTable", "start_router"]

log = logging.getLogger("h2o_kubernetes_tpu_torch")

# a route at least this slow is logged with its dispatch attempts
_SLOW_ROUTE_S = 5.0


def _retry_budget_rate() -> float:
    """Per-tenant cross-shard retry budget, retries/second (burst = 1
    second of budget, min 1). 0 = no retries at all — every failure is
    relayed to the client on the first answer."""
    return max(0.0, _env_float("H2O_TPU_ROUTER_RETRY_BUDGET", 2.0))


def _hedge_ms() -> float:
    """Hedged-dispatch kill switch: 0/unset = off; > 0 arms
    speculative re-dispatch for `interactive` traffic after this many
    milliseconds without a primary answer."""
    return max(0.0, _env_float("H2O_TPU_ROUTER_HEDGE_MS", 0.0))


def _health_interval() -> float:
    return max(0.05, _env_float("H2O_TPU_ROUTER_HEALTH_INTERVAL", 0.5))


def _max_inflight() -> int:
    v = _env_float("H2O_TPU_ROUTER_MAX_INFLIGHT", 256.0)
    import sys

    return sys.maxsize if v <= 0 else max(1, int(v))


def _router_timeout() -> float:
    return max(0.1, _env_float("H2O_TPU_ROUTER_TIMEOUT", 30.0))


class _ProbeBoundedConnection(http.client.HTTPConnection):
    """A forward's connection: its connect is capped by the probe timeout
    (``H2O_TPU_POOL_PROBE_TIMEOUT``, as every probe of a replica is), its
    reads by the forward's own timeout. A pod that was just SIGKILLed
    need not refuse a connect: on an H100 host the router's connect to
    one hung for the whole 30 s forward timeout, past the client's own,
    where failing over at once was right."""

    def connect(self):
        read_timeout = self.timeout
        self.timeout = min(read_timeout, probe_timeout())
        try:
            super().connect()
        finally:
            self.timeout = read_timeout
        self.sock.settimeout(read_timeout)


class _ProbeBoundedHandler(urllib.request.HTTPHandler):
    def http_open(self, req):
        return self.do_open(_ProbeBoundedConnection, req)


_FORWARD_OPENER = urllib.request.build_opener(_ProbeBoundedHandler)


def _table_interval() -> float:
    """Extra throttle between STORE reads of the routing table; 0 =
    refresh on every health sweep (the default cadence)."""
    return max(0.0, _env_float("H2O_TPU_ROUTER_TABLE_INTERVAL", 0.0))


class StoreRoutingTable:
    """Store-backed routing-table provider: a zero-arg callable over
    the controller-published ``<pool>.routing.json`` that makes N
    ``start_router`` processes interchangeable — none of them holds
    the table, they all read the one the lease-holding controller
    writes.

    Invariants the front door depends on:

    - **monotonic**: a document whose ``table_generation`` is LOWER
      than the last one served is rejected (``stale_rejected``) — a
      deposed controller's file, or a lagging replica of the store,
      can never roll a router back to an older placement.
    - **last-good**: a store read failure (or a vanished document)
      serves the previous snapshot unchanged (``refresh_errors``) —
      store unavailability degrades table FRESHNESS, never request
      serving.
    - **cold**: before the first document ever lands, the provider
      returns an empty table marked ``cold`` so the router can answer
      a typed degraded 503 instead of 404 — it cannot know the
      catalog yet, so it must not claim a tenant does not exist.
    """

    def __init__(self, store, pool: str):
        self.store = store
        self.pool = pool
        self.generation = 0
        self.stats = {"refreshes": 0, "refresh_errors": 0,
                      "stale_rejected": 0}
        self._lock = threading.Lock()
        self._last: dict | None = None
        self._last_read = 0.0

    def __call__(self) -> dict:
        now = time.monotonic()
        with self._lock:
            iv = _table_interval()
            if self._last is not None and iv > 0.0 and \
                    now - self._last_read < iv:
                return self._last
        try:
            doc = self.store.get_routing(self.pool)
        except Exception:  # noqa: BLE001 — store down: serve last-good
            doc = None
            with self._lock:
                self.stats["refresh_errors"] += 1
        with self._lock:
            self._last_read = now
            if doc is not None:
                gen = int(doc.get("table_generation", 0))
                if gen >= self.generation:
                    self.generation = gen
                    self._last = doc
                    self.stats["refreshes"] += 1
                else:
                    self.stats["stale_rejected"] += 1
            if self._last is not None:
                return self._last
            return {"keys": {}, "shards": {}, "cold": True,
                    "table_generation": 0}

    def snapshot(self) -> dict:
        with self._lock:
            return {"generation": self.generation, **self.stats}


class _Transport(Exception):
    """Connection refused/reset/timeout talking to a replica — the
    failover-eligible failure shape (as opposed to an HTTP answer,
    which is relayed or retried by status)."""


class _BudgetExpired(Exception):
    """The client's X-H2O-Deadline-Ms budget ran out before a dispatch
    could even be sent — the 504 shape (rest.py's contract for the
    identical condition), never a retryable transport failure."""


class ScoringRouter:
    """Routing + health + budget state behind the handler (the handler
    class is built per-server so two routers in one process cannot
    share counters)."""

    def __init__(self, table):
        # table: dict or zero-arg callable ->
        #   {"keys": {model_key: [shard, ...]},   # preference order
        #    "shards": {shard: [replica_url, ...]}}
        self.get_table = table if callable(table) else (lambda: table)
        self._lock = threading.Lock()
        # the table snapshot the REQUEST path reads: rebuilt once per
        # health sweep, not per request — ShardedPool.routing_table()
        # is an O(catalog) dict build plus per-shard locks, which a
        # 1000-tenant catalog must not pay on every forward
        self._table: dict | None = None
        self._ready: dict[str, bool] = {}        # replica url -> ready
        self._cooldown: dict[str, float] = {}    # url -> monotonic until
        self._rr: dict[str, int] = {}            # shard -> round robin
        self._retry_buckets: dict[str, list] = {}
        self._inflight = 0
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None
        self.stats = {
            "requests": 0, "forwarded": 0, "retries": 0,
            "retry_denied": 0, "failovers": 0, "hedges": 0,
            "hedge_wins": 0, "degraded_503": 0, "relayed_5xx": 0,
            "transport_errors": 0, "inflight_shed": 0,
            "unknown_model_404": 0,
        }
        self.retry_budget = {"granted": 0, "denied": 0}
        self.by_shard: dict[str, dict] = {}
        # per-TENANT relayed-success counter: incremented exactly ONCE
        # per client request, at the final relay (never at a dispatch
        # attempt) — so a lost hedge or a failover retry can never
        # double-count a tenant's traffic. Bounded like every tenant-
        # labeled series: past 4*top-K keys the coldest roll into
        # `other`.
        self.by_model: dict[str, int] = {}

    # -- health ---------------------------------------------------------------

    def _refresh_table(self) -> dict:
        """Pull a fresh routing-table snapshot from the provider and
        cache it for the request path (one O(catalog) build per
        sweep, not per request)."""
        t = self.get_table()
        with self._lock:
            self._table = t
        gen = t.get("table_generation") if isinstance(t, dict) else None
        if gen is not None:
            telemetry.REGISTRY.gauge(
                "h2o_router_table_generation",
                "routing-table generation this router serves from "
                "(store-backed providers only bump it forward)"
            ).set(float(gen))
        return t

    def table(self) -> dict:
        with self._lock:
            t = self._table
        return t if t is not None else self._refresh_table()

    def sweep_health(self) -> None:
        """One pass over every replica of every shard: ready iff its
        /3/Stats answers with ready=true (readiness + liveness + the
        warm-up gate in one device-free scrape). The shared probe
        helper retries 3x inside the probe timeout, so one missed
        scrape under load cannot drop a shard from the ring, while a
        dead pod (connection refused) classifies in milliseconds.
        Replicas are probed CONCURRENTLY: one wedged pod (accepting
        but unresponsive) costs 3x the probe timeout, and probing
        serially would stall death-detection for every OTHER shard by
        that much per sweep. The sweep also refreshes the cached
        routing-table snapshot the request path reads."""
        table = self._refresh_table()
        seen = []
        for sid, urls in (table.get("shards") or {}).items():
            for url in urls:
                seen.append(url.rstrip("/"))

        def probe_one(url: str) -> None:
            st = probe_json(url, "/3/Stats", retries=3)
            with self._lock:
                self._ready[url] = bool(st and st.get("ready"))

        threads = [threading.Thread(target=probe_one, args=(u,),
                                    daemon=True) for u in seen]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._lock:
            for url in list(self._ready):
                if url not in seen:
                    del self._ready[url]     # replaced replica
            for url in list(self._cooldown):
                if self._cooldown[url] <= time.monotonic():
                    del self._cooldown[url]

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sweep_health()
            except Exception:  # noqa: BLE001 — the sweep must survive
                pass
            self._stop.wait(_health_interval())

    def start(self) -> None:
        self.sweep_health()                   # never serve blind
        self._health_thread = threading.Thread(
            target=self._health_loop, name="h2o-torch-router-health",
            daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)

    def any_shard_healthy(self) -> bool:
        table = self.table()
        with self._lock:
            for urls in (table.get("shards") or {}).values():
                if any(self._ready.get(u.rstrip("/")) for u in urls):
                    return True
        return False

    def shard_health(self) -> dict:
        table = self.table()
        out = {}
        with self._lock:
            for sid, urls in (table.get("shards") or {}).items():
                reps = {u.rstrip("/"): bool(self._ready.get(
                    u.rstrip("/"))) for u in urls}
                out[sid] = {"healthy": any(reps.values()),
                            "replicas": reps}
        return out

    # -- retry budget ---------------------------------------------------------

    def _retry_token(self, model_key: str) -> bool:
        """Take one cross-shard-retry token from the tenant's bucket
        (runtime/retry.bucket_take — the SAME bucket step as rest.py's
        per-tenant rate limit, so the two budgets can never drift).
        Accounting is exact: `granted` counts every token consumed,
        `denied` every refusal — the drill's never-exceeded proof
        reads these off /3/Stats."""
        from ..runtime.retry import bucket_take

        rate = _retry_budget_rate()
        with self._lock:
            if rate <= 0 or bucket_take(self._retry_buckets, model_key,
                                        rate, time.monotonic()) > 0.0:
                self.retry_budget["denied"] += 1
                return False
            self.retry_budget["granted"] += 1
            # counted HERE, not at the call sites: every granted token
            # IS a cross-shard re-dispatch (sequential retry or hedge),
            # so stats["retries"] == retry_budget["granted"] is
            # structural — the drill's never-exceeded audit can never
            # find phantom unaccounted tokens, hedging armed or not
            self.stats["retries"] += 1
            return True

    # -- candidate selection --------------------------------------------------

    def candidates(self, model_key: str):
        """(known, [(shard, [replica_url, ...]), ...]) — every healthy
        shard in the key's preference order, each with its READY
        replicas rotated round-robin (first = this request's primary,
        the rest = INTRA-shard failover order: a replica that dies
        between health sweeps must not 503 a single-shard tail tenant
        while a READY sibling sits next to it). Cooled-down replicas
        are skipped for their Retry-After window. Reads the
        sweep-cached table snapshot — never the O(catalog) provider —
        on the request path."""
        table = self.table()
        prefs = (table.get("keys") or {}).get(model_key)
        if prefs is None:
            return False, []
        shards = table.get("shards") or {}
        now = time.monotonic()
        out = []
        with self._lock:
            for sid in prefs:
                urls = [u.rstrip("/") for u in shards.get(sid, ())]
                live = [u for u in urls if self._ready.get(u)
                        and self._cooldown.get(u, 0.0) <= now]
                if not live:
                    continue
                i = self._rr.get(sid, 0)
                self._rr[sid] = i + 1
                out.append((sid, live[i % len(live):]
                            + live[: i % len(live)]))
        return True, out

    # -- dispatch -------------------------------------------------------------

    def _call_one(self, url: str, path: str, body: bytes,
                  headers: dict, deadline: float | None,
                  tid: str | None = None) -> dict:
        """One upstream POST. Returns {"code", "body", "retry_after"}
        for any HTTP answer; raises _Transport for connection-level
        failures (the failover shape)."""
        timeout = _router_timeout()
        hdrs = {"Content-Type": headers.get("Content-Type",
                                            "application/json")}
        if headers.get("X-H2O-SLO"):
            hdrs["X-H2O-SLO"] = headers["X-H2O-SLO"]
        if tid:
            # trace propagation: the replica records its queue/batch/
            # dispatch spans under the SAME id the router minted, so
            # one GET /3/Trace/{id} per hop reassembles the request
            hdrs["X-H2O-Trace-Id"] = tid
        if deadline is not None:
            # forward the REMAINING budget: the replica's admission
            # and batcher enforce the client's true deadline, minus
            # the time already spent at the front door
            rem_ms = (deadline - time.monotonic()) * 1000.0
            if rem_ms <= 0:
                raise _BudgetExpired("deadline exhausted before "
                                     "dispatch")
            hdrs["X-H2O-Deadline-Ms"] = f"{rem_ms:.1f}"
            timeout = min(timeout, rem_ms / 1000.0 + 1.0)
        req = urllib.request.Request(url + path, data=body,
                                     method="POST", headers=hdrs)
        try:
            with _FORWARD_OPENER.open(req, timeout=timeout) as r:
                return {"code": r.status, "body": r.read(),
                        "retry_after": None}
        except urllib.error.HTTPError as e:
            ra = e.headers.get("Retry-After")
            try:
                ra = float(ra) if ra is not None else None
            except ValueError:
                ra = None
            return {"code": e.code, "body": e.read(), "retry_after": ra}
        except Exception as e:  # noqa: BLE001 — refused/reset/timeout
            raise _Transport(repr(e)[:200]) from None

    def _bump_shard(self, sid: str, field: str) -> None:
        with self._lock:
            rec = self.by_shard.setdefault(
                sid, {"forwarded": 0, "errors": 0, "hedge_won": 0,
                      "hedge_lost": 0, "hedge_cancelled": 0})
            rec[field] += 1

    def _hedge_outcome(self, sid: str, outcome: str) -> None:
        """Per-shard hedge-race accounting: `hedge_won` — the hedge
        leg's answer was relayed; `hedge_lost` — the hedge answered
        but the primary's answer won; `hedge_cancelled` — the primary
        won while the hedge was still in flight (its eventual answer
        is discarded unread). One of the three fires for EVERY fired
        hedge, so won+lost+cancelled == hedges holds structurally."""
        self._bump_shard(sid, f"hedge_{outcome}")
        telemetry.REGISTRY.counter(
            f"h2o_router_hedge_{outcome}_total",
            f"hedged dispatches whose race ended {outcome}, per "
            "shard", label="shard").inc(label_value=sid)

    def _bump_model(self, model_key: str) -> None:
        """The per-tenant relayed-success counter, bounded at
        4x H2O_TPU_METRICS_TOPK named keys: at capacity a newcomer
        evicts a ONE-count resident into `other` (so a flood of cold
        one-request probes cannot permanently squat every named slot),
        else the newcomer itself rolls into `other`. The genuinely
        traffic-ranked top-K view is the registry counter below —
        its series cap demotes by observed traffic."""
        from ..runtime.telemetry import _topk

        local_key = model_key
        with self._lock:
            cap = 4 * _topk()
            named = [k for k in self.by_model if k != "other"]
            if local_key not in self.by_model and len(named) >= cap:
                coldest = min(named, key=self.by_model.get)
                # a single prior request is all a newcomer needs to
                # out-rank a 1-count resident; ties keep the resident
                if self.by_model[coldest] <= 1:
                    self.by_model["other"] = \
                        self.by_model.get("other", 0) \
                        + self.by_model.pop(coldest)
                else:
                    local_key = "other"
            self.by_model[local_key] = \
                self.by_model.get(local_key, 0) + 1
        # the registry counter gets the REAL tenant key — its own
        # traffic-ranked series cap decides the exposed label set,
        # and it can only rank what it observes (feeding it the
        # locally-capped 'other' would lock a late-arriving hot
        # tenant out of a named series forever)
        telemetry.REGISTRY.counter(
            "h2o_router_forwarded_total",
            "requests relayed with a non-5xx answer, per tenant "
            "(top-K + other)", label="model").inc(label_value=model_key)

    def route(self, model_key: str, path: str, body: bytes,
              headers: dict, deadline: float | None,
              slo: str | None, tid: str | None = None
              ) -> tuple[int, bytes, dict]:
        """Resolve + forward with failover/hedging under the retry
        budget; returns (status, body bytes, response headers).
        ``tid`` is the request's trace id: every dispatch attempt is
        recorded as a span under it (outcome + shard + duration), and
        the final relay increments the tenant's forwarded counter
        exactly once — whatever failover/hedging did in between."""
        attempts: list[dict] = []
        t0 = time.monotonic()
        try:
            code, body_out, hdrs = self._route_inner(
                model_key, path, body, headers, deadline, slo, tid,
                attempts)
        except BaseException:
            if tid:
                telemetry.TRACER.record(tid, attempts, model=model_key,
                                        hop="router")
            raise
        dur = time.monotonic() - t0
        if dur >= _SLOW_ROUTE_S:
            log.warning("slow route: tenant %s answered %d after %.1f s; "
                        "attempts %s", model_key, code, dur, attempts)
        telemetry.REGISTRY.histogram(
            "h2o_router_route_seconds",
            "front-door routing latency (resolve + failover + "
            "upstream)").observe(dur)
        if tid:
            telemetry.TRACER.record(
                tid, attempts + [{"name": "route", "outcome": code,
                                  "ms": round(dur * 1000.0, 3)}],
                model=model_key, hop="router")
        if code < 500 and code != 404:
            # relayed non-5xx = the tenant's one forwarded answer
            # (404 excluded: an unknown-model probe must not mint
            # per-tenant series for attacker-chosen keys)
            self._bump_model(model_key)
        return code, body_out, hdrs

    @staticmethod
    def _attempt(attempts: list, sid: str, url: str, outcome: str,
                 t_start: float) -> None:
        attempts.append({
            "name": "dispatch", "shard": sid, "url": url,
            "outcome": outcome,
            "ms": round((time.monotonic() - t_start) * 1000.0, 3)})

    def _route_inner(self, model_key: str, path: str, body: bytes,
                     headers: dict, deadline: float | None,
                     slo: str | None, tid: str | None,
                     attempts: list) -> tuple[int, bytes, dict]:
        with self._lock:
            self.stats["requests"] += 1
        known, cands = self.candidates(model_key)
        if not known:
            if self.table().get("cold"):
                # a store-backed router that has never seen a table
                # cannot distinguish "unknown tenant" from "table not
                # yet published" — a typed degraded 503 keeps the
                # client retrying instead of a 404 that lies about
                # the catalog
                with self._lock:
                    self.stats["degraded_503"] += 1
                return 503, json.dumps(
                    {"__schema": "H2OErrorV3", "http_status": 503,
                     "msg": "router has no routing table yet (store "
                     "cold or controller not elected); retry shortly",
                     "hint": "table_pending",
                     "model": model_key}).encode(), \
                    {"Retry-After": "1"}
            with self._lock:
                self.stats["unknown_model_404"] += 1
            return 404, json.dumps(
                {"__schema": "H2OErrorV3", "http_status": 404,
                 "msg": f"model '{model_key}' is not in this fleet's "
                 "catalog"}).encode(), {}
        if not cands:
            # degraded mode: the tenant exists but no placed shard is
            # serving — a TYPED 503 the client can distinguish from a
            # generic outage: the reconciler is re-placing the
            # artifact; retry shortly and the routing table will have
            # a survivor
            with self._lock:
                self.stats["degraded_503"] += 1
            return 503, json.dumps(
                {"__schema": "H2OErrorV3", "http_status": 503,
                 "msg": f"tenant '{model_key}': every placed shard is "
                 "down; artifact re-placement onto a surviving shard "
                 "is in progress", "hint": "placement_pending",
                 "model": model_key}).encode(), {"Retry-After": "1"}

        hedge_s = _hedge_ms() / 1000.0
        start_i = 0
        last: dict | None = None
        if hedge_s > 0 and slo == "interactive" and len(cands) >= 2:
            h = self._route_hedged(model_key, path, body, headers,
                                   deadline, cands, tid, attempts)
            if h.get("expired"):
                return self._expired_504(model_key)
            if "relay" in h:
                return h["relay"]
            # hedged legs did not produce a success: continue the
            # SEQUENTIAL path from the first un-tried candidate, with
            # the best answered response kept for relay — arming the
            # hedge switch must never give up failover the sequential
            # path would have performed
            start_i = h["resume"]
            last = h.get("last")

        for i in range(start_i, len(cands)):
            sid, urls = cands[i]
            if deadline is not None and \
                    time.monotonic() >= deadline:
                # the client's budget died mid-route: 504 like the
                # replica path (rest.py) for the identical condition,
                # and NO retry tokens burned on dispatches that can
                # never be sent
                return self._expired_504(model_key)
            if i > 0:
                # a cross-shard retry — budget-gated so a dying shard
                # cannot amplify its load onto the survivors (the
                # grant itself increments stats["retries"])
                if not self._retry_token(model_key):
                    with self._lock:
                        self.stats["retry_denied"] += 1
                    break
            res = None
            for j, url in enumerate(urls):
                t_call = time.monotonic()
                try:
                    res = self._call_one(url, path, body, headers,
                                         deadline, tid)
                    break
                except _BudgetExpired:
                    self._attempt(attempts, sid, url,
                                  "budget_expired", t_call)
                    return self._expired_504(model_key)
                except _Transport as e:
                    self._attempt(attempts, sid, url,
                                  "transport_error", t_call)
                    attempts[-1]["error"] = str(e)
                    # INTRA-shard failover on a connection-level
                    # failure is free (nothing was processed, no
                    # duplicated work — and token-gating it would
                    # starve a single-shard tail tenant on one
                    # replica death); each replica is tried at most
                    # once, so it stays bounded
                    with self._lock:
                        self.stats["transport_errors"] += 1
                        if j + 1 < len(urls) or i + 1 < len(cands):
                            self.stats["failovers"] += 1
                    self._bump_shard(sid, "errors")
            if res is None:
                continue        # shard dead at transport level
            if res["code"] >= 500:
                # an answered 5xx (drain 503, breaker open): honor its
                # Retry-After as a replica cooldown so we do not
                # re-dispatch into the same recovering pod, and keep
                # the response to relay if no survivor answers
                if res["retry_after"]:
                    with self._lock:
                        self._cooldown[url] = time.monotonic() + \
                            min(float(res["retry_after"]), 30.0)
                with self._lock:
                    self.stats["relayed_5xx"] += 1
                self._bump_shard(sid, "errors")
                self._attempt(attempts, sid, url, "answered_5xx",
                              t_call)
                last = res
                continue
            # 2xx and 4xx (including a tenant's own 429 rate limit —
            # retrying that on another shard would defeat the limit)
            # relay as-is
            with self._lock:
                self.stats["forwarded"] += 1
            self._bump_shard(sid, "forwarded")
            self._attempt(attempts, sid, url, "forwarded", t_call)
            return self._relay(res)
        if last is not None:
            return self._relay(last)
        with self._lock:
            self.stats["transport_errors"] += 1
        return 503, json.dumps(
            {"__schema": "H2OErrorV3", "http_status": 503,
             "msg": f"tenant '{model_key}': no shard answered (retry "
             "budget or candidates exhausted)"}).encode(), \
            {"Retry-After": "1"}

    def _expired_504(self, model_key: str) -> tuple[int, bytes, dict]:
        return 504, json.dumps(
            {"__schema": "H2OErrorV3", "http_status": 504,
             "msg": f"tenant '{model_key}': X-H2O-Deadline-Ms budget "
             "expired during routing — dropped unscored"}).encode(), {}

    @staticmethod
    def _relay(res: dict) -> tuple[int, bytes, dict]:
        hdrs = {}
        if res.get("retry_after") is not None:
            hdrs["Retry-After"] = str(
                max(1, int(float(res["retry_after"]) + 0.999)))
        return res["code"], res["body"], hdrs

    def _leg_failed(self, result, more_candidates: bool,
                    attempts: list):
        """Sequential-path bookkeeping for one failed hedge leg: a
        5xx answer records its Retry-After cooldown + relayed_5xx (so
        arming the hedge switch never skips the cooldown the
        sequential path applies), a transport failure counts like any
        other. Returns the answered response (for relay-of-last-
        resort) or None."""
        kind, sid, url, res, dur_ms = result
        if kind == "ok":
            if res["retry_after"]:
                with self._lock:
                    self._cooldown[url] = time.monotonic() + \
                        min(float(res["retry_after"]), 30.0)
            with self._lock:
                self.stats["relayed_5xx"] += 1
            self._bump_shard(sid, "errors")
            attempts.append({"name": "dispatch", "shard": sid,
                             "url": url, "outcome": "answered_5xx",
                             "ms": dur_ms})
            return res
        with self._lock:
            self.stats["transport_errors"] += 1
            if more_candidates:
                self.stats["failovers"] += 1
        self._bump_shard(sid, "errors")
        attempts.append({"name": "dispatch", "shard": sid, "url": url,
                         "outcome": "transport_error", "ms": dur_ms})
        return None

    def _route_hedged(self, model_key, path, body, headers, deadline,
                      cands, tid=None, attempts=None) -> dict:
        """Speculative dual-dispatch for interactive traffic: primary
        first; if it has not answered inside the hedge window AND the
        tenant's budget grants a token, fire the next shard and take
        whichever SUCCEEDS first. Returns ``{"relay": response}`` on a
        success, else ``{"resume": i, "last": res|None}`` — the caller
        continues the normal sequential failover from candidate ``i``
        with the best answered (5xx) response kept for relay, so a
        fast-failing primary gets exactly the sequential semantics
        (cooldown, budget-gated failover), never a relayed 5xx that
        a healthy replica shard could have absorbed.

        Race accounting: every fired hedge resolves to exactly one of
        hedge_won / hedge_lost / hedge_cancelled on the HEDGE shard's
        counters (see _hedge_outcome) — and the tenant's forwarded
        counter is untouched here (the route() wrapper increments it
        once on the final relay), so a lost hedge can never
        double-count a request."""
        if attempts is None:
            attempts = []
        results: list = [None, None]
        done = threading.Event()
        hedged = [False]

        def leg(i: int, target) -> None:
            sid, urls = target
            url = urls[0]
            t_call = time.monotonic()

            def dur():
                return round((time.monotonic() - t_call) * 1000.0, 3)

            try:
                results[i] = ("ok", sid, url,
                              self._call_one(url, path, body, headers,
                                             deadline, tid), dur())
            except _BudgetExpired as e:
                results[i] = ("expired", sid, url, e, dur())
            except _Transport as e:
                results[i] = ("transport", sid, url, e, dur())
            done.set()

        def settle_hedge(winner: int) -> None:
            """The race ended with a relayed answer from ``winner``:
            file the hedge leg's outcome (won / lost / cancelled)."""
            if not hedged[0]:
                return
            sid1 = cands[1][0]
            if winner == 1:
                self._hedge_outcome(sid1, "won")
            elif results[1] is not None:
                self._hedge_outcome(sid1, "lost")
            else:
                self._hedge_outcome(sid1, "cancelled")

        def won(i: int):
            """Relay dict when leg i holds a success."""
            kind, sid, url, res, dur_ms = results[i]
            if kind != "ok" or res["code"] >= 500:
                return None
            with self._lock:
                self.stats["forwarded"] += 1
                if i == 1:
                    self.stats["hedge_wins"] += 1
            self._bump_shard(sid, "forwarded")
            attempts.append({"name": "dispatch", "shard": sid,
                             "url": url, "outcome": "forwarded",
                             "ms": dur_ms,
                             **({"hedge_leg": i} if hedged[0]
                                else {})})
            settle_hedge(i)
            return {"relay": self._relay(res)}

        threading.Thread(target=leg, args=(0, cands[0]),
                         daemon=True).start()
        end0 = time.monotonic() + _hedge_ms() / 1000.0
        while results[0] is None and time.monotonic() < end0:
            done.wait(0.005)
            done.clear()
        if results[0] is not None:
            # primary answered INSIDE the hedge window: a success
            # relays, a failure takes the sequential path from
            # candidate 1 — the hedge never fires
            if results[0][0] == "expired":
                return {"expired": True}
            out = won(0)
            if out is not None:
                return out
            last = self._leg_failed(results[0], len(cands) > 1,
                                    attempts)
            return {"resume": 1, "last": last}
        # primary slow: fire the hedge (it is load amplification, so
        # it is budget-gated like any retry)
        if self._retry_token(model_key):
            with self._lock:
                self.stats["hedges"] += 1
            hedged[0] = True
            threading.Thread(target=leg, args=(1, cands[1]),
                             daemon=True).start()
            fired_legs = (0, 1)
        else:
            with self._lock:
                self.stats["retry_denied"] += 1
            fired_legs = (0,)
        # wait for a success from whichever legs are running
        end = time.monotonic() + _router_timeout()
        handled = set()
        last = None
        while time.monotonic() < end:
            for i in fired_legs:
                if results[i] is None or i in handled:
                    continue
                if results[i][0] == "expired":
                    if hedged[0]:
                        # the race ends here too: settle the hedge
                        # leg so won+lost+cancelled == hedges holds
                        # even when the deadline dies mid-race
                        self._hedge_outcome(
                            cands[1][0],
                            "lost" if results[1] is not None
                            else "cancelled")
                    return {"expired": True}
                out = won(i)
                if out is not None:
                    return out
                handled.add(i)
                res = self._leg_failed(results[i],
                                       len(cands) > len(fired_legs),
                                       attempts)
                if res is not None:
                    last = res
            if len(handled) == len(fired_legs):
                break
            done.wait(0.01)
            done.clear()
        if hedged[0]:
            # no leg relayed: the race had no winner — count the
            # hedge leg by what it DID (answered-and-failed = lost,
            # still in flight when we gave up = cancelled) so
            # won+lost+cancelled == hedges stays structural
            self._hedge_outcome(cands[1][0],
                                "lost" if results[1] is not None
                                else "cancelled")
        return {"resume": len(fired_legs), "last": last}

    # -- admission ------------------------------------------------------------

    def admit(self) -> bool:
        with self._lock:
            if self._inflight >= _max_inflight():
                self.stats["inflight_shed"] += 1
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1

    def snapshot(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
            budget = dict(self.retry_budget)
            by_shard = {k: dict(v) for k, v in self.by_shard.items()}
            by_model = dict(self.by_model)
            inflight = self._inflight
        tbl = self.table()
        gen = tbl.get("table_generation") if isinstance(tbl, dict) \
            else None
        out = {"router": True, "stats": stats,
               "retry_budget": {**budget,
                                "rate_per_s": _retry_budget_rate()},
               "by_shard": by_shard, "by_model": by_model,
               "inflight": inflight,
               "hedge_ms": _hedge_ms(),
               "table_generation": gen,
               "shards": self.shard_health(),
               "build": telemetry.build_info()}
        prov = getattr(self.get_table, "snapshot", None)
        if callable(prov):
            out["table_provider"] = prov()
        return out


def _make_handler(router: ScoringRouter):
    # rest.py is imported lazily HERE (not at module import): the
    # handler genuinely reuses the server plumbing, but a router
    # process should not pay the numpy import until it actually serves
    from ..rest import (JsonHttpHandler, _DeadlineExpired,
                        _request_deadline, _request_slo)

    class _RouterHandler(JsonHttpHandler):
        server_version = "h2o-torch-router/1"

        def do_GET(self):
            import urllib.parse

            path = urllib.parse.urlparse(self.path).path.rstrip("/")
            if path == "/healthz":
                st = lifecycle.status()
                alive = st["state"] != lifecycle.TERMINATED
                return self._json({"alive": alive, "router": True,
                                   **st}, 200 if alive else 503)
            if path == "/readyz":
                ready = router.any_shard_healthy() and \
                    lifecycle.accepting()
                return self._json(
                    {"ready": ready, "router": True},
                    200 if ready else 503)
            if path == "/3/Stats":
                return self._json({"ready":
                                   router.any_shard_healthy(),
                                   **router.snapshot()})
            if path == "/metrics":
                # Prometheus exposition at the front door: the
                # process-wide registry (hedge outcome + forwarded
                # counters, route-latency histogram, build info) plus
                # this router instance's snapshot flattened in.
                # by_model/shards are excluded from the flatten —
                # tenant keys and replica URLs must never become
                # metric NAMES (the capped first-class counters carry
                # them as labels instead).
                snap = router.snapshot()
                extra = {"router": {
                    k: v for k, v in snap.items()
                    if k not in ("by_model", "shards", "build")}}
                telemetry.write_metrics(self, extra)
                return None
            if path.startswith("/3/Trace/"):
                # the router's half of a request trace: one span per
                # dispatch attempt (shard, outcome, duration) + the
                # route total — pair it with the replica's
                # /3/Trace/{id} for the full hop decomposition
                tid = urllib.parse.unquote(path[len("/3/Trace/"):])
                rec = telemetry.TRACER.get(tid)
                if rec is None:
                    return self._error(
                        404, f"trace '{tid}' not in the router's ring")
                return self._json(rec)
            return self._error(404, f"no route for GET {path}")

        def do_POST(self):
            import urllib.parse

            try:
                path = urllib.parse.urlparse(
                    self.path).path.rstrip("/")
                if not lifecycle.accepting():
                    self._discard_body()
                    return self._error(
                        503, f"router {lifecycle.state()}: draining",
                        retry_after=lifecycle.remaining_drain_budget())
                prefix = "/3/Predictions/models/"
                if not path.startswith(prefix):
                    self._discard_body()
                    return self._error(
                        404, f"no route for POST {path} (the router "
                        "forwards scoring + contributions only)")
                rest_part = path[len(prefix):]
                mkey = rest_part
                if rest_part.endswith("/contributions"):
                    mkey = rest_part[: -len("/contributions")]
                mkey = urllib.parse.unquote(mkey)
                # the router MINTS the trace id when the client sent
                # none — from here every hop (forward headers, replica
                # span records, hedge legs) carries the same id
                tid = telemetry.trace_id_from(self.headers)
                try:
                    deadline = _request_deadline(self.headers)
                    slo = _request_slo(self.headers)
                except ValueError as e:
                    self._discard_body()
                    return self._error(400, str(e))
                except _DeadlineExpired as e:
                    # same discard discipline as the 400: the body is
                    # still unread here, and closing with unread bytes
                    # sends RST — which can destroy the buffered 504
                    # client-side
                    self._discard_body()
                    return self._error(504, str(e))
                if not router.admit():
                    self._discard_body()
                    return self._error(
                        429, "router in-flight limit reached "
                        "(H2O_TPU_ROUTER_MAX_INFLIGHT); shed",
                        retry_after=1.0)
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(n) if n else b""
                    # self.headers (not dict()): HTTPMessage lookups
                    # are case-insensitive, and proxies en route may
                    # have re-capitalized X-H2O-SLO
                    code, out, hdrs = router.route(
                        mkey, path, body, self.headers,
                        deadline, slo, tid=tid)
                finally:
                    router.release()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.send_header("X-H2O-Trace-Id", tid)
                for k, v in hdrs.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(out)
                return None
            except _DeadlineExpired as e:
                return self._error(504, str(e))
            except Exception as e:  # noqa: BLE001
                import traceback

                traceback.print_exc()
                return self._error(500, repr(e))

    return _RouterHandler


class _RouterServer(ThreadingHTTPServer):
    request_queue_size = lifecycle.LISTEN_BACKLOG


def start_router(table, port: int = 0, host: str = "127.0.0.1"
                 ) -> tuple[ThreadingHTTPServer, ScoringRouter]:
    """Start a router over ``table`` (a dict or a zero-arg callable —
    ``ShardedPool.routing_table`` is the intended provider). Returns
    (server, router); ``server.server_address[1]`` is the bound port.
    Tear down with ``router.stop(); server.shutdown()``."""
    router = ScoringRouter(table)
    srv = _RouterServer((host, port), _make_handler(router))
    router.start()
    t = threading.Thread(target=srv.serve_forever,
                         name="h2o-torch-router", daemon=True)
    t.start()
    return srv, router


def main(argv=None) -> int:
    """``python -m h2o_kubernetes_tpu_torch.operator.router --store ROOT
    --pool NAME [--port P]`` — one stateless router process over a
    durable store root. Start N of them behind any TCP balancer: they
    share nothing but the store, so killing any one of them loses
    nothing but its in-flight sockets."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        description="store-backed front-door scoring router")
    ap.add_argument("--store", required=True,
                    help="DurablePoolStore root (dir or mem://)")
    ap.add_argument("--pool", required=True, help="pool name")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)

    from .store import DurablePoolStore

    provider = StoreRoutingTable(DurablePoolStore(args.store),
                                 args.pool)
    srv, router = start_router(provider, port=args.port,
                               host=args.host)
    print(f"ROUTER_UP port={srv.server_address[1]} "
          f"pool={args.pool}", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        router.stop()
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
