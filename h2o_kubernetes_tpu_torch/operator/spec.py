"""H2OScorerPool spec model + the dict-backed in-process API server.

The reference operator watches an ``H2O`` CRD in the kube API server
and reconciles StatefulSets against it; here the
"API server" is an in-process, thread-safe store with the same
observable semantics — specs carry a monotonically increasing
``generation``, status is written by the controller, and events are a
bounded log — so the reconciler is written against an interface a
kubeconfig-backed store can implement later without changing it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from dataclasses import dataclass, field, replace

__all__ = ["ScorerPoolSpec", "PoolStore", "StaleGenerationError"]


class StaleGenerationError(RuntimeError):
    """A fenced write carried a generation that is no longer current —
    the writer is a stale controller (or raced another apply) and its
    view of the spec must not overwrite the newer one."""


@dataclass(frozen=True)
class ScorerPoolSpec:
    """Declarative spec of one scorer pool (the CRD analog).

    ``artifact``/``version`` name a model-registry artifact
    (registry.publish's name + version); ``model_key`` is the stable
    REST key replicas serve it under — it stays the same across
    versions so client URLs survive rolling updates.
    """

    name: str                      # pool name (store key)
    artifact: str                  # registry artifact name
    version: int                   # pinned artifact version (rolls on change)
    model_key: str = "model"       # MODELS key on every replica
    replicas: int = 1              # desired serving replicas
    min_replicas: int = 1          # autoscale floor
    max_replicas: int = 8          # autoscale ceiling
    autoscale: bool = False        # reconciler adjusts `replicas` itself
    # pow2 batches warmed before readyz; None = let each REPLICA
    # resolve H2O_TPU_POOL_WARM_BUCKETS (default 128,1024) — pinning a
    # tuple here overrides the env knob for this pool
    warm_buckets: tuple | None = None
    # default SLO class for the primary artifact's traffic (rest.py
    # SLO_CLASSES; None = the replica's H2O_TPU_SLO_DEFAULT)
    slo: str | None = None
    # multi-tenant pools: extra (artifact, version, model_key[, slo])
    # tuples pushed to EVERY replica alongside the primary — /readyz
    # holds until ALL of them are loaded + warmed (the replica's
    # required-model readiness set is declared before the first push).
    # The PRIMARY artifact/version still drives rolling updates; a
    # changed extra artifact rides the next primary version bump.
    extra_artifacts: tuple = ()
    # tenant sharding (operator/placement.py + ShardedPool): >1 splits
    # the catalog across this many shard groups (each `replicas` wide)
    # via rendezvous hashing instead of pushing everything everywhere.
    # The catalog order (primary first, then extra_artifacts) is the
    # POPULARITY rank: the first `head_models` keys are replicated on
    # every shard (instant router failover for the Zipf head), the
    # tail lands on exactly `tail_replicas` shards. shards == 1 is the
    # legacy everyone-has-everything pool, bit-for-bit.
    shards: int = 1
    head_models: int = 1           # catalog prefix replicated everywhere
    tail_replicas: int = 1         # shards per tail tenant
    env: dict = field(default_factory=dict)   # extra pod env overrides

    def validate(self) -> "ScorerPoolSpec":
        if not self.name or not self.artifact or not self.model_key:
            raise ValueError("pool spec needs name, artifact and "
                             "model_key")
        if self.version < 1:
            raise ValueError(f"version must be >= 1, got {self.version}")
        if self.replicas < 0:
            raise ValueError(f"replicas must be >= 0, got "
                             f"{self.replicas}")
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        if self.warm_buckets is not None and not self.warm_buckets:
            raise ValueError("warm_buckets must name at least one "
                             "batch bucket, or be None to defer to "
                             "the replica's H2O_TPU_POOL_WARM_BUCKETS")
        # SLO classes validate at APPLY time: a typo'd class would
        # otherwise pass here and 400 on every replica's artifact
        # push — the pool wedging in a replace loop instead of the
        # spec being rejected (validate()'s whole job)
        from ..rest import SLO_CLASSES

        def _check_slo(slo, where):
            if slo is not None and slo not in SLO_CLASSES:
                raise ValueError(
                    f"unknown SLO class {slo!r} for {where} "
                    f"(known: {', '.join(sorted(SLO_CLASSES))})")

        _check_slo(self.slo, "the primary artifact")
        keys = [self.model_key]
        for ent in self.extra_artifacts:
            ent = tuple(ent)
            if len(ent) not in (3, 4) or not ent[0] or not ent[2]:
                raise ValueError(
                    "extra_artifacts entries must be (artifact, "
                    f"version, model_key[, slo]) tuples, got {ent!r}")
            if int(ent[1]) < 1:
                raise ValueError(
                    f"extra artifact {ent[0]!r} version must be >= 1")
            if len(ent) > 3:
                _check_slo(ent[3], f"extra artifact {ent[0]!r}")
            keys.append(ent[2])
        if len(set(keys)) != len(keys):
            raise ValueError(
                f"duplicate model_key across the pool's artifacts: "
                f"{sorted(k for k in set(keys) if keys.count(k) > 1)}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if not (1 <= self.tail_replicas <= max(1, self.shards)):
            raise ValueError(
                f"need 1 <= tail_replicas ({self.tail_replicas}) <= "
                f"shards ({self.shards})")
        if not (0 <= self.head_models <= len(keys)):
            raise ValueError(
                f"head_models ({self.head_models}) must be within the "
                f"catalog (0..{len(keys)})")
        if self.shards > 1 and self.head_models < 1:
            # every shard's child pool needs the primary artifact (it
            # is the rank-1 head by the catalog-order convention), so
            # a sharded pool replicates at least the primary
            raise ValueError("a sharded pool needs head_models >= 1 "
                             "(the primary model is the rank-1 head "
                             "and lives on every shard)")
        return self

    def all_artifacts(self) -> list[tuple]:
        """Every (artifact, version, model_key, slo) a replica must
        serve, primary first — the push list AND the required-model
        readiness set."""
        items = [(self.artifact, int(self.version), self.model_key,
                  self.slo)]
        for ent in self.extra_artifacts:
            ent = tuple(ent)
            items.append((ent[0], int(ent[1]), ent[2],
                          ent[3] if len(ent) > 3 else None))
        return items


_EVENT_CAP = 256        # bounded: a flapping pool must not grow memory


class PoolStore:
    """Thread-safe dict-backed spec/status/event store (etcd analog).

    Writes accept an optional ``fence`` — the generation the writer
    last observed. A fenced write whose generation is no longer
    current raises :class:`StaleGenerationError` instead of landing
    (optimistic concurrency, the resourceVersion-precondition analog):
    a controller that kept running against an old store snapshot, or
    a second operator racing the first, cannot clobber newer state.
    Subclasses persist by overriding ``_persist``/``_forget`` (called
    under the store lock, so snapshots are never torn)."""

    def __init__(self):
        # RLock: _persist hooks run inside mutators while the lock is
        # held, and a durable subclass may re-read state to snapshot
        self._lock = threading.RLock()
        self._specs: dict[str, ScorerPoolSpec] = {}
        self._gens: dict[str, int] = {}
        self._status: dict[str, dict] = {}
        self._events: dict[str, collections.deque] = {}
        self._routing: dict[str, dict] = {}
        self._leases: dict[str, dict] = {}

    # -- durability hooks (no-ops on the in-memory store) ---------------------
    #
    # Split by WRITER, the spec/status-subresource discipline: specs
    # are written by whoever applies them (client, autoscaler), status
    # + events only by the owning controller — so a durable subclass
    # can keep the two in separate files and a controller status write
    # can never clobber a concurrent client spec update.

    def _persist_spec(self, name: str) -> None:
        """Called under the lock after a spec mutation of `name`."""

    def _persist_state(self, name: str) -> None:
        """Called under the lock after a status/event mutation."""

    def _refresh(self, name: str) -> None:
        """Called under the lock before a read — a durable subclass
        re-reads disk so one process observes another's writes."""

    def _forget(self, name: str) -> None:
        """Called under the lock after `name` is deleted."""

    def _persist_routing(self, name: str) -> None:
        """Called under the lock after a routing-table publish."""

    def _persist_lease(self, name: str) -> None:
        """Called under the lock after a lease mutation (a cleared
        lease persists as 'gone', not as a stale document)."""

    def _lease_guard(self, name: str):
        """Context manager serializing lease read-decide-write cycles
        ACROSS store instances. The in-memory store has exactly one
        instance per universe, so ``self._lock`` already suffices; a
        durable subclass shared by N processes must override this with
        a cross-process lock (flock) or the read-then-bump in
        ``acquire_lease`` races between two expired-lease claimants."""
        return contextlib.nullcontext()

    def _check_fence(self, name: str, fence: int | None) -> None:
        if fence is not None and fence != self._gens.get(name, 0):
            raise StaleGenerationError(
                f"pool '{name}': write fenced at generation {fence} "
                f"but the store is at {self._gens.get(name, 0)} — "
                "stale controller write rejected")

    # -- spec (the declarative side) ------------------------------------------

    def apply(self, spec: ScorerPoolSpec, fence: int | None = None,
              **updates) -> int:
        """Create or update a pool spec; field updates may be passed as
        kwargs against the stored spec (``store.apply(spec)`` or
        ``store.apply_update(name, replicas=3)`` style). Returns the
        new generation. No-op updates still bump the generation — the
        reconciler is level-triggered, so that is harmless. ``fence``
        makes the write conditional on the observed generation."""
        spec = replace(spec, **updates).validate() if updates \
            else spec.validate()
        with self._lock:
            self._refresh(spec.name)
            self._check_fence(spec.name, fence)
            self._specs[spec.name] = spec
            self._gens[spec.name] = self._gens.get(spec.name, 0) + 1
            self._persist_spec(spec.name)
            return self._gens[spec.name]

    def apply_update(self, name: str, fence: int | None = None,
                     **updates) -> int:
        with self._lock:
            self._refresh(name)
            cur = self._specs.get(name)
            if cur is None:
                raise KeyError(f"no pool '{name}'")
            return self.apply(replace(cur, **updates), fence=fence)

    def get(self, name: str) -> tuple[ScorerPoolSpec, int]:
        with self._lock:
            self._refresh(name)
            if name not in self._specs:
                raise KeyError(f"no pool '{name}'")
            return self._specs[name], self._gens[name]

    def pools(self) -> list[str]:
        with self._lock:
            return sorted(self._specs)

    def delete(self, name: str) -> None:
        with self._lock:
            self._specs.pop(name, None)
            self._gens.pop(name, None)
            self._status.pop(name, None)
            self._events.pop(name, None)
            self._routing.pop(name, None)
            self._leases.pop(name, None)
            self._forget(name)

    # -- status + events (the observed side) ----------------------------------

    def set_status(self, name: str, status: dict,
                   fence: int | None = None) -> None:
        with self._lock:
            self._refresh(name)
            self._check_fence(name, fence)
            self._status[name] = dict(status)
            self._persist_state(name)

    def get_status(self, name: str) -> dict:
        with self._lock:
            self._refresh(name)
            return dict(self._status.get(name, {}))

    def record_event(self, name: str, kind: str, msg: str = "") -> None:
        """Append one operator event (bounded ring; the drill
        acceptance reads the replica_died → replica_start →
        replica_ready sequence out of this)."""
        ev = {"t": time.time(), "kind": kind, "msg": msg}
        with self._lock:
            # refresh-then-append: the durable write below persists
            # the WHOLE state doc, so appending onto a stale cache
            # would clobber status/events another process wrote since
            # our last read (single state-writer is the design, but a
            # handoff window must merge, not overwrite)
            self._refresh(name)
            dq = self._events.setdefault(
                name, collections.deque(maxlen=_EVENT_CAP))
            dq.append(ev)
            self._persist_state(name)

    def events(self, name: str) -> list[dict]:
        with self._lock:
            self._refresh(name)
            return list(self._events.get(name, ()))

    # -- routing table (the front-door side) ----------------------------------
    #
    # The sharded controller publishes its routing table through the
    # store so N stateless routers can serve from one source of truth
    # (<pool>.routing.json on a durable root — controller-written,
    # router-read, same single-writer discipline as the state file).
    # ``table_generation`` is store-owned and monotonic, and bumps
    # ONLY when the table content changes: routers reject regressions
    # (a stale controller can never roll a newer table back), and an
    # unchanged republish every reconcile pass costs no churn.

    def publish_routing(self, name: str, table: dict,
                        epoch: int | None = None) -> int:
        """Publish the controller's routing table; returns the
        ``table_generation`` now current. ``epoch`` is the writer's
        lease epoch: when the pool's lease has moved past it, the
        writer was deposed and the publish raises
        :class:`StaleGenerationError` (split-brain fence — a new
        holder's takeover bumps the epoch, so the old holder's queued
        tables lose deterministically, never merge)."""
        # JSON-normalize so the content compare is stable across the
        # durable round-trip (tuples become lists, key order sorts)
        body = json.loads(json.dumps(
            {k: v for k, v in dict(table).items()
             if k != "table_generation"}, sort_keys=True))
        with self._lock:
            self._refresh(name)
            if epoch is not None:
                lease = self._leases.get(name)
                if lease is not None and \
                        int(lease.get("epoch", 0)) > int(epoch):
                    raise StaleGenerationError(
                        f"pool '{name}': routing publish fenced at "
                        f"lease epoch {epoch} but the lease is at "
                        f"epoch {lease.get('epoch')} — deposed "
                        "controller write rejected")
            cur = self._routing.get(name)
            if cur is not None:
                if {k: v for k, v in cur.items()
                        if k != "table_generation"} == body:
                    return int(cur["table_generation"])
            gen = (int(cur["table_generation"]) + 1) if cur else 1
            self._routing[name] = {"table_generation": gen, **body}
            self._persist_routing(name)
            return gen

    def get_routing(self, name: str) -> dict | None:
        """The last published routing doc (with ``table_generation``),
        or None if nothing was ever published."""
        with self._lock:
            self._refresh(name)
            doc = self._routing.get(name)
            return json.loads(json.dumps(doc)) if doc is not None \
                else None

    # -- controller lease (the HA side) ---------------------------------------
    #
    # A wall-clock TTL lease elects exactly one reconciling controller
    # out of N ``operator.run`` replicas. The epoch bumps on every
    # ownership change (takeover OR expired re-acquire), and doubles
    # as the write fence for publish_routing above: holding the lease
    # file is advisory, holding a CURRENT epoch is what lets writes
    # land — so a paused/partitioned holder that misses its heartbeat
    # window is structurally deposed, not just presumed dead.

    @staticmethod
    def _lease_expired(lease: dict, now: float) -> bool:
        return now - float(lease.get("renewed", 0.0)) > \
            float(lease.get("ttl", 0.0))

    def acquire_lease(self, name: str, holder: str,
                      ttl: float) -> int | None:
        """Try to take (or keep) the controller lease. Returns the
        lease epoch on success; None while another holder's lease is
        still live. Re-acquiring one's own live lease renews it
        without an epoch bump; claiming an expired lease bumps it."""
        now = time.time()
        with self._lease_guard(name):
            with self._lock:
                self._refresh(name)
                cur = self._leases.get(name)
                if cur is not None and not self._lease_expired(cur, now):
                    if cur.get("holder") != holder:
                        return None
                    self._leases[name] = dict(cur, renewed=now,
                                              ttl=float(ttl))
                    self._persist_lease(name)
                    return int(cur["epoch"])
                epoch = (int(cur.get("epoch", 0)) + 1) if cur else 1
                self._leases[name] = {
                    "holder": holder, "epoch": epoch,
                    "ttl": float(ttl), "renewed": now, "acquired": now}
                self._persist_lease(name)
                return epoch

    def renew_lease(self, name: str, holder: str, epoch: int) -> bool:
        """Heartbeat. Strict: False when the lease expired, changed
        hands, or the epoch moved — the caller must stop reconciling
        immediately (its routing writes are already fenced off)."""
        now = time.time()
        with self._lease_guard(name):
            with self._lock:
                self._refresh(name)
                cur = self._leases.get(name)
                if (cur is None or cur.get("holder") != holder
                        or int(cur.get("epoch", 0)) != int(epoch)
                        or self._lease_expired(cur, now)):
                    return False
                self._leases[name] = dict(cur, renewed=now)
                self._persist_lease(name)
                return True

    def get_lease(self, name: str) -> dict | None:
        with self._lock:
            self._refresh(name)
            doc = self._leases.get(name)
            return dict(doc) if doc is not None else None

    def release_lease(self, name: str, holder: str) -> None:
        """Voluntary handoff (clean shutdown): clears the lease so a
        standby takes over on its next poll instead of waiting out the
        TTL. Only the current holder's release does anything."""
        with self._lease_guard(name):
            with self._lock:
                self._refresh(name)
                cur = self._leases.get(name)
                if cur is not None and cur.get("holder") == holder:
                    # keep the epoch (monotonic forever): dropping it
                    # would reset the fence and let a long-deposed
                    # holder's writes land again after a release
                    self._leases[name] = {
                        "epoch": int(cur.get("epoch", 0)),
                        "released": True, "ttl": 0.0, "renewed": 0.0}
                    self._persist_lease(name)
