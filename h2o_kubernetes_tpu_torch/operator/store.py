"""Durable PoolStore — specs/status/events that survive operator death.

The in-memory ``PoolStore`` dies with the process that owns it; a real
operator's control plane must not (ROADMAP: "kubeconfig-backed store"
— this is the persist.py-backed step toward it, same observable
semantics). ``DurablePoolStore`` keeps the base class's in-memory view
as a cache and persists through a persist.py root (local dir or
``mem://``), split by WRITER the way kube splits the spec and status
subresources:

    <root>/<pool>.spec.json    {"generation", "spec"}      — client-written
    <root>/<pool>.state.json   {"status", "events"}        — controller-written
    <root>/<pool>.routing.json {"table_generation", ...}   — controller-written
    <root>/<pool>.lease.json   {"holder", "epoch", ...}    — lease-holder-written

so a drill (or a human) applying a spec bump from ONE process and the
operator writing status from ANOTHER can share a root without either
clobbering the other: each file has a single writer. Reads re-load
from disk (``_refresh``), so the operator observes a client's version
bump on its next reconcile pass, and a client polls live status —
the store file IS the API-server wire.

Every write goes through :func:`persist.write_bytes_atomic`
(write-temp + fsync + rename, read-back digest verify): an operator
SIGKILLed mid-write leaves the previous intact document, never a torn
one. The event ring stays bounded (the base class's deque cap), so
the state file cannot grow without bound under a flapping pool.

Generation fencing is inherited from ``PoolStore`` and checked against
the REFRESHED on-disk generation: a stale controller (or a split-brain
second operator) holding an old generation gets
``StaleGenerationError`` on any fenced write — stale writes lose
deterministically.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from dataclasses import asdict

from .. import persist
from .spec import _EVENT_CAP, PoolStore, ScorerPoolSpec

try:                               # not on Windows; lease guard degrades
    import fcntl
except ImportError:                # pragma: no cover
    fcntl = None

__all__ = ["DurablePoolStore"]


# mem:// roots live inside one process, so a module-level lock is a
# real cross-instance guard there (two DurablePoolStores over the same
# mem:// root are two threads, never two processes)
_MEM_LEASE_LOCKS: dict[str, threading.Lock] = {}
_MEM_LEASE_LOCKS_GUARD = threading.Lock()


class _FlockGuard:
    """Cross-process critical section for lease mutations on a
    directory root: N operator replicas share the root but not a
    process lock, and ``acquire_lease``'s read-decide-write must be
    atomic or two standbys racing an expired lease both claim it."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def __enter__(self):
        self._f = open(self.path, "a+")
        if fcntl is not None:
            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        try:
            if fcntl is not None:
                fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)
        finally:
            self._f.close()
            self._f = None
        return False


def _spec_from_doc(doc: dict) -> ScorerPoolSpec:
    """JSON round-trip loses tuple-ness; restore the spec's tuple
    fields so a reloaded spec compares equal to the applied one."""
    doc = dict(doc)
    if doc.get("warm_buckets") is not None:
        doc["warm_buckets"] = tuple(doc["warm_buckets"])
    doc["extra_artifacts"] = tuple(
        tuple(ent) for ent in doc.get("extra_artifacts") or ())
    return ScorerPoolSpec(**doc)


class DurablePoolStore(PoolStore):
    """persist.py-backed :class:`PoolStore` (file / mem backends)."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        self._load_all()

    def _spec_path(self, name: str) -> str:
        return persist.join_path(self.root, f"{name}.spec.json")

    def _state_path(self, name: str) -> str:
        return persist.join_path(self.root, f"{name}.state.json")

    def _routing_path(self, name: str) -> str:
        return persist.join_path(self.root, f"{name}.routing.json")

    def _lease_path(self, name: str) -> str:
        return persist.join_path(self.root, f"{name}.lease.json")

    @staticmethod
    def _read_doc(path: str) -> dict | None:
        """None = missing, unreadable, or tombstoned — all read as
        'not there'; the atomic writer means torn files cannot exist,
        so anything unparseable is foreign and skipped, not fatal."""
        try:
            doc = json.loads(persist.read_bytes(path))
        except (FileNotFoundError, ValueError, OSError):
            return None
        return doc or None

    # -- durability hooks (called under the store lock) -----------------------

    def _persist_spec(self, name: str) -> None:
        spec = self._specs.get(name)
        if spec is None:
            return
        persist.write_bytes_atomic(
            self._spec_path(name),
            json.dumps({"generation": self._gens.get(name, 0),
                        "spec": asdict(spec)}, indent=1).encode())

    def _persist_state(self, name: str) -> None:
        if name not in self._specs:
            # a deleted pool's state must not be resurrected by a
            # still-running operator's event/status writes — the
            # reconciler's loop keeps erroring (and evented) until
            # its owner stops it, but the files stay gone
            return
        persist.write_bytes_atomic(
            self._state_path(name),
            json.dumps({"status": self._status.get(name, {}),
                        "events": list(self._events.get(name, ()))},
                       indent=1).encode())

    def _persist_routing(self, name: str) -> None:
        doc = self._routing.get(name)
        if doc is None or name not in self._specs:
            return                      # same no-resurrect rule as state
        persist.write_bytes_atomic(
            self._routing_path(name),
            json.dumps(doc, indent=1).encode())

    def _persist_lease(self, name: str) -> None:
        doc = self._leases.get(name)
        path = self._lease_path(name)
        if doc is None:                 # released → file reads as gone
            try:
                if "://" in path:
                    persist.write_bytes(path, b"{}")
                else:
                    os.remove(path)
            except (FileNotFoundError, OSError):
                pass
            return
        persist.write_bytes_atomic(path, json.dumps(doc, indent=1).encode())

    def _lease_guard(self, name: str):
        if "://" in self.root:
            with _MEM_LEASE_LOCKS_GUARD:
                return _MEM_LEASE_LOCKS.setdefault(
                    f"{self.root}|{name}", threading.Lock())
        os.makedirs(self.root, exist_ok=True)
        return _FlockGuard(os.path.join(self.root,
                                        f"{name}.lease.lock"))

    def _refresh(self, name: str) -> None:
        """Re-read `name` from disk into the in-memory cache: the
        writer of a file re-reads its own last (atomic) write, and
        every OTHER process observes it — one store root, N
        processes, no watch machinery needed at this scale."""
        sdoc = self._read_doc(self._spec_path(name))
        if sdoc is None or "spec" not in sdoc:
            self._specs.pop(name, None)
            self._gens.pop(name, None)
        else:
            try:
                self._specs[name] = \
                    _spec_from_doc(sdoc["spec"]).validate()
                self._gens[name] = int(sdoc.get("generation", 1))
            except (TypeError, ValueError):
                pass                     # foreign junk: keep the cache
        tdoc = self._read_doc(self._state_path(name))
        if tdoc is not None:
            self._status[name] = dict(tdoc.get("status") or {})
            self._events[name] = collections.deque(
                tdoc.get("events") or (), maxlen=_EVENT_CAP)
        rdoc = self._read_doc(self._routing_path(name))
        if rdoc is not None and "table_generation" in rdoc:
            self._routing[name] = rdoc
        ldoc = self._read_doc(self._lease_path(name))
        if ldoc is None:
            self._leases.pop(name, None)
        elif "epoch" in ldoc:
            self._leases[name] = ldoc

    def _forget(self, name: str) -> None:
        paths = [self._spec_path(name), self._state_path(name),
                 self._routing_path(name), self._lease_path(name)]
        if "://" not in self.root:
            paths.append(os.path.join(self.root, f"{name}.lease.lock"))
        for path in paths:
            try:
                if "://" in path:
                    # mem:// has no delete verb; tombstone (skipped by
                    # _read_doc and the loader)
                    persist.write_bytes(path, b"{}")
                else:
                    os.remove(path)
            except (FileNotFoundError, OSError):
                pass

    # -- restart path ---------------------------------------------------------

    def _load_all(self) -> None:
        for fname in persist.list_names(self.root):
            if fname.endswith(".spec.json"):
                with self._lock:
                    self._refresh(fname[:-len(".spec.json")])
