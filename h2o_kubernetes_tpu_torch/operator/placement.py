"""Tenant placement: rendezvous hashing + popularity-aware replication.

The fleet's catalog (one model key per tenant) is placed across pool
SHARDS so no single replica has to hold every tenant (an unsharded
pool's ``extra_artifacts`` push puts the full catalog on each pod, and the
byte-budgeted scorer cache churns as soon as the catalog outgrows one
node's budget). The placement rules:

- **Rendezvous (HRW) hashing** orders the shards per key by
  ``hash(shard, key)``: deterministic for a fixed (catalog, shard-set)
  input, and minimally disruptive — adding or draining a shard moves
  only ~1/N of the tail keys (each key's winner changes only when the
  NEW shard scores highest for it), never a full reshuffle the way a
  modulo scheme would.
- **Popularity-aware replication**: the catalog order IS the
  popularity rank (the Zipf convention every load shape in this repo
  uses — tools/datasets.zipf_probs). The first ``head`` keys (the
  Zipf head that carries most of the traffic) are placed on EVERY
  shard, so the loss of any one shard never takes down a hot tenant —
  the router fails over to a replica shard instantly. The long tail
  lives on exactly ``tail_replicas`` shards (default 1): the catalog
  scales with the shard count instead of every node holding it.

Pure host-side math — no HTTP, no device; the orchestration lives in
``reconcile.ShardedPool`` and the data path in ``router``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterable, Sequence

__all__ = ["PlacementPlan", "plan_placement", "shard_preference",
           "hrw_score", "move_destination"]


def hrw_score(key: str, shard: str) -> int:
    """Rendezvous weight of ``shard`` for ``key`` — the highest-scoring
    shard owns the key. sha1 (not Python hash()): stable across
    processes and interpreter runs, which the determinism contract
    (and a restarted operator re-deriving the same plan) requires."""
    h = hashlib.sha1(f"{shard}\x00{key}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def shard_preference(key: str, shards: Iterable[str]) -> list[str]:
    """Every shard ordered by rendezvous weight for ``key`` (winner
    first) — the router's failover order for replicated keys."""
    return sorted(shards, key=lambda s: (hrw_score(key, s), s),
                  reverse=True)


@dataclass(frozen=True)
class PlacementPlan:
    """One catalog's placement over one shard set.

    ``assignments`` maps every model key to the tuple of shard ids
    that must hold its artifact, in failover-preference order (HRW
    order; for head keys that is ALL shards). Frozen: a plan is a pure
    function of its inputs — re-derive, never mutate (the ShardedPool
    layers runtime re-placement on top as overrides)."""

    shards: tuple
    assignments: dict
    head_keys: frozenset

    def shards_for(self, key: str) -> tuple:
        return self.assignments[key]

    def keys_for(self, shard: str) -> list:
        """Keys placed on ``shard``, in catalog (popularity) order."""
        return [k for k, s in self.assignments.items() if shard in s]

    def by_shard(self) -> dict:
        return {s: self.keys_for(s) for s in self.shards}

    def tail_keys(self) -> list:
        return [k for k in self.assignments if k not in self.head_keys]


def move_destination(key: str, shards: Iterable[str],
                     exclude: Iterable[str] = (),
                     healthy: dict | None = None) -> str | None:
    """The make-before-break move target for ``key``: the first shard
    in its rendezvous preference order that is not already placed
    (``exclude``) and — when a health map is given — currently serving.
    Deterministic like everything else here, so a restarted controller
    re-derives the same destination for the same fleet state. None
    when every candidate is excluded or down (the move waits)."""
    exclude = set(exclude)
    for sid in shard_preference(key, shards):
        if sid in exclude:
            continue
        if healthy is not None and not healthy.get(sid):
            continue
        return sid
    return None


def plan_placement(keys: Sequence[str], shards: Sequence[str],
                   head: int = 0,
                   tail_replicas: int = 1) -> PlacementPlan:
    """Place ``keys`` (catalog order = popularity rank, hottest first)
    over ``shards``. The first ``head`` keys go on every shard; the
    rest on their top ``tail_replicas`` HRW shards."""
    shards = tuple(shards)
    if not shards:
        raise ValueError("placement needs at least one shard")
    if len(set(shards)) != len(shards):
        raise ValueError(f"duplicate shard ids: {sorted(shards)}")
    if len(set(keys)) != len(keys):
        dup = sorted({k for k in keys if list(keys).count(k) > 1})
        raise ValueError(f"duplicate model keys in the catalog: {dup}")
    head = max(0, int(head))
    tr = min(len(shards), max(1, int(tail_replicas)))
    assignments: dict = {}
    head_keys = []
    for rank, key in enumerate(keys):
        pref = shard_preference(key, shards)
        if rank < head:
            head_keys.append(key)
            assignments[key] = tuple(pref)       # every shard, HRW order
        else:
            assignments[key] = tuple(pref[:tr])
    return PlacementPlan(shards=shards, assignments=assignments,
                         head_keys=frozenset(head_keys))
