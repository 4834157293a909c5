"""Operator-provisioned scorer fleets: the layer above the pod.

The JAX package's operator, on the port's pods. The replica (``rest.py``
with the registry readiness gate, the byte-budgeted device state and the
TreeSHAP kernel on the card) becomes a fleet:

- ``spec``      — the ``H2OScorerPool`` spec model and a dict-backed
  in-process "API server" (``PoolStore``): spec generations, status and
  a bounded event log.
- ``registry``  — versioned MOJO-v2 artifacts on a persist root, pushed
  to replicas over ``POST /3/ModelRegistry/load``; the replica's
  ``FlatTreeScorer``.
- ``reconcile`` — the level-triggered reconcile loop over real
  subprocess pods: replica death, resize, surge-one rolling updates
  with warm-up-gated readiness, crash-loop backoff and rollback,
  adoption of live pods after a controller restart, and
  ``ShardedPool`` (one child reconciler per shard, re-placement of a
  lost shard's tenants, lease fencing, rebalance and failback).
- ``autoscale`` — the horizontal scale signal from each replica's
  queue depth, shed and deadline counters on ``GET /3/Stats``.
- ``pod``       — the replica entry point
  (``python -m h2o_kubernetes_tpu_torch.operator.pod --port N
  [--device cpu]``).
- ``store``     — ``DurablePoolStore``: specs, status, events, the
  routing table and the controller lease on a persist root, so the
  control plane survives its process.
- ``run``       — the operator process
  (``python -m h2o_kubernetes_tpu_torch.operator.run``), with ``--ha``.
- ``placement`` — rendezvous-hash tenant placement with the popular
  head replicated on every shard; pure, and equal to the JAX package's.
- ``router``    — the device-free front-door router: health-swept
  failover, per-tenant retry budgets, optional hedging, the typed
  ``placement_pending`` 503; ``python -m
  h2o_kubernetes_tpu_torch.operator.router --store ROOT --pool NAME``.
- ``probe``     — the replica scrape helper shared by the reconciler and
  the router.

Pods serve on the CUDA card unless the controller is given
``device="cpu"``; ``tools/torch_chaos.py`` drills the fleet.
"""

from .placement import (PlacementPlan, move_destination,
                        plan_placement, shard_preference)
from .registry import FlatTreeScorer, ModelRegistry, load_artifact
from .reconcile import (AdoptedReplica, Reconciler, ScorerReplica,
                        ShardedPool)
from .router import ScoringRouter, StoreRoutingTable, start_router
from .spec import PoolStore, ScorerPoolSpec, StaleGenerationError
from .store import DurablePoolStore

__all__ = ["ScorerPoolSpec", "PoolStore", "DurablePoolStore",
           "StaleGenerationError", "ModelRegistry", "FlatTreeScorer",
           "load_artifact", "Reconciler", "ScorerReplica",
           "AdoptedReplica", "ShardedPool", "PlacementPlan",
           "plan_placement", "shard_preference", "move_destination",
           "ScoringRouter", "StoreRoutingTable", "start_router"]
