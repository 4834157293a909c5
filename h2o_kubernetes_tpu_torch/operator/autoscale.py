"""Horizontal autoscale signal from per-replica serving stats.

The inputs are exactly what ``GET /3/Stats`` exposes per replica (the
overload-control counters): the
admission queue's instantaneous depth, the cumulative load-shed (429)
count, and the deadline-expired (504) count. The policy is
deliberately simple and hysteresis-free at this layer — one step up
on pressure, one step down on proven idleness, clamped to the spec's
[min_replicas, max_replicas] — because the caller (the reconcile
loop) controls the cadence and can add cooldowns without changing the
signal.

Pressure (scale UP by 1) — any of:
- mean queue depth across replicas >= ``H2O_TPU_POOL_QUEUE_HIGH``
  (queued work means latency is already batch-window x depth);
- any load was shed since the previous scrape (a 429 is the queue
  saying "full" — more replicas is the only fix the operator owns);
- any request 504'd on its deadline since the previous scrape.

Idleness (scale DOWN by 1) — all of, since the previous scrape:
- every replica's queue depth is 0,
- zero shed and zero deadline 504s,
- zero new scoring requests (a pool serving ANY traffic holds its
  size — scale-down only reclaims truly idle replicas),
- and no counter went BACKWARDS since the last scrape: a negative
  delta means a replica restart or rolling update zeroed the
  cumulative counters, which is indistinguishable from idleness by
  delta alone — the pool holds for one scrape instead of shrinking
  under live traffic.
"""

from __future__ import annotations

from ..runtime.retry import _env_float
from .spec import ScorerPoolSpec

__all__ = ["desired_replicas", "pressure_by_model"]


def pressure_by_model(samples: list[dict],
                      model_keys: "set | None" = None) -> dict:
    """Cumulative shed + deadline-504 count PER TENANT across replicas
    (/3/Stats ``models``) — the hot-shard rebalance attribution
    signal: the same per-model counters the shard-aware autoscale
    reads, but kept per key so the controller can name WHICH tenant's
    pressure is sustained and move that one, not guess. ``model_keys``
    restricts to the shard's own placed tenants."""
    out: dict = {}
    for s in samples:
        for key, m in (s.get("models") or {}).items():
            if model_keys is not None and key not in model_keys:
                continue
            out[key] = out.get(key, 0) \
                + int(m.get("shed") or 0) \
                + int(m.get("deadline_504") or 0)
    return out


def _totals(samples: list[dict],
            model_keys: "set | None" = None) -> dict:
    """Pressure counters summed across replicas. ``model_keys``
    restricts the cumulative counters to THOSE tenants' per-model
    stats (/3/Stats ``models``) — the shard-aware signal: a sharded
    pool must scale the shard whose own tenants shed, and a re-placed
    tenant's burst must pull up the shard actually serving it, not
    every shard that happens to share a process-global counter."""
    t = {"shed": 0, "deadline_504": 0, "requests": 0}
    for s in samples:
        if model_keys is None:
            b = s.get("batcher") or {}
            c = s.get("counters") or {}
            t["shed"] += int(b.get("shed") or 0)
            t["deadline_504"] += int(c.get("deadline_504") or 0)
            t["requests"] += int(b.get("requests") or 0)
        else:
            for key, m in (s.get("models") or {}).items():
                if key not in model_keys:
                    continue
                t["shed"] += int(m.get("shed") or 0)
                t["deadline_504"] += int(m.get("deadline_504") or 0)
                t["requests"] += int(m.get("requests") or 0)
    return t


def desired_replicas(spec: ScorerPoolSpec, samples: list[dict],
                     prev_totals: dict | None = None,
                     model_keys: "set | None" = None
                     ) -> tuple[int, str, dict]:
    """(desired, reason, totals). ``samples`` are /3/Stats dicts from
    the READY replicas; pass the returned ``totals`` back as
    ``prev_totals`` next scrape so cumulative counters become rates.
    ``model_keys`` (a sharded pool's placed tenant set) attributes the
    cumulative pressure counters to the shard's own tenants. With no
    samples (pool still converging) the signal holds."""
    n = spec.replicas
    totals = _totals(samples, model_keys)
    if not samples:
        return n, "no ready replicas to scrape", totals
    lo, hi = spec.min_replicas, spec.max_replicas
    depths = [int((s.get("batcher") or {}).get("queue_depth") or 0)
              for s in samples]
    queue_high = max(1.0, _env_float("H2O_TPU_POOL_QUEUE_HIGH", 8.0))
    mean_depth = sum(depths) / len(depths)

    shed_d = d504_d = req_d = None
    reset = False
    if prev_totals is not None:
        shed_d = totals["shed"] - prev_totals.get("shed", 0)
        d504_d = totals["deadline_504"] \
            - prev_totals.get("deadline_504", 0)
        req_d = totals["requests"] - prev_totals.get("requests", 0)
        # a counter going BACKWARDS means a replica restarted (or a
        # rolling update swapped the fleet) since the last scrape —
        # the deltas say nothing about load this window. Pressure
        # signals still fire from the instantaneous queue depth, but
        # the idle scale-down must HOLD: zeroed counters on a fresh
        # fleet are indistinguishable from idleness by delta alone.
        reset = shed_d < 0 or d504_d < 0 or req_d < 0
        shed_d, d504_d, req_d = (max(0, shed_d), max(0, d504_d),
                                 max(0, req_d))

    if mean_depth >= queue_high:
        return (min(n + 1, hi),
                f"mean queue depth {mean_depth:.1f} >= "
                f"{queue_high:g}", totals)
    if shed_d:
        return min(n + 1, hi), f"{shed_d} requests shed (429)", totals
    if d504_d:
        return (min(n + 1, hi),
                f"{d504_d} deadline expiries (504)", totals)
    if (prev_totals is not None and not reset
            and max(depths, default=0) == 0
            and shed_d == 0 and d504_d == 0 and req_d == 0):
        return max(n - 1, lo), "pool idle since last scrape", totals
    if reset:
        return n, "counters reset (replica restart) — holding", totals
    return n, "holding", totals
