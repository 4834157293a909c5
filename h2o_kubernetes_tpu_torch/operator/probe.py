"""Shared replica scrape helper: probe timeout + retry-before-unhealthy.

THE one way the control plane (reconciler adoption/autoscale scrapes)
and the data-plane router read a replica's ``/readyz`` / ``/3/Stats``:

- every attempt is capped by ``H2O_TPU_POOL_PROBE_TIMEOUT`` (so
  one hung replica must not stall a reconcile pass or a router health
  sweep), and
- a replica is classified unreachable only after ``retries``
  consecutive failed attempts (default 3) in ONE call: a GIL-bound
  scoring burst that makes a replica miss a single scrape must not
  flap it out of the router's ring or make an adopting operator kill
  a healthy pod. A dead replica (connection refused) fails all three
  attempts in milliseconds, so failover detection stays fast.

Returns the parsed JSON, or None when every attempt failed.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

from ..runtime.retry import _env_float

__all__ = ["probe_json", "probe_timeout"]


def probe_timeout() -> float:
    """Per-attempt cap on every replica scrape (floored at 0.1 so a
    typo'd knob can never make probes hang-proof-less)."""
    return max(0.1, _env_float("H2O_TPU_POOL_PROBE_TIMEOUT", 2.0))


def probe_json(url: str, path: str = "/3/Stats", retries: int = 3,
               timeout: float | None = None,
               retry_sleep: float = 0.15):
    """GET ``url + path`` and parse JSON, retrying transient failures.

    HTTP error responses that still carry JSON (a 503 from /readyz
    with its reasons) are RETURNED, not retried — "unready" is an
    answer, only "unreachable" gets the retry treatment."""
    t = probe_timeout() if timeout is None else timeout
    for attempt in range(max(1, int(retries))):
        try:
            with urllib.request.urlopen(url.rstrip("/") + path,
                                        timeout=t) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())
            except Exception:  # noqa: BLE001 — non-JSON error body
                return None
        except Exception:  # noqa: BLE001 — refused/reset/timeout
            if attempt + 1 < retries:
                time.sleep(retry_sleep)
    return None
