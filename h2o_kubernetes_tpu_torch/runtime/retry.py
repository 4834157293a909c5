"""Retry with backoff for transient faults, the token bucket of the
per-key admission budgets, and environment-knob parsing shared by the
serving runtime.

``call(fn, policy)`` runs ``fn`` under a ``RetryPolicy``: exponential
backoff with full jitter, a per-sleep cap, a Retry-After override, an
attempt cap, a wall-clock deadline and an optional hard cap on the
elapsed time. ``fn`` raises ``TransientError`` for a retryable outcome
(429/5xx, timeout, connection reset) and anything else for a permanent
one, which propagates on the first attempt. The registry's push
(``operator/registry.py``) runs under it.

Env knobs (read per call, so a live process can be re-tuned):

- ``H2O_TPU_RETRY_ATTEMPTS``   total attempts, default 5
- ``H2O_TPU_RETRY_BASE``       first backoff in seconds, default 0.2
- ``H2O_TPU_RETRY_MAX_DELAY``  per-sleep cap in seconds, default 10
- ``H2O_TPU_RETRY_DEADLINE``   total budget in seconds, default 120
- ``H2O_TPU_RETRY_MAX_ELAPSED_S``  hard cap on the total elapsed time,
  attempts included (the deadline only looks ahead at sleeps), default
  0 = off
- ``H2O_TPU_RETRY_DISABLE=1``  a single attempt, no sleeps

While the node is DRAINING (``runtime/lifecycle.py``) no retry sleep
may outlive the drain deadline: ``call`` gives up with the last
TransientError instead of holding the drain open.
"""

from __future__ import annotations

import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, TypeVar

__all__ = ["_env_float", "RetryPolicy", "TransientError", "policy_from_env",
           "call", "bucket_take"]

T = TypeVar("T")


def _log() -> logging.Logger:
    return logging.getLogger("h2o_kubernetes_tpu_torch")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _log().warning("ignoring unparseable %s=%r", name, raw)
        return default


def bucket_take(buckets: dict, key: str, rate: float, now: float,
                burst: float | None = None) -> float:
    """The token-bucket step of every per-key admission budget (the
    per-tenant rate limit in ``rest.py``): take one token from
    ``buckets[key]`` (created at full burst on first touch), refilled
    continuously at ``rate``/s and capped at ``burst`` (default one
    second of traffic, at least 1).

    Returns 0.0 on success, else the seconds until a token accrues (the
    Retry-After to advertise). The caller owns locking and the clock.
    Mutates ``buckets[key] = [tokens, last]`` in place."""
    burst = max(1.0, rate) if burst is None else burst
    b = buckets.get(key)
    if b is None:
        b = buckets[key] = [burst, now]
    tokens = min(burst, b[0] + (now - b[1]) * rate)
    if tokens < 1.0:
        b[0], b[1] = tokens, now
        return (1.0 - tokens) / rate
    b[0], b[1] = tokens - 1.0, now
    return 0.0


class TransientError(IOError):
    """A retryable failure (throttle, 5xx, timeout, connection reset).

    `retry_after`: server-mandated wait in seconds (HTTP Retry-After),
    overriding the backoff schedule for the next sleep when set.
    """

    def __init__(self, msg: str, retry_after: float | None = None):
        super().__init__(msg)
        self.retry_after = retry_after


@dataclass(frozen=True)
class RetryPolicy:
    attempts: int = 5
    base: float = 0.2           # first backoff; doubles per attempt
    max_delay: float = 10.0     # per-sleep cap
    deadline: float = 120.0     # total wall-clock budget (0 = none)
    max_elapsed: float = 0.0    # hard elapsed-time cap incl. attempts
    jitter: bool = True         # (0 = off)

    def backoff(self, attempt: int, rng=random.random) -> float:
        """Sleep before attempt `attempt+1` (attempt is 1-based)."""
        delay = min(self.max_delay, self.base * (2 ** (attempt - 1)))
        if self.jitter:
            # full jitter in [delay/2, delay]: desynchronizes pushers
            # hammering the same recovering replica
            delay *= 0.5 + 0.5 * rng()
        return delay


def policy_from_env(**overrides) -> RetryPolicy:
    """The active policy from H2O_TPU_RETRY_* (see the module doc)."""
    if os.environ.get("H2O_TPU_RETRY_DISABLE", "") not in ("", "0"):
        return RetryPolicy(attempts=1, **{k: v for k, v in
                                          overrides.items()
                                          if k != "attempts"})
    kw = dict(
        attempts=int(_env_float("H2O_TPU_RETRY_ATTEMPTS", 5)),
        base=_env_float("H2O_TPU_RETRY_BASE", 0.2),
        max_delay=_env_float("H2O_TPU_RETRY_MAX_DELAY", 10.0),
        deadline=_env_float("H2O_TPU_RETRY_DEADLINE", 120.0),
        max_elapsed=_env_float("H2O_TPU_RETRY_MAX_ELAPSED_S", 0.0),
    )
    kw.update(overrides)
    return RetryPolicy(**kw)


def call(fn: Callable[[], T], policy: RetryPolicy | None = None,
         describe: str = "", sleep: Callable[[float], None] = time.sleep,
         ) -> T:
    """Run `fn` under the retry policy (``policy_from_env()`` when None).

    Retries ONLY TransientError; everything else propagates on the
    first attempt (permanent failures must not burn the deadline).
    On exhaustion the last TransientError is re-raised — an IOError
    whose message carries the final failure detail.
    """
    from ..diagnostics import timeline

    policy = policy or policy_from_env()
    start = time.monotonic()
    last: TransientError | None = None
    for attempt in range(1, max(1, policy.attempts) + 1):
        try:
            return fn()
        except TransientError as e:
            last = e
            if attempt >= policy.attempts:
                break
            elapsed = time.monotonic() - start
            if policy.max_elapsed and elapsed >= policy.max_elapsed:
                break    # the attempts themselves burned the budget
            delay = e.retry_after if e.retry_after is not None \
                else policy.backoff(attempt)
            if policy.deadline and elapsed + delay > policy.deadline:
                break
            if policy.max_elapsed and \
                    elapsed + delay > policy.max_elapsed:
                break
            # a DRAINING node's retries die inside the drain window
            from .lifecycle import remaining_drain_budget

            rem = remaining_drain_budget()
            if rem is not None and delay >= rem:
                break
            timeline.record("retry", describe or str(e),
                            attempt=attempt, delay=round(delay, 3))
            _log().warning("transient failure (attempt %d/%d, retrying in "
                           "%.2fs): %s", attempt, policy.attempts, delay, e)
            sleep(delay)
    timeline.record("retry_exhausted", describe or str(last),
                    attempts=policy.attempts)
    assert last is not None
    raise last
