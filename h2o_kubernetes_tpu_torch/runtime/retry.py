"""Retry with backoff for transient faults, and environment-knob
parsing shared by the serving runtime.

``call(fn)`` runs ``fn`` under a fixed policy: 5 attempts, exponential
backoff from 0.2 s with full jitter, capped at 10 s a sleep, a
Retry-After override, and a 120 s wall-clock deadline. ``fn`` raises
``TransientError`` for a retryable outcome (429/5xx, timeout,
connection reset) and anything else for a permanent one, which
propagates on the first attempt. The registry's push
(``operator/registry.py``) runs under it.
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Callable, TypeVar

__all__ = ["_env_float", "TransientError", "call"]

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


class TransientError(IOError):
    """A retryable failure (throttle, 5xx, timeout, connection reset).

    `retry_after`: server-mandated wait in seconds (HTTP Retry-After),
    overriding the backoff schedule for the next sleep when set.
    """

    def __init__(self, msg: str, retry_after: float | None = None):
        super().__init__(msg)
        self.retry_after = retry_after


# the fixed policy: total attempts, first backoff (doubling per
# attempt), per-sleep cap and total wall-clock budget, in seconds
_ATTEMPTS = 5
_BASE = 0.2
_MAX_DELAY = 10.0
_DEADLINE = 120.0


def _backoff(attempt: int) -> float:
    """Sleep before attempt `attempt+1` (attempt is 1-based)."""
    delay = min(_MAX_DELAY, _BASE * (2 ** (attempt - 1)))
    # full jitter in [delay/2, delay]: desynchronizes pushers hammering
    # the same recovering replica
    return delay * (0.5 + 0.5 * random.random())


def call(fn: Callable[[], T], describe: str = "") -> T:
    """Run `fn` under the fixed policy.

    Retries ONLY TransientError; everything else propagates on the
    first attempt (permanent failures must not burn the deadline).
    On exhaustion the last TransientError is re-raised — an IOError
    whose message carries the final failure detail.
    """
    start = time.monotonic()
    last: TransientError | None = None
    for attempt in range(1, _ATTEMPTS + 1):
        try:
            return fn()
        except TransientError as e:
            last = e
            if attempt >= _ATTEMPTS:
                break
            delay = e.retry_after if e.retry_after is not None \
                else _backoff(attempt)
            if time.monotonic() - start + delay > _DEADLINE:
                break
            _log().warning("transient failure (attempt %d/%d, retrying in "
                           "%.2fs): %s", attempt, _ATTEMPTS, delay, e)
            time.sleep(delay)
    _log().warning("retries exhausted after %d attempts: %s",
                   _ATTEMPTS, describe or last)
    assert last is not None
    raise last
