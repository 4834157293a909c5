"""Node lifecycle + circuit breaking — the serving envelope.

- a **lifecycle state machine** — STARTING → SERVING → DRAINING →
  TERMINATED — with a SIGTERM drain path: stop admitting new work, let
  the REST micro-batcher flush its in-flight scoring requests, wait for
  RUNNING jobs up to ``H2O_TPU_DRAIN_TIMEOUT`` seconds (then fail them
  cleanly), join the heartbeat thread, run registered shutdown hooks
  (the REST server), and only then terminate.
- a **cordon** (``cordon``/``uncordon``/``cordoned``): readiness off
  while admission stays open, so routers drop the replica and requests
  already routed to it still score (the rolling-update step before a
  drain).
- a **circuit breaker** (closed / open / half-open) over device
  dispatch: ``H2O_TPU_BREAKER_FAILURES`` *consecutive* device-dispatch
  errors trip it open; while open every guarded dispatch is rejected
  instantly with ``CircuitOpenError`` (a ``ClusterHealthError``, so the
  REST layer 503s) without touching the device; after
  ``H2O_TPU_BREAKER_COOLDOWN`` seconds the next call is admitted as the
  half-open probe — success closes the breaker, failure re-opens it
  with a fresh cooldown.

Readiness (rest.py ``/readyz``) is the conjunction: state == SERVING
∧ breaker not open ∧ node healthy ∧ not cordoned (∧ rest.py's
readiness gates). Liveness (``/healthz``) stays true through DRAINING
so the kubelet does not kill a draining pod early.

Fault points: ``lifecycle.drain`` fires at drain entry (kinds ``hang``
and ``error``: a slow or failing drain step never leaves the node
undrained); ``score.dispatch`` (``models/base.py``) feeds the breaker
through kind ``dispatch_error``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import Callable, Iterator

from .health import ClusterHealthError
from .retry import _env_float

__all__ = [
    "STARTING", "SERVING", "DRAINING", "TERMINATED",
    "CircuitBreaker", "CircuitOpenError", "NodeDrainingError", "BREAKER",
    "breaker_guard", "state", "accepting", "mark_serving", "begin_drain",
    "drain", "install_sigterm", "remaining_drain_budget", "status",
    "register_shutdown", "terminated", "wait_terminated", "reset",
    "cordon", "uncordon", "cordoned",
]

log = logging.getLogger("h2o_kubernetes_tpu_torch")

STARTING = "STARTING"
SERVING = "SERVING"
DRAINING = "DRAINING"
TERMINATED = "TERMINATED"


class CircuitOpenError(ClusterHealthError):
    """The dispatch circuit breaker is open — the device is being given
    its cooldown, not another doomed dispatch."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class NodeDrainingError(ClusterHealthError):
    """New work refused because the node is DRAINING/TERMINATED."""


class CircuitBreaker:
    """Closed / open / half-open breaker over device dispatch.

    ``check()`` is the non-claiming admission test (queue front doors);
    ``allow()`` is the claiming one (the dispatch itself) — only
    ``allow()`` may take the half-open probe slot.
    """

    def __init__(self, name: str = "device-dispatch"):
        self.name = name
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self.stats = {"trips": 0, "short_circuited": 0, "probes": 0,
                      "closes": 0, "failures": 0}

    @staticmethod
    def _threshold() -> int:
        return max(1, int(_env_float("H2O_TPU_BREAKER_FAILURES", 5.0)))

    @staticmethod
    def _cooldown() -> float:
        return max(0.0, _env_float("H2O_TPU_BREAKER_COOLDOWN", 30.0))

    def _effective_locked(self) -> str:
        if self._state == "open" and not self._probing and \
                time.monotonic() - self._opened_at >= self._cooldown():
            return "half-open"
        return self._state

    def state(self) -> str:
        with self._lock:
            return self._effective_locked()

    def status(self) -> dict:
        with self._lock:
            st = self._effective_locked()
            rem = 0.0
            if st == "open":
                rem = max(0.0, self._cooldown()
                          - (time.monotonic() - self._opened_at))
            return {"state": st, "consecutive_failures": self._consecutive,
                    "cooldown_remaining_s": round(rem, 3), **self.stats}

    def reset(self) -> None:
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._probing = False

    def release_probe(self) -> None:
        """Free a claimed half-open probe slot without recording an
        outcome (the dispatch died for non-device reasons)."""
        with self._lock:
            if self._probing:
                self._state = "open"
                self._probing = False

    def _reject_locked(self) -> CircuitOpenError:
        self.stats["short_circuited"] += 1
        rem = max(0.0, self._cooldown()
                  - (time.monotonic() - self._opened_at))
        return CircuitOpenError(
            f"{self.name} circuit breaker is open "
            f"({self._consecutive} consecutive dispatch failures); "
            f"retry in {max(rem, 0.1):.1f}s",
            retry_after=max(rem, 0.1))

    def check(self) -> None:
        """Raise CircuitOpenError while firmly open; never claims the
        half-open probe slot."""
        with self._lock:
            if self._effective_locked() == "open":
                raise self._reject_locked()

    def allow(self) -> None:
        """Admission for one dispatch: passes when closed, claims THE
        half-open probe when the cooldown has elapsed, raises
        CircuitOpenError otherwise."""
        with self._lock:
            st = self._effective_locked()
            if st == "closed":
                return
            if st == "half-open" and not self._probing:
                self._state = "half-open"
                self._probing = True
                self.stats["probes"] += 1
                return
            raise self._reject_locked()

    def record_success(self) -> None:
        closed_now = False
        with self._lock:
            if self._state != "closed":
                closed_now = True
                self.stats["closes"] += 1
            self._state = "closed"
            self._consecutive = 0
            self._probing = False
        if closed_now:
            log.warning("circuit breaker %s: half-open probe succeeded "
                        "— closed", self.name)

    def record_failure(self, err: str = "") -> None:
        tripped = False
        with self._lock:
            self._consecutive += 1
            self.stats["failures"] += 1
            if self._state in ("open", "half-open"):
                self._state = "open"
                self._opened_at = time.monotonic()
                self._probing = False
            elif self._consecutive >= self._threshold():
                self._state = "open"
                self._opened_at = time.monotonic()
                self.stats["trips"] += 1
                tripped = True
        if tripped:
            log.error("circuit breaker %s: OPEN after %d consecutive "
                      "dispatch failures (last: %s)", self.name,
                      self._consecutive, err[:200])


BREAKER = CircuitBreaker()


@contextlib.contextmanager
def breaker_guard(desc: str = "device dispatch") -> Iterator[None]:
    """Run one device dispatch under the breaker. Only device-shaped
    failures (ClusterHealthError, CUDA runtime errors) count against
    it; a caller's bad inputs pass through untallied."""
    from .health import is_device_error

    BREAKER.allow()
    try:
        yield
    except BaseException as e:
        if isinstance(e, CircuitOpenError):
            raise
        if isinstance(e, ClusterHealthError) or is_device_error(e):
            BREAKER.record_failure(repr(e))
        else:
            BREAKER.release_probe()
        raise
    else:
        BREAKER.record_success()


class _Lifecycle:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = STARTING
        self._drain_deadline: float | None = None
        self._drain_thread: threading.Thread | None = None
        self._terminated = threading.Event()
        self._callbacks: list[Callable[[], None]] = []
        self._exit_on_drain = False
        self._exit_code = 0
        self._installed = False
        # bumped by reset(): a drain still in flight from the previous
        # epoch abandons instead of clobbering the restarted node
        self._epoch = 0
        # cordon = endpoint removal WITHOUT draining: /readyz goes 503
        # while admission stays open
        self._cordoned: str | None = None

    def state(self) -> str:
        with self._lock:
            return self._state

    def accepting(self) -> bool:
        """True while new work may be admitted (STARTING covers
        library-only use that never calls mark_serving)."""
        with self._lock:
            return self._state in (STARTING, SERVING)

    def remaining_drain_budget(self) -> float | None:
        with self._lock:
            if self._state == TERMINATED:
                return 0.0
            if self._state != DRAINING or self._drain_deadline is None:
                return None
            return max(0.0, self._drain_deadline - time.monotonic())

    def mark_serving(self) -> None:
        with self._lock:
            if self._state == STARTING:
                self._state = SERVING

    def cordon(self, reason: str = "operator") -> None:
        """Readiness off WITHOUT refusing work: the operator cordons a
        replica, waits for the routers to drop it, then drains it."""
        with self._lock:
            self._cordoned = reason or "cordoned"
        from ..diagnostics import timeline

        timeline.record("cordon", reason)
        log.warning("lifecycle: cordoned (%s) — readiness off, "
                    "admission still open", reason)

    def uncordon(self) -> None:
        with self._lock:
            self._cordoned = None

    def cordoned(self) -> str | None:
        with self._lock:
            return self._cordoned

    def register_shutdown(self, cb: Callable[[], None]) -> None:
        """Hook run at the END of the drain; idempotent by identity."""
        with self._lock:
            if cb not in self._callbacks:
                self._callbacks.append(cb)

    def begin_drain(self, reason: str = "",
                    timeout: float | None = None) -> threading.Thread:
        """SERVING/STARTING → DRAINING; returns the (daemon) drain
        thread. Idempotent within an epoch."""
        if timeout is None:
            timeout = _env_float("H2O_TPU_DRAIN_TIMEOUT", 30.0)
        with self._lock:
            if self._state in (DRAINING, TERMINATED):
                return self._drain_thread
            self._state = DRAINING
            self._drain_deadline = time.monotonic() + max(0.0, timeout)
            t = threading.Thread(target=self._drain,
                                 args=(reason, timeout, self._epoch,
                                       self._terminated),
                                 name="h2o-torch-drain", daemon=True)
            self._drain_thread = t
        log.warning("lifecycle: DRAINING (%s)", reason or "requested")
        t.start()
        return t

    def _stale(self, epoch: int, reason: str) -> bool:
        """True when reset() started a new epoch while this drain was
        in flight: the drain abandons instead of touching the new
        node."""
        with self._lock:
            stale = self._epoch != epoch
        if stale:
            log.warning("lifecycle: drain (%s) abandoned — reset() "
                        "started a new epoch mid-drain", reason)
        return stale

    def _drain(self, reason: str, timeout: float, epoch: int,
               term_event: threading.Event) -> None:
        from ..diagnostics import timeline
        from . import faults

        with self._lock:
            deadline = self._drain_deadline
        try:
            faults.fire("lifecycle.drain")
        except Exception as e:  # noqa: BLE001 — an injected drain fault
            # is logged; it never leaves the node undrained
            log.error("lifecycle.drain fault during drain: %r", e)
        # 1. flush the scoring micro-batcher: in-flight waiters get
        # their terminal responses; new submits are already refused
        try:
            from .. import rest

            rest.BATCHER.stop(timeout=max(0.0, deadline - time.monotonic()))
        except Exception as e:  # noqa: BLE001
            log.error("drain: batcher flush failed: %r", e)
        if self._stale(epoch, reason):
            return
        # 2. wait for RUNNING jobs, then fail the stragglers cleanly
        try:
            from ..automl import JOBS

            while time.monotonic() < deadline:
                if not any(j.status == "RUNNING" for j in JOBS.values()):
                    break
                time.sleep(0.05)
            for j in list(JOBS.values()):
                if j.status == "RUNNING":
                    j.failed(
                        "node draining: job still RUNNING at the drain "
                        f"deadline (H2O_TPU_DRAIN_TIMEOUT={timeout:g}s)"
                        + (f"; reason: {reason}" if reason else ""))
        except Exception as e:  # noqa: BLE001
            log.error("drain: job settlement failed: %r", e)
        if self._stale(epoch, reason):
            return
        # 3. stop + join the heartbeat thread
        try:
            from . import health

            health.stop_heartbeat(join=True, timeout=5.0)
        except Exception as e:  # noqa: BLE001
            log.error("drain: heartbeat stop failed: %r", e)
        # 4. shutdown hooks (REST server stops accepting connections)
        with self._lock:
            cbs = list(self._callbacks) if self._epoch == epoch else None
        if cbs is None:
            self._stale(epoch, reason)
            return
        for cb in cbs:
            try:
                cb()
            except Exception as e:  # noqa: BLE001
                log.error("drain: shutdown hook %r failed: %r", cb, e)
        with self._lock:
            if self._epoch != epoch:
                return
            self._state = TERMINATED
            exit_on_drain = self._exit_on_drain
            exit_code = self._exit_code
        timeline.record("drain_complete", reason)
        log.warning("lifecycle: TERMINATED (drain complete)")
        term_event.set()
        if exit_on_drain:
            os._exit(exit_code)

    def install_sigterm(self, exit_on_drain: bool = True,
                        exit_code: int = 0) -> bool:
        """Install the SIGTERM → drain handler (main thread only;
        returns False when it cannot install)."""
        self._exit_on_drain = exit_on_drain
        self._exit_code = exit_code
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        prev = signal.getsignal(signal.SIGTERM)
        trigger = threading.Event()

        def waiter():
            while True:
                trigger.wait()
                trigger.clear()
                self.begin_drain(reason="SIGTERM")

        threading.Thread(target=waiter, name="h2o-torch-sigterm-drain",
                         daemon=True).start()

        def handler(signum, frame):
            # only set a flag: begin_drain takes the (non-reentrant)
            # lifecycle lock, which the main thread may be holding
            trigger.set()
            if callable(prev):
                try:
                    prev(signum, frame)
                except BaseException:  # noqa: BLE001
                    pass

        signal.signal(signal.SIGTERM, handler)
        self._installed = True
        return True

    def reset(self) -> None:
        """Back to STARTING (tests / in-process restart)."""
        with self._lock:
            self._epoch += 1
            self._state = STARTING
            self._drain_deadline = None
            self._drain_thread = None
            self._callbacks.clear()
            self._exit_on_drain = False
            self._cordoned = None
            self._terminated = threading.Event()
        BREAKER.reset()


LIFECYCLE = _Lifecycle()


def state() -> str:
    return LIFECYCLE.state()


def accepting() -> bool:
    return LIFECYCLE.accepting()


def mark_serving() -> None:
    LIFECYCLE.mark_serving()


def begin_drain(reason: str = "",
                timeout: float | None = None) -> threading.Thread:
    return LIFECYCLE.begin_drain(reason=reason, timeout=timeout)


def drain(reason: str = "", timeout: float | None = None) -> None:
    """Synchronous drain."""
    t = LIFECYCLE.begin_drain(reason=reason, timeout=timeout)
    if t is not None:
        t.join()


def install_sigterm(exit_on_drain: bool = True, exit_code: int = 0) -> bool:
    return LIFECYCLE.install_sigterm(exit_on_drain=exit_on_drain,
                                     exit_code=exit_code)


def remaining_drain_budget() -> float | None:
    return LIFECYCLE.remaining_drain_budget()


def register_shutdown(cb: Callable[[], None]) -> None:
    LIFECYCLE.register_shutdown(cb)


def terminated() -> bool:
    return LIFECYCLE._terminated.is_set()


def wait_terminated(timeout: float | None = None) -> bool:
    return LIFECYCLE._terminated.wait(timeout)


def reset() -> None:
    LIFECYCLE.reset()


def cordon(reason: str = "operator") -> None:
    LIFECYCLE.cordon(reason)


def uncordon() -> None:
    LIFECYCLE.uncordon()


def cordoned() -> str | None:
    return LIFECYCLE.cordoned()


def status() -> dict:
    """One JSON-able snapshot for /healthz and operators."""
    from . import health

    return {"state": LIFECYCLE.state(),
            "healthy": health.healthy(),
            "breaker": BREAKER.status(),
            "cordoned": LIFECYCLE.cordoned(),
            "drain_budget_s": LIFECYCLE.remaining_drain_budget()}


# node state + breaker as a telemetry stat group: GET /metrics flattens
# it (trip counters, consecutive failures, the state as an info sample)
from .telemetry import register_group as _register_tel_group  # noqa: E402

_register_tel_group("lifecycle", status)
