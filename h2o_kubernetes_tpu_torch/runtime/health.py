"""Failure detection for the serving node, on a CUDA device.

Detection + fail-fast, no elasticity: once a probe fails or a device
error escapes a locking dispatch, ``healthy()`` flips false and
``require_healthy()`` raises ``ClusterHealthError`` until ``reset()``.
The probe is one small reduction on the device, run under a deadline
in a daemon thread, so a wedged card reports unhealthy instead of
hanging the caller.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["ClusterHealthError", "heartbeat", "healthy", "health_status",
           "require_healthy", "is_device_error", "device_dispatch",
           "mark_unhealthy", "reset"]

_state = {
    "healthy": True,
    "last_beat": None,    # wall time of last successful probe
    "beats": 0,
    "error": "",
}
_lock = threading.Lock()
# the in-flight probe worker: a wedged device must not collect one more
# hung daemon thread per heartbeat() call
_probe_thread: threading.Thread | None = None


class ClusterHealthError(RuntimeError):
    """The device failed its liveness probe (fail-fast)."""


def _probe(device) -> float:
    """One heartbeat: sum a small tensor on the device and read it
    back (the read-back synchronises, so a dead context surfaces)."""
    return float(torch.ones(8, device=device).sum().item())


def heartbeat(device, timeout: float = 60.0) -> bool:
    """Run one liveness probe under a deadline; update health."""
    global _probe_thread
    box: dict = {}

    def run():
        try:
            box["val"] = _probe(device)
        except Exception as e:  # noqa: BLE001 — any device error is fatal
            box["exc"] = e

    with _lock:
        if _probe_thread is not None and _probe_thread.is_alive():
            t = None
        else:
            t = threading.Thread(target=run, name="h2o-torch-probe",
                                 daemon=True)
            _probe_thread = t
            t.start()
    if t is None:
        return healthy()
    t.join(timeout)
    if t.is_alive():
        ok, err = False, f"heartbeat probe hung > {timeout}s"
    elif "exc" in box:
        ok, err = False, f"heartbeat probe failed: {box['exc']!r}"
    elif box["val"] != 8.0:
        ok, err = False, f"heartbeat probe read {box['val']!r}, not 8"
    else:
        ok, err = True, ""
    with _lock:
        if ok:
            # a success does NOT clear a tripped state: recovery is an
            # explicit reset()
            _state["last_beat"] = time.time()
            _state["beats"] += 1
        else:
            _state["healthy"] = False
            _state["error"] = err
    return ok and healthy()


def healthy() -> bool:
    with _lock:
        return bool(_state["healthy"])


def health_status() -> dict:
    with _lock:
        return dict(_state)


def require_healthy() -> None:
    """Fail fast: work on an unhealthy node fails cleanly."""
    with _lock:
        if not _state["healthy"]:
            raise ClusterHealthError(
                f"node unhealthy: {_state['error']} — restart the "
                "serving process")


def is_device_error(e: BaseException) -> bool:
    """True for CUDA runtime failures — the class of exception that
    means the device, not the caller's inputs, is broken: an
    out-of-memory error, or a runtime/accelerator error whose message
    names CUDA."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(e, acc):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


@contextlib.contextmanager
def device_dispatch(desc: str, locking: bool = True):
    """Guard a device dispatch: a device error escaping it re-surfaces
    as ClusterHealthError. ``locking=False`` (the serving paths) feeds
    the circuit breaker without marking the node unhealthy — one bad
    scoring dispatch corrupts no state and must not demand a restart."""
    try:
        yield
    except ClusterHealthError:
        raise
    except Exception as e:
        if not is_device_error(e):
            raise
        if not locking:
            raise ClusterHealthError(
                f"{desc}: device runtime error ({e}) — transient "
                "dispatch failure (circuit breaker territory, node "
                "not locked)") from e
        mark_unhealthy(f"{desc}: {e}")
        raise ClusterHealthError(
            f"{desc}: device runtime error ({e}) — restart the "
            "serving process") from e


def mark_unhealthy(error: str) -> None:
    with _lock:
        _state["healthy"] = False
        _state["error"] = error


def reset() -> None:
    """Clear health state; abandons a still-wedged probe thread."""
    global _probe_thread
    with _lock:
        _state.update(healthy=True, error="", last_beat=None, beats=0)
        _probe_thread = None
