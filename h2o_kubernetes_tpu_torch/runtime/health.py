"""Failure detection for the serving node, on a CUDA device.

Detection + fail-fast, no elasticity: once a probe fails or a device
error escapes a locking dispatch, ``healthy()`` flips false and
``require_healthy()`` raises ``ClusterHealthError`` until ``reset()``.
The probe is one small reduction on the device, run under a deadline
in a daemon thread, so a wedged card reports unhealthy instead of
hanging the caller; on a row group (``runtime/mesh.py``) it is one
all-reduce of a scalar across the ranks, so a rank that died makes the
survivors' probe fail (the transport breaks) or outlive its deadline; ``start_heartbeat`` runs it every ``interval``
seconds on a background thread (``h2o-torch-heartbeat``) until
``stop_heartbeat``, which the drain path calls with ``join=True``.

Fault points (``runtime/faults.py``): ``health.probe`` fires inside
each probe; ``train.step`` fires in ``require_healthy()`` (callers
outside training pass ``fault_site=None``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["ClusterHealthError", "heartbeat", "healthy", "health_status",
           "require_healthy", "is_device_error", "device_dispatch",
           "mark_unhealthy", "reset", "start_heartbeat", "stop_heartbeat"]

_state = {
    "healthy": True,
    "last_beat": None,    # wall time of last successful probe
    "beats": 0,
    "error": "",
}
_lock = threading.Lock()
_thread: threading.Thread | None = None       # the heartbeat loop
_stop = threading.Event()
# the in-flight probe worker: a wedged device must not collect one more
# hung daemon thread per heartbeat() call
_probe_thread: threading.Thread | None = None


class ClusterHealthError(RuntimeError):
    """The device failed its liveness probe (fail-fast)."""


def _probe(device) -> float:
    """One heartbeat: sum a small tensor on the device and read it
    back (the read-back synchronises, so a dead context surfaces); on
    a row group, all-reduce that sum across the ranks (8 per rank)."""
    import torch.distributed as dist

    from . import faults
    from .mesh import global_mesh

    faults.fire("health.probe")   # rehearse hangs/errors without a card
    s = torch.ones(8, device=device).sum()
    g = global_mesh()
    if g.world_size > 1:
        s = s.reshape(1).to("cpu" if g.backend == "gloo" else device)
        dist.all_reduce(s, group=g.pg)
    return float(s.sum().item())


def heartbeat(device=None, timeout: float = 60.0) -> bool:
    """Run one liveness probe under a deadline; update health.
    ``device``: the device probed (None: the row group's, else the
    card)."""
    global _probe_thread
    from .backend import resolve_device
    from .mesh import global_mesh

    g = global_mesh()
    if device is None:
        device = g.device if g.device is not None else resolve_device()
    expect = 8.0 * g.world_size
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
    elif box["val"] != expect:
        ok, err = False, (f"heartbeat probe read {box['val']!r}, not "
                          f"{expect:g}")
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


def require_healthy(fault_site: str | None = "train.step") -> None:
    """Fail fast: work on an unhealthy node fails cleanly.

    Training entries call it with the default, which makes it the
    ``train.step`` fault point: an armed ``device_error`` flips health
    and raises here. Scoring callers pass ``fault_site=None``, so an
    armed train.step fault is never consumed by a request."""
    from . import faults

    if fault_site:
        faults.fire(fault_site)
    with _lock:
        if not _state["healthy"]:
            raise ClusterHealthError(
                f"node unhealthy: {_state['error']} — restart the "
                "serving process")


def is_device_error(e: BaseException) -> bool:
    """True for CUDA runtime failures — the class of exception that
    means the device, not the caller's inputs, is broken: an
    out-of-memory error, or a runtime/accelerator error whose message
    names CUDA; or the fault harness's ``InjectedDeviceError``."""
    from .faults import InjectedDeviceError

    if isinstance(e, (torch.cuda.OutOfMemoryError, InjectedDeviceError)):
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
    scoring dispatch corrupts no state and must not demand a restart.
    An injected ``device_error`` has already marked the node unhealthy;
    an injected ``dispatch_error`` has not, and stays a breaker matter."""
    from .faults import InjectedDeviceError

    try:
        yield
    except ClusterHealthError:
        raise
    except InjectedDeviceError as e:
        if healthy():
            raise ClusterHealthError(
                f"{desc}: {e} — transient dispatch failure (circuit "
                "breaker territory, node not locked)") from e
        raise ClusterHealthError(
            f"{desc}: {e} — restart the serving process") from e
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


def start_heartbeat(interval: float = 30.0, timeout: float = 60.0,
                    device=None) -> None:
    """Background heartbeat loop on ``device`` (None = the card): one
    probe every ``interval`` seconds. Idempotent while it runs."""
    global _thread
    from .backend import resolve_device

    dev = resolve_device(device)
    if _thread is not None and _thread.is_alive():
        return
    _stop.clear()

    def loop():
        while not _stop.wait(interval):
            heartbeat(dev, timeout=timeout)

    _thread = threading.Thread(target=loop, name="h2o-torch-heartbeat",
                               daemon=True)
    _thread.start()


def stop_heartbeat(join: bool = False, timeout: float = 5.0) -> None:
    """Stop the background loop. The drain path passes ``join=True`` so
    interpreter exit never races a probe; the join is bounded (a probe
    wedged on the device cannot be joined and must not block the
    drain)."""
    _stop.set()
    t = _thread
    if join and t is not None and t.is_alive():
        t.join(timeout)
