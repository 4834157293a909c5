"""Diagnostics: the runtime's event ring (``TimeLine``, ``timeline``),
served at ``GET /3/Timeline``; the package logger (``log``); the device
profiler (``profile``) and the card's memory (``device_memory``).

The ring's cumulative per-kind counts are the ``timeline`` stat group of
the telemetry registry (``runtime/telemetry.py``), so event rates reach
``GET /metrics`` after the events themselves left the ring.
``profile(logdir)`` wraps ``torch.profiler`` with CUDA activity (the
kernels' device times, CUPTI) around a block and writes a Chrome trace
under ``logdir``; ``device_memory()`` reads the caching allocator's
statistics and the driver's free and total bytes. Both are for the card:
without one they raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = ["TimeLine", "timeline", "log", "profile", "device_memory"]


@dataclass
class _Event:
    ts: float
    kind: str
    msg: str
    data: dict[str, Any] = field(default_factory=dict)


class TimeLine:
    """Fixed-size, thread-safe event ring. Beside the ring it keeps
    cumulative per-kind counts, which survive eviction from the ring."""

    def __init__(self, capacity: int = 4096):
        self._ring: collections.deque[_Event] = collections.deque(
            maxlen=capacity)
        self._counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def record(self, kind: str, msg: str = "", **data) -> None:
        with self._lock:
            self._ring.append(_Event(time.time(), kind, msg, data))
            self._counts[kind] += 1

    def events(self, kind: str | None = None) -> list[dict[str, Any]]:
        """Snapshot, oldest first."""
        with self._lock:
            evs = list(self._ring)
        return [{"ts": e.ts, "kind": e.kind, "msg": e.msg, **e.data}
                for e in evs if kind is None or e.kind == kind]

    def kind_counts(self) -> dict[str, int]:
        """Cumulative events per kind since process start."""
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


timeline = TimeLine()

from .runtime.telemetry import register_group as _register_tel_group  # noqa: E402

_register_tel_group("timeline", timeline.kind_counts)

log = logging.getLogger("h2o_kubernetes_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).4s %(name)s: %(message)s"))
    log.addHandler(_h)
    from .config import get_config

    log.setLevel(getattr(logging, str(get_config("log_level")).upper()))


@contextlib.contextmanager
def profile(logdir: str, device=None) -> Iterator[Any]:
    """``torch.profiler`` around a block; yields the profiler (its
    ``key_averages()`` hold the block's ops and kernels) and writes
    ``logdir/trace.json`` (Chrome trace format: chrome://tracing,
    Perfetto) when the block ends. On the card (``device=None``, the
    default; raises without one) it records CUDA activity as well as
    the host's; ``device="cpu"`` records the host only.

    On the card a session whose trace holds no device event raises
    RuntimeError once the trace is written. CUPTI can record nothing in
    a process that has run many earlier profiler sessions and CUDA graph
    captures (after ``chip_smoke.py``'s phases 1-29 on an H100, every
    session came back without a kernel); a fresh process records the
    kernels, so profile there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from .models.base import device_synchronize
    from .runtime.backend import resolve_device

    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    timeline.record("profile_start", logdir=logdir)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            device_synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    timeline.record("profile_stop", logdir=logdir)
    if dev.type == "cuda" and not any(
            e.device_type == DeviceType.CUDA for e in prof.key_averages()):
        raise RuntimeError(
            f"profile: CUDA activity was asked for on {dev} but the "
            f"trace under {logdir} holds no device event; CUPTI recorded "
            "nothing in this process (profile in a fresh process)")


def device_memory(device=None) -> list[dict[str, Any]]:
    """Memory of each CUDA device (``device=None``: every card; raises
    without one) or of ``device``: the caching allocator's bytes in use
    (``allocated_bytes.all.current``) and the driver's free bytes and
    total (``bytes_limit``). The CPU
    (``device="cpu"``) has no allocator statistics: its byte fields are
    None, as a JAX CPU device reports."""
    import torch

    from .runtime.backend import resolve_device

    if device is None:
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(device)]
    out = []
    for d in devs:
        if d.type == "cpu":
            out.append({"device": "cpu", "bytes_in_use": None,
                        "bytes_free": None, "bytes_limit": None})
            continue
        st = torch.cuda.memory_stats(d)
        free, total = torch.cuda.mem_get_info(d)
        out.append({"device": f"{d} ({torch.cuda.get_device_name(d)})",
                    "bytes_in_use": int(st.get("allocated_bytes.all.current",
                                               0)),
                    "bytes_free": int(free), "bytes_limit": int(total)})
    return out
