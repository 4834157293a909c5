"""Diagnostics: the runtime's event ring (``TimeLine``, ``timeline``).

The JAX package's ``diagnostics.py`` also registers the ring's
per-kind counts as a telemetry stat group and wraps its device
profiler and memory stats; those wait for ROADMAP Queue 1 items 7b-2
and 13, which port the telemetry registry, ``profile`` and
``device_memory``. What is here is what AutoML's jobs
(``automl.Job``) and the fault harness (``runtime/faults.py``) write.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any

__all__ = ["TimeLine", "timeline"]


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
