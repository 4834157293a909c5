"""Pipelined executor: the device stream and the host stream of an
AutoML run or a cross-validation fold loop.

A serial loop interleaves two independent resources on one thread:
device work (training) and host bookkeeping (holdout copies, metrics,
leaderboard insertion, resume-manifest writes). This module gives each
its own stream so they overlap:

- **device stream**: the caller's thread, holding the device *token*
  (``PipelinedExecutor.device``). Only the token holder launches device
  work, so device work stays strictly ordered.
- **host stream** (``HostStream``): one worker that applies completion
  callbacks strictly in submission-sequence order, whatever order they
  become runnable, so a pipelined leaderboard and resume manifest equal
  the serial run's.

``PipelinedExecutor.stats()`` reports the device and host streams'
busy seconds, so a caller can state how much host work left the
critical path.

The JAX package's third stream, a compile-ahead worker that fills
XLA's persistent compilation cache, has no counterpart: eager torch
compiles nothing ahead of a launch (the CUDA kernels are built once
per source by ``ops/_build.py``). Its ``H2O_TPU_AUTOML_PIPELINE`` kill
switch has none either: the port runs pipelined only.

Knob (read at use time): ``H2O_TPU_AUTOML_QUEUE_DEPTH``, the bound on
the host stream's pending queue (default 4), its backpressure.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable

__all__ = ["queue_depth", "HostStream", "PipelinedExecutor"]


def _int_env(name: str, default: int, lo: int) -> int:
    try:
        return max(lo, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


def queue_depth() -> int:
    return _int_env("H2O_TPU_AUTOML_QUEUE_DEPTH", 4, 1)


class HostStream:
    """Single worker applying callables strictly in sequence order.

    ``submit(seq, fn)`` may arrive in any order; the worker holds a
    task back until every lower sequence number has been applied or
    explicitly ``skip()``-ed (a step that failed or fell out of budget
    produces no completion).  Task exceptions are captured — not
    raised on the worker — and surfaced via ``pop_errors``/``drain``,
    mirroring the serial loop where a failed step never kills the run.
    """

    def __init__(self, name: str = "h2o-torch-automl-host",
                 max_pending: int | None = None):
        self._cond = threading.Condition()
        self._tasks: dict[int, tuple[Callable[[], None], str]] = {}
        self._skipped: set[int] = set()
        self._next = 0
        self._inflight = False
        self._stopped = False
        self._errors: list[tuple[int, str, BaseException]] = []
        self._max_pending = max_pending or queue_depth()
        self.stats = {"applied": 0, "skipped": 0, "busy_s": 0.0,
                      "max_pending": 0}
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, seq: int, fn: Callable[[], None],
               label: str = "") -> None:
        """Queue ``fn`` for in-order application; blocks (backpressure)
        while the pending queue is full AND the worker has runnable
        work — a starving worker (held back by a missing lower seq)
        admits immediately, otherwise blocking the very submit that
        fills the gap would deadlock the producer against its own
        backlog."""
        with self._cond:
            if self._stopped:
                raise RuntimeError("host stream is stopped")
            if seq < self._next or seq in self._tasks \
                    or seq in self._skipped:
                raise ValueError(f"seq {seq} already submitted/applied")
            while len(self._tasks) >= self._max_pending \
                    and not self._stopped \
                    and (self._inflight or self._next in self._tasks
                         or self._next in self._skipped):
                self._cond.wait(timeout=0.5)
            if self._stopped:
                # stop() raced the backpressure wait: refuse loudly —
                # appending now would silently drop the task (the
                # worker is gone) and misreport a wedge at drain
                raise RuntimeError("host stream is stopped")
            self._tasks[seq] = (fn, label)
            self.stats["max_pending"] = max(self.stats["max_pending"],
                                            len(self._tasks))
            self._cond.notify_all()

    def skip(self, seq: int) -> None:
        """Mark a sequence number that will never be submitted."""
        with self._cond:
            if seq < self._next or seq in self._tasks:
                return
            self._skipped.add(seq)
            self._cond.notify_all()

    def pop_errors(self) -> list[tuple[int, str, BaseException]]:
        with self._cond:
            out, self._errors = self._errors, []
            return out

    def pending(self) -> list[int]:
        with self._cond:
            return sorted(self._tasks)

    def drain(self, timeout: float | None = None
              ) -> list[tuple[int, str, BaseException]]:
        """Block until everything submitted/skipped has been applied;
        returns the captured task errors.  Raises TimeoutError naming
        the wedge (a submit gap with no skip()) instead of hanging."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._tasks or self._skipped or self._inflight:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"host stream wedged at seq {self._next}: "
                        f"pending={sorted(self._tasks)} "
                        f"skipped={sorted(self._skipped)}")
                self._cond.wait(timeout=0.5 if remaining is None
                                else min(0.5, remaining))
        return self.pop_errors()

    def stop(self, timeout: float = 30.0) -> bool:
        """Drain then stop the worker; True when the thread exited.
        A wedged drain is reported by the bool (and by an explicit
        drain() call beforehand), never raised — stop() runs on error
        paths where a fresh TimeoutError would mask the real failure."""
        try:
            self.drain(timeout=timeout)
        except TimeoutError:
            pass
        finally:
            with self._cond:
                self._stopped = True
                self._cond.notify_all()
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def _run(self) -> None:
        while True:
            with self._cond:
                task = None
                while task is None:
                    while self._next in self._skipped:
                        self._skipped.discard(self._next)
                        self._next += 1
                        self.stats["skipped"] += 1
                        self._cond.notify_all()
                    if self._next in self._tasks:
                        task = self._tasks.pop(self._next)
                        self._inflight = True
                        self._cond.notify_all()
                        break
                    if self._stopped:
                        return
                    self._cond.wait(timeout=0.5)
            fn, label = task
            seq = self._next
            t0 = time.monotonic()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced at drain
                with self._cond:
                    self._errors.append((seq, label, e))
            finally:
                with self._cond:
                    self.stats["busy_s"] += time.monotonic() - t0
                    self.stats["applied"] += 1
                    self._next = seq + 1
                    self._inflight = False
                    self._cond.notify_all()


class PipelinedExecutor:
    """The device token and the host stream, with overlap accounting.

    The device *token* is a lock: whoever holds it may launch device
    work. The owning thread wraps each training step in ``device()``,
    which attributes its wall time to the device stream."""

    def __init__(self, queue: int | None = None):
        self._t0 = time.monotonic()
        self._token = threading.Lock()
        self.host = HostStream(max_pending=queue)
        self._dev = {"busy_s": 0.0, "steps": 0}

    @contextlib.contextmanager
    def device(self, label: str = ""):
        """Hold the device token for one training step."""
        with self._token:
            t0 = time.monotonic()
            try:
                yield
            finally:
                self._dev["busy_s"] += time.monotonic() - t0
                self._dev["steps"] += 1

    def shutdown(self, timeout: float = 30.0) -> bool:
        """Drain and stop the host stream; True when its thread exited."""
        return self.host.stop(timeout=timeout)

    def stats(self) -> dict:
        """Wall seconds against each stream's busy seconds."""
        return {
            "wall_s": round(time.monotonic() - self._t0, 3),
            "device_busy_s": round(self._dev["busy_s"], 3),
            "device_steps": self._dev["steps"],
            "host_busy_s": round(self.host.stats["busy_s"], 3),
            "host_applied": self.host.stats["applied"],
            "host_max_pending": self.host.stats["max_pending"],
        }
