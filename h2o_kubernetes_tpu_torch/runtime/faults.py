"""Deterministic fault injection: named fault *points* call
``fire(site)``, and armed fault *specs* decide whether that call
raises, hangs or passes through, so failure paths run on demand.

The port fires one point today: ``automl.step``, one AutoML plan step
about to train (resumed steps do not count); kind ``device_error``
marks the node unhealthy and raises ``InjectedDeviceError``, which
ends the run mid-plan so a rerun with the same ``checkpoint_dir``
resumes it. The other kinds work at any site: ``http_<code>`` (a
urllib ``HTTPError``; param sets Retry-After), ``timeout``,
``urlerror``, ``truncate``, ``hang`` (sleeps param seconds, default
3600), ``dispatch_error`` (raises without marking the node unhealthy)
and ``error``.

Spec grammar (the JAX package's)::

    spec     := clause (";" clause)*          # "," also separates
    clause   := site ":" kind ["*" count] ["@" skip] ["~" param]
    count    := int | "inf"                   # how many times to fire (default 1)
    skip     := int                           # matching calls to let through first
    param    := float                         # kind-specific (seconds / Retry-After)

Example: ``automl.step:device_error@2`` lets two steps train and kills
the third.

Activation: the ``H2O_TPU_FAULTS`` env var (parsed lazily, counters
live for the process), or the ``inject(spec)`` context manager (test
scoped). With neither set, ``fire()`` is a dict lookup and a return.
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import re
import threading
import time
import urllib.error
from dataclasses import dataclass
from email.message import Message
from typing import Iterator

__all__ = ["Fault", "FaultError", "InjectedDeviceError", "parse",
           "inject", "fire", "active", "reset"]


class FaultError(RuntimeError):
    """Base class for errors raised by an injected fault."""


class InjectedDeviceError(FaultError):
    """Simulated device/runtime error escaping a dispatch."""


@dataclass
class Fault:
    """One armed fault: fires `count` times at `site` after letting
    `skip` matching calls through."""

    site: str
    kind: str
    count: float = 1          # float so "inf" arms a permanent fault
    skip: int = 0
    param: float | None = None

    def spec(self) -> str:
        out = f"{self.site}:{self.kind}"
        if self.count != 1:
            out += f"*{'inf' if self.count == float('inf') else int(self.count)}"
        if self.skip:
            out += f"@{self.skip}"
        if self.param is not None:
            out += f"~{self.param:g}"
        return out


_CLAUSE = re.compile(
    r"^(?P<site>[\w.]+):(?P<kind>\w+)"
    r"(?:\*(?P<count>\d+|inf))?"
    r"(?:@(?P<skip>\d+))?"
    r"(?:~(?P<param>\d+(?:\.\d+)?))?$")


def parse(spec: str) -> list[Fault]:
    """Parse a fault-spec string into armed Fault objects."""
    out = []
    for clause in re.split(r"[;,]", spec):
        clause = clause.strip()
        if not clause:
            continue
        m = _CLAUSE.match(clause)
        if not m:
            raise ValueError(
                f"bad fault clause {clause!r} — expected "
                "site:kind[*count][@skip][~param]")
        out.append(Fault(
            site=m["site"], kind=m["kind"],
            count=float("inf") if m["count"] == "inf"
            else int(m["count"] or 1),
            skip=int(m["skip"] or 0),
            param=float(m["param"]) if m["param"] else None))
    return out


_lock = threading.Lock()
_CTX: list[Fault] = []                 # inject()-scoped faults
# env-armed faults, cached against the env string so counters persist
# across fire() calls but a CHANGED env value re-arms fresh counters
_ENV_CACHE: tuple[str, list[Fault]] | None = None


def _armed() -> list[Fault]:
    """All armed faults (context-scoped first), under _lock."""
    global _ENV_CACHE
    env = os.environ.get("H2O_TPU_FAULTS", "")
    if not env:
        _ENV_CACHE = None
        return list(_CTX)
    if _ENV_CACHE is None or _ENV_CACHE[0] != env:
        _ENV_CACHE = (env, parse(env))
    return list(_CTX) + _ENV_CACHE[1]


def active() -> list[str]:
    """Specs of armed, non-exhausted faults (introspection/status)."""
    with _lock:
        return [f.spec() for f in _armed() if f.count > 0]


def reset() -> None:
    """Disarm everything — context faults AND env-armed ones.

    The current H2O_TPU_FAULTS value is pinned to an EMPTY armed list
    (not just dropped from the cache): otherwise the next fire() would
    re-parse the unchanged env var and resurrect exhausted faults with
    fresh counters. A *changed* env value still re-arms normally."""
    global _ENV_CACHE
    with _lock:
        _CTX.clear()
        env = os.environ.get("H2O_TPU_FAULTS", "")
        _ENV_CACHE = (env, []) if env else None


@contextlib.contextmanager
def inject(spec: str | list[Fault]) -> Iterator[list[Fault]]:
    """Arm faults for the duration of a with-block (test scoped)."""
    faults = parse(spec) if isinstance(spec, str) else list(spec)
    with _lock:
        _CTX.extend(faults)
    try:
        yield faults
    finally:
        with _lock:
            for f in faults:
                try:
                    _CTX.remove(f)
                except ValueError:
                    pass


def fire(site: str, **ctx) -> None:
    """Fault point: called by the runtime at a named site.

    Finds the first armed fault for `site`; consumes one skip or one
    count; raises/sleeps per the fault kind. No armed faults → returns
    immediately (the hot-loop fast path).
    """
    if not _CTX and not os.environ.get("H2O_TPU_FAULTS"):
        return
    fault, desc = None, ""
    with _lock:
        for f in _armed():
            if f.site != site or f.count <= 0:
                continue
            if f.skip > 0:
                f.skip -= 1
                return
            desc = f.spec()           # before the decrement, for logs
            f.count -= 1
            fault = f
            break
    if fault is None:
        return
    from ..diagnostics import timeline

    timeline.record("fault_injected", desc, site=site, **{
        k: str(v)[:120] for k, v in ctx.items()})
    logging.getLogger("h2o_kubernetes_tpu_torch").warning(
        "fault injected at %s: %s", site, desc)
    _trigger(fault, site, ctx)


def _trigger(fault: Fault, site: str, ctx: dict) -> None:
    kind = fault.kind
    if kind.startswith("http_"):
        code = int(kind[len("http_"):])
        hdrs = Message()
        if fault.param is not None:
            hdrs["Retry-After"] = f"{fault.param:g}"
        raise urllib.error.HTTPError(
            str(ctx.get("url", "injected://fault")), code,
            f"injected HTTP {code}", hdrs, io.BytesIO(b"injected fault"))
    if kind == "timeout":
        raise TimeoutError(f"injected timeout at {site}")
    if kind == "urlerror":
        raise urllib.error.URLError(f"injected connection failure at {site}")
    if kind == "truncate":
        import http.client

        raise http.client.IncompleteRead(b"", expected=1)
    if kind == "hang":
        time.sleep(fault.param if fault.param is not None else 3600.0)
        return
    if kind == "device_error":
        # a device error escaping a training step takes the node down:
        # flip health first so the next guard fails fast
        from . import health

        msg = (f"injected device error at {site} "
               "(fault harness, kind=device_error)")
        health.mark_unhealthy(msg)
        raise InjectedDeviceError(msg)
    if kind == "dispatch_error":
        # a device error confined to one dispatch: the circuit
        # breaker's signature, which does not lock the node
        raise InjectedDeviceError(
            f"injected dispatch error at {site} "
            "(fault harness, kind=dispatch_error)")
    if kind == "error":
        raise FaultError(f"injected error at {site}")
    raise ValueError(f"unknown fault kind {kind!r} (site {site})")
