"""Telemetry — ONE process-wide metrics registry + request tracing.

The serving surfaces (``rest.STATS``/``MODEL_STATS``, the batcher,
``scorer_cache_stats()``, the breaker and lifecycle, the timeline's
event counts) register here, and the registry renders them twice: as
the ``GET /3/Stats`` JSON and as the Prometheus text at
``GET /metrics``, so one scrape sees every counter ``/3/Stats``
reports. This is a copy of the JAX package's ``runtime/telemetry.py``,
rewired to the port:

- **Metrics registry** (`REGISTRY`): thread-safe counters, gauges and
  bounded-bucket histograms. Label names are validated against a fixed
  allowlist so a typo'd label cannot mint unbounded series, and the
  ``model`` label is cardinality-capped: per metric, the top-K model
  values by traffic keep their own series and everything else rolls up
  into an ``other`` series (``H2O_TPU_METRICS_TOPK``).
- **Stat groups** (`register_group`): the dict surfaces stay the
  storage their owning modules mutate; the registry snapshots them for
  ``/3/Stats`` and flattens every numeric leaf into the exposition.
- **Request tracing** (`TRACER`): each scoring request records its
  spans (admission wait / batcher queue wait / batch assembly / device
  dispatch / total) under its ``X-H2O-Trace-Id`` in a bounded ring
  (``H2O_TPU_TRACE_RING``) served at ``GET /3/Trace/{id}``. Tracing is
  always on: the port has no switch that turns it off.
- **Training phase spans** (`phase_span`): out-of-core chunk uploads
  and builds feed the ``diagnostics`` TimeLine AND per-phase latency
  histograms, and the out-of-core stream reports its upload/compute
  overlap (`ooc_stream_account`).

Imports neither torch nor numpy at module import; ``build_info`` reads
torch's version, its CUDA version and the card's name when asked.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import uuid

from .retry import _env_float

__all__ = [
    "REGISTRY", "TRACER", "MetricsRegistry", "TraceRing",
    "register_group", "group_snapshot", "prometheus_text",
    "parse_prometheus_text", "build_info", "phase_span",
    "record_request_phases", "new_trace_id", "trace_id_from",
    "count_event", "ooc_stream_account", "start_status_listener",
    "metric_name", "CONTENT_TYPE", "write_metrics",
]

# the Prometheus text exposition content type (0.0.4 is the text format
# every scraper speaks)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Fixed label-name allowlist: metrics may carry at most ONE label and
# its NAME must come from here — labels are the cardinality lever, and
# an open-ended label vocabulary is how a registry rots into a series
# explosion nobody can aggregate. (`value` is the flattener's label for
# string leaves, `le` is the histogram bucket bound.)
ALLOWED_LABELS = frozenset({
    "model", "shard", "phase", "kind", "slo", "outcome", "state",
    "event", "route", "pool", "replica", "value", "le",
    "version", "torch", "cuda", "device",
})

# label names whose VALUE set is unbounded by construction (tenant
# keys): series under them are capped at top-K-by-traffic + "other"
CAPPED_LABELS = frozenset({"model"})

# bounded default buckets (seconds) for latency histograms: 1ms..10s
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_PHASES = ("admission", "queue", "assemble", "dispatch", "total")


def _topk() -> int:
    """H2O_TPU_METRICS_TOPK (default 20): per-metric series cap for
    capped labels — the top-K label values by traffic keep their own
    series, the rest roll into `other`."""
    return max(1, int(_env_float("H2O_TPU_METRICS_TOPK", 20.0)))


def _sanitize(part: str) -> str:
    """A dict key / group name as a Prometheus metric-name component."""
    out = []
    for ch in str(part):
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def metric_name(*parts: str) -> str:
    """THE /3/Stats-leaf -> /metrics-sample naming rule, shared with
    the inventory-diff test so the two surfaces cannot drift:
    ``metric_name("batcher", "shed") == "h2o_stats_batcher_shed"``."""
    return "_".join(["h2o_stats"] + [_sanitize(p) for p in parts])


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n") \
        .replace('"', '\\"')


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------


class _LabeledMetric:
    """Shared machinery: one optional label; when the label is capped
    (`model`), series are bounded at top-K by traffic + an `other`
    rollup. All state mutations run under the registry lock (passed
    in), so a multi-threaded hammer loses no updates."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, label: str | None,
                 lock: threading.Lock):
        if label is not None and label not in ALLOWED_LABELS:
            raise ValueError(
                f"metric {name!r}: label {label!r} is not in the "
                f"fixed allowlist {sorted(ALLOWED_LABELS)} — labels "
                "are the cardinality lever; add to the allowlist "
                "deliberately, never ad hoc")
        self.name = name
        self.help = help_
        self.label = label
        self._lock = lock
        self._series: dict[str | None, object] = {}
        # traffic rank for capped labels (bounded itself: evicts the
        # lowest counts past 8*K so the RANKING map cannot become the
        # cardinality leak it exists to prevent)
        self._traffic: dict[str, int] = {}

    def _new_series(self):                       # pragma: no cover
        raise NotImplementedError

    def _merge_into(self, dst, src) -> None:     # pragma: no cover
        raise NotImplementedError

    def _series_for(self, value: str | None):
        """Resolve the series a label value lands in (caller holds the
        lock). Uncapped labels get a series per value — their
        vocabulary is fixed (phases, SLO classes, outcomes)."""
        if self.label is None:
            value = None
        if value is None or self.label not in CAPPED_LABELS:
            s = self._series.get(value)
            if s is None:
                s = self._series[value] = self._new_series()
            return s
        value = str(value)
        k = _topk()
        t = self._traffic
        t[value] = t.get(value, 0) + 1
        if len(t) > 8 * k:
            for v in sorted(t, key=t.get)[: len(t) - 4 * k]:
                if v not in self._series:
                    del t[v]
        s = self._series.get(value)
        if s is not None:
            return s
        named = [v for v in self._series if v not in (None, "other")]
        if len(named) < k:
            s = self._series[value] = self._new_series()
            return s
        # at capacity: a newcomer with MORE traffic than the coldest
        # resident demotes it into `other` and takes its slot — the
        # exposed set converges on the true top-K by traffic
        coldest = min(named, key=lambda v: t.get(v, 0))
        if t[value] > t.get(coldest, 0):
            other = self._series.get("other")
            if other is None:
                other = self._series["other"] = self._new_series()
            self._merge_into(other, self._series.pop(coldest))
            s = self._series[value] = self._new_series()
            return s
        other = self._series.get("other")
        if other is None:
            other = self._series["other"] = self._new_series()
        return other

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)


class Counter(_LabeledMetric):
    kind = "counter"

    def _new_series(self):
        return [0.0]

    def _merge_into(self, dst, src) -> None:
        dst[0] += src[0]

    def inc(self, n: float = 1.0, label_value: str | None = None
            ) -> None:
        with self._lock:
            self._series_for(label_value)[0] += n

    def value(self, label_value: str | None = None) -> float:
        with self._lock:
            s = self._series.get(
                label_value if self.label is not None else None)
            return s[0] if s is not None else 0.0

    def samples(self):
        with self._lock:
            return [(self.name,
                     {self.label: v} if v is not None else {}, s[0])
                    for v, s in self._series.items()]


class Gauge(_LabeledMetric):
    kind = "gauge"

    def __init__(self, name, help_, label, lock, fn=None):
        super().__init__(name, help_, label, lock)
        # callback gauges: fn() -> scalar, read at scrape time
        self._fn = fn

    def _new_series(self):
        return [0.0]

    def _merge_into(self, dst, src) -> None:
        dst[0] = src[0]

    def set(self, v: float, label_value: str | None = None) -> None:
        with self._lock:
            self._series_for(label_value)[0] = float(v)

    def value(self, label_value: str | None = None) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a scrape must survive
                return float("nan")
        with self._lock:
            s = self._series.get(
                label_value if self.label is not None else None)
            return s[0] if s is not None else 0.0

    def samples(self):
        if self._fn is not None:
            return [(self.name, {}, self.value())]
        with self._lock:
            return [(self.name,
                     {self.label: v} if v is not None else {}, s[0])
                    for v, s in self._series.items()]


class Histogram(_LabeledMetric):
    """Bounded-bucket histogram: cumulative bucket counts, sum,
    count — the Prometheus shape, quantile-estimable by any scraper."""

    kind = "histogram"

    def __init__(self, name, help_, label, lock, buckets=None):
        super().__init__(name, help_, label, lock)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def _new_series(self):
        # [count per bucket..., +Inf count, sum, total count]
        return [0] * (len(self.buckets) + 1) + [0.0, 0]

    def _merge_into(self, dst, src) -> None:
        for i in range(len(src)):
            dst[i] += src[i]

    def observe(self, v: float, label_value: str | None = None) -> None:
        with self._lock:
            s = self._series_for(label_value)
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            s[i] += 1
            s[-2] += v
            s[-1] += 1

    def snapshot(self, label_value: str | None = None) -> dict:
        with self._lock:
            s = self._series.get(
                label_value if self.label is not None else None)
            if s is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            cum, out = 0, {}
            for i, b in enumerate(self.buckets):
                cum += s[i]
                out[b] = cum
            return {"count": s[-1], "sum": s[-2], "buckets": out}

    def quantile(self, q: float, label_value: str | None = None
                 ) -> float | None:
        """Linear-interpolated quantile estimate off the buckets (what
        fleet_top renders as p99) — None on an empty series."""
        snap = self.snapshot(label_value)
        n = snap["count"]
        if not n:
            return None
        target = q * n
        prev_b, prev_c = 0.0, 0
        for b, c in snap["buckets"].items():
            if c >= target:
                span = c - prev_c
                frac = (target - prev_c) / span if span else 1.0
                return prev_b + (b - prev_b) * frac
            prev_b, prev_c = b, c
        return self.buckets[-1]

    def samples(self):
        out = []
        with self._lock:
            for v, s in self._series.items():
                labels = {self.label: v} if v is not None else {}
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += s[i]
                    out.append((self.name + "_bucket",
                                {**labels, "le": f"{b:g}"}, cum))
                out.append((self.name + "_bucket",
                            {**labels, "le": "+Inf"}, cum + s[-3]))
                out.append((self.name + "_sum", labels, s[-2]))
                out.append((self.name + "_count", labels, s[-1]))
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Process-wide metric store + the stat-group registration point.

    First-class metrics (`counter`/`gauge`/`histogram`) are get-or-
    create by name (idempotent — module reimports re-resolve the same
    object). Stat GROUPS are zero-arg snapshot callables the existing
    dict surfaces register; both ``/3/Stats`` and ``/metrics`` render
    from them, which is what makes the registry the single source of
    truth without double-counting a single increment."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _LabeledMetric] = {}
        # name -> (fn, labeled): insertion-ordered, the /3/Stats
        # assembly order
        self._groups: dict = collections.OrderedDict()

    def _get(self, cls, name, help_, label, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, label, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls) or m.label != label:
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.__name__}"
                    f"/label={label!r} but exists as "
                    f"{type(m).__name__}/label={m.label!r}")
            return m

    def counter(self, name: str, help_: str = "",
                label: str | None = None) -> Counter:
        return self._get(Counter, name, help_, label)

    def gauge(self, name: str, help_: str = "",
              label: str | None = None, fn=None) -> Gauge:
        return self._get(Gauge, name, help_, label, fn=fn)

    def histogram(self, name: str, help_: str = "",
                  label: str | None = None,
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help_, label,
                         buckets=buckets)

    # -- stat groups ---------------------------------------------------------

    def register_group(self, name: str, fn, labeled: str | None = None
                       ) -> None:
        """Register a zero-arg dict-snapshot callable. ``labeled``
        names the label the group's TOP-LEVEL keys map to (e.g. the
        per-model counter dict registers ``labeled="model"`` so its
        exposition is ``h2o_stats_models_requests{model=...}`` with
        the top-K + `other` cap applied at scrape time). Idempotent
        by name — last registration wins (in-process restarts)."""
        if labeled is not None and labeled not in ALLOWED_LABELS:
            raise ValueError(f"group {name!r}: label {labeled!r} not "
                             "in the allowlist")
        with self._lock:
            self._groups[name] = (fn, labeled)

    def group_snapshot(self, names=None) -> dict:
        """{group: fn()} — THE /3/Stats payload source. A group whose
        snapshot raises contributes an error marker instead of killing
        the scrape (a stats read must never 500 the probe surface)."""
        with self._lock:
            items = [(n, f) for n, (f, _l) in self._groups.items()
                     if names is None or n in names]
        out = {}
        for n, fn in items:
            try:
                out[n] = fn()
            except Exception as e:  # noqa: BLE001
                out[n] = {"error": repr(e)[:200]}
        return out

    # -- exposition ----------------------------------------------------------

    @staticmethod
    def _flatten(path: tuple, obj, out: list) -> None:
        if isinstance(obj, bool):
            out.append((metric_name(*path), {}, 1.0 if obj else 0.0))
        elif isinstance(obj, (int, float)):
            out.append((metric_name(*path), {}, float(obj)))
        elif isinstance(obj, str):
            # string leaves (breaker/lifecycle state) become an
            # info-style sample: h2o_stats_..._state{value="open"} 1
            out.append((metric_name(*path),
                        {"value": obj[:120]}, 1.0))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                MetricsRegistry._flatten(path + (str(k),), v, out)
        # lists/None: no numeric identity — skipped by design

    @staticmethod
    def _flatten_labeled(group: str, label: str, obj: dict,
                         out: list) -> None:
        """{label_value: {counter: num}} with the top-K-by-traffic +
        `other` rollup applied at scrape time (rank = the series' own
        numeric mass, so the hot tenants keep their series)."""
        k = _topk()
        vals = [(str(lv), rec) for lv, rec in obj.items()
                if isinstance(rec, dict)]

        def mass(rec: dict) -> float:
            return sum(v for v in rec.values()
                       if isinstance(v, (int, float))
                       and not isinstance(v, bool))

        vals.sort(key=lambda it: -mass(it[1]))
        keep, roll = vals[:k], vals[k:]
        rolled: dict[tuple, float] = {}
        for lv, rec in keep:
            flat: list = []
            MetricsRegistry._flatten((group,), rec, flat)
            for name, lbls, v in flat:
                out.append((name, {label: lv, **lbls}, v))
        for _lv, rec in roll:
            flat = []
            MetricsRegistry._flatten((group,), rec, flat)
            for name, lbls, v in flat:
                if lbls:        # string leaves don't aggregate
                    continue
                rolled[(name,)] = rolled.get((name,), 0.0) + v
        for (name,), v in rolled.items():
            out.append((name, {label: "other"}, v))

    def prometheus_text(self, extra_groups: dict | None = None) -> str:
        """The ``GET /metrics`` payload: every first-class metric plus
        every registered stat group's numeric leaves. ``extra_groups``
        lets a per-instance surface (the router) merge its snapshot
        into ITS server's exposition without registering process-wide
        state."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
            groups = list(self._groups.items())
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, labels, v in m.samples():
                lines.append(_render_sample(name, labels, v))
        flat: list = []
        for gname, (fn, labeled) in groups:
            try:
                snap = fn()
            except Exception:  # noqa: BLE001 — one group must not
                continue       # kill the whole exposition
            if labeled and isinstance(snap, dict):
                self._flatten_labeled(gname, labeled, snap, flat)
            else:
                self._flatten((gname,), snap, flat)
        for gname, snap in (extra_groups or {}).items():
            self._flatten((gname,), snap, flat)
        seen_types = set()
        for name, labels, v in flat:
            base = name
            if base not in seen_types:
                seen_types.add(base)
                lines.append(f"# TYPE {base} gauge")
            lines.append(_render_sample(name, labels, v))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Tests only: drop every first-class metric (groups stay —
        their owners registered them at import)."""
        with self._lock:
            self._metrics.clear()


def _render_sample(name: str, labels: dict, v: float) -> str:
    if labels:
        lab = ",".join(f'{k}="{_escape_label(val)}"'
                       for k, val in sorted(labels.items()))
        return f"{name}{{{lab}}} {v:g}"
    return f"{name} {v:g}"


def parse_prometheus_text(text: str) -> dict:
    """Inverse of the exposition (fleet_top + the inventory-diff test):
    {(name, ((label, value), ...)): float}."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            body, _, val = line.rpartition(" ")
            name, labels = body, ()
            if "{" in body:
                name, _, rest = body.partition("{")
                rest = rest.rstrip("}")
                lbls = []
                for part in _split_labels(rest):
                    k, _, v = part.partition("=")
                    lbls.append((k, v.strip('"')
                                 .replace('\\"', '"')
                                 .replace("\\n", "\n")
                                 .replace("\\\\", "\\")))
                labels = tuple(sorted(lbls))
            out[(name, labels)] = float(val)
        except ValueError:
            continue
    return out


def _split_labels(s: str) -> list[str]:
    parts, depth, cur = [], False, []
    for ch in s:
        if ch == '"':
            depth = not depth
        if ch == "," and not depth:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


REGISTRY = MetricsRegistry()


def register_group(name: str, fn, labeled: str | None = None) -> None:
    REGISTRY.register_group(name, fn, labeled)


def group_snapshot(names=None) -> dict:
    return REGISTRY.group_snapshot(names)


def prometheus_text(extra_groups: dict | None = None) -> str:
    return REGISTRY.prometheus_text(extra_groups)


def write_metrics(handler, extra_groups: dict | None = None) -> None:
    """THE GET /metrics response writer — shared by the replica REST
    handler, the router front door, and the status listener so the
    exposition response (content type, headers) cannot drift between
    surfaces. ``handler`` is any BaseHTTPRequestHandler."""
    body = prometheus_text(extra_groups).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


# ---------------------------------------------------------------------------
# Build info
# ---------------------------------------------------------------------------

_STARTED_AT = time.time()
_BUILD: dict | None = None
_BUILD_LOCK = threading.Lock()


def build_info() -> dict:
    """Which build produced this scrape: the package version, torch's
    version, its CUDA version and the card's name (``cpu`` without
    one), pid and uptime. Never reads jax."""
    global _BUILD
    with _BUILD_LOCK:
        if _BUILD is None:
            import torch

            pkg_version = None
            try:
                src = os.path.join(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))),
                    "__init__.py")
                with open(src) as f:
                    for line in f:
                        if line.startswith("__version__"):
                            pkg_version = line.split('"')[1]
                            break
            except OSError:
                pass
            try:
                device = torch.cuda.get_device_name(0) \
                    if torch.cuda.is_available() else "cpu"
            except Exception:  # noqa: BLE001 — a scrape must survive
                device = None
            _BUILD = {
                "version": pkg_version,
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "device": device,
                "pid": os.getpid(),
                "started_at": round(_STARTED_AT, 3),
            }
        out = dict(_BUILD)
    out["uptime_s"] = round(time.time() - _STARTED_AT, 3)
    return out


def _register_build_gauge() -> None:
    """`h2o_build_info{version=...,torch=...,cuda=...,device=...} 1` —
    the Prometheus idiom for build metadata (join on it, never sum
    it). Its labels are read at scrape time, so importing this module
    touches no device."""

    class _Info(Gauge):
        def samples(self):
            b = build_info()
            return [("h2o_build_info",
                     {k: str(b.get(k)) for k in
                      ("version", "torch", "cuda", "device")}, 1.0)]

    with REGISTRY._lock:
        REGISTRY._metrics.setdefault(
            "h2o_build_info",
            _Info("h2o_build_info",
                  "build identity (constant 1; labels carry it)",
                  None, REGISTRY._lock))


_register_build_gauge()


# ---------------------------------------------------------------------------
# Request tracing
# ---------------------------------------------------------------------------


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def trace_id_from(headers) -> str:
    """The propagation contract: take X-H2O-Trace-Id when present and
    well-formed (alnum/_/- up to 64 chars — a header is attacker
    input and becomes a dict key + response header), else mint."""
    raw = headers.get("X-H2O-Trace-Id") if headers is not None else None
    if raw:
        tid = str(raw).strip()[:64]
        if tid and all(c.isalnum() or c in "-_" for c in tid):
            return tid
    return new_trace_id()


class TraceRing:
    """Bounded per-process span store: trace_id -> span record. The
    ring (H2O_TPU_TRACE_RING entries, default 512) evicts oldest-
    inserted, so a serving storm can never grow it — recent traces are
    the debuggable ones anyway."""

    def __init__(self, capacity: int | None = None):
        self._lock = threading.Lock()
        self._ring: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._cap = capacity

    def _capacity(self) -> int:
        if self._cap is not None:
            return self._cap
        return max(8, int(_env_float("H2O_TPU_TRACE_RING", 512.0)))

    # spans kept per RECORD: the ring bounds record count, this bounds
    # a single record — a client reusing one (valid-looking) trace id
    # for every request must not grow one record without limit
    MAX_SPANS = 256

    def record(self, trace_id: str, spans, **meta) -> None:
        """Append spans under ``trace_id`` (merging with an existing
        record — a hedged request's two legs land on one trace).
        Past MAX_SPANS per record, further spans are dropped and the
        record is flagged ``truncated`` (a reused id is a client bug
        or an attack, never a reason for unbounded memory)."""
        with self._lock:
            rec = self._ring.get(trace_id)
            if rec is None:
                rec = {"trace_id": trace_id, "ts": time.time(),
                       "spans": []}
                self._ring[trace_id] = rec
                while len(self._ring) > self._capacity():
                    self._ring.popitem(last=False)
            room = self.MAX_SPANS - len(rec["spans"])
            if room <= 0:
                rec["truncated"] = True
            else:
                spans = list(spans)
                if len(spans) > room:
                    rec["truncated"] = True
                rec["spans"].extend(spans[:room])
            for k, v in meta.items():
                rec.setdefault(k, v)

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            rec = self._ring.get(trace_id)
            return None if rec is None else {
                **rec, "spans": list(rec["spans"])}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


TRACER = TraceRing()


def request_phase_histogram() -> Histogram:
    return REGISTRY.histogram(
        "h2o_request_phase_seconds",
        "per-request serving phase latency "
        "(admission|queue|assemble|dispatch|total)", label="phase")


def record_request_phases(trace_id: str | None, marks: dict,
                          t_start: float, t_end: float,
                          model: str | None = None,
                          slo: str | None = None,
                          kind: str = "score",
                          outcome: str | None = None) -> list:
    """Turn the batcher's timestamp marks into named spans, feed the
    per-phase latency histograms (+ the per-model total-latency
    histogram, capped top-K), and file the span record under
    ``trace_id``. Returns the span list (the route echoes nothing —
    GET /3/Trace/{id} serves it). ``outcome`` marks a FAILED request
    (shed/504/breaker/timeout error name): the slow requests tracing
    exists to debug are exactly the ones that die in the queue, so
    they must appear in the ring and the histograms too — phases
    without marks (never dispatched) simply contribute no span."""
    hist = request_phase_histogram()

    def span(name, a, b):
        if a is None or b is None or b < a:
            return None
        dur = b - a
        hist.observe(dur, label_value=name)
        return {"name": name, "ms": round(dur * 1000.0, 3)}

    spans = [s for s in (
        span("admission", marks.get("admit"), marks.get("enqueue")),
        span("queue", marks.get("enqueue"), marks.get("pop")),
        span("assemble", marks.get("pop"), marks.get("dispatch_start")),
        span("dispatch", marks.get("dispatch_start"),
             marks.get("dispatch_end")),
        span("total", t_start, t_end),
    ) if s is not None]
    if t_start is not None:
        REGISTRY.histogram(
            "h2o_request_seconds",
            "end-to-end request latency per model (top-K + other)",
            label="model").observe(t_end - t_start,
                                   label_value=model)
    if trace_id:
        meta = {"model": model, "slo": slo, "kind": kind,
                "hop": "replica"}
        if outcome is not None:
            meta["outcome"] = outcome
        TRACER.record(trace_id, spans, **meta)
    return spans


# ---------------------------------------------------------------------------
# Training phase spans
# ---------------------------------------------------------------------------


def train_phase_histogram() -> Histogram:
    return REGISTRY.histogram(
        "h2o_train_phase_seconds",
        "training phase durations (bin|boost|level_hist|split_find|"
        "chunk_upload|compile_ahead_fill)", label="phase",
        buckets=(0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0,
                 300.0))


@contextlib.contextmanager
def phase_span(phase: str, **data):
    """Time a training/scheduler phase into the per-phase histogram
    AND the diagnostics TimeLine (kind="phase") — the /3/Timeline ring
    keeps the sequence, the histogram keeps the distribution."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        dur = time.monotonic() - t0
        train_phase_histogram().observe(dur, label_value=phase)
        try:
            from ..diagnostics import timeline

            timeline.record("phase", phase, phase=phase,
                            dur_ms=round(dur * 1000.0, 3), **data)
        except Exception:  # noqa: BLE001 — accounting only
            pass


# -- out-of-core stream overlap accounting ----------------------------------
#
# The ooc chunk stream double-buffers host->device uploads against the
# histogram build (arXiv:2005.09148's design); SCALING.md previously
# ESTIMATED how well that overlap works. The stream now reports it:
# upload seconds (time blocked in device_put), compute seconds (time
# the consumer held the generator suspended), and the derived
# overlap-efficiency gauge compute/(compute+upload) — 1.0 means every
# upload hid fully under compute.

_OOC_LOCK = threading.Lock()
_OOC = {"upload_s": 0.0, "compute_s": 0.0, "wall_s": 0.0, "streams": 0}


def ooc_stream_account(upload_s: float, compute_s: float,
                       wall_s: float) -> None:
    with _OOC_LOCK:
        _OOC["upload_s"] += upload_s
        _OOC["compute_s"] += compute_s
        _OOC["wall_s"] += wall_s
        _OOC["streams"] += 1
    REGISTRY.counter("h2o_ooc_upload_seconds_total",
                     "time blocked uploading ooc chunks").inc(upload_s)
    REGISTRY.counter("h2o_ooc_compute_seconds_total",
                     "consumer compute time over the ooc stream"
                     ).inc(compute_s)
    denom = _OOC["upload_s"] + _OOC["compute_s"]
    REGISTRY.gauge(
        "h2o_ooc_overlap_ratio",
        "fraction of stream time spent computing (1.0 = uploads "
        "fully hidden under compute)").set(
        _OOC["compute_s"] / denom if denom > 0 else 0.0)


def ooc_overlap_snapshot() -> dict:
    with _OOC_LOCK:
        out = dict(_OOC)
    denom = out["upload_s"] + out["compute_s"]
    out["overlap_ratio"] = round(out["compute_s"] / denom, 4) \
        if denom > 0 else None
    return out


register_group("ooc_stream", ooc_overlap_snapshot)


# ---------------------------------------------------------------------------
# Operator events
# ---------------------------------------------------------------------------


def count_event(kind: str) -> None:
    """Reconciler/ShardedPool events re-registered through the
    registry (`h2o_operator_events_total{event=...}`) — the durable
    store keeps the ring, /metrics keeps the rates."""
    REGISTRY.counter("h2o_operator_events_total",
                     "operator reconcile events by kind",
                     label="event").inc(label_value=str(kind)[:64])


# ---------------------------------------------------------------------------
# Status listener (operator.run / any device-free process)
# ---------------------------------------------------------------------------


def start_status_listener(port: int, host: str = "127.0.0.1",
                          extra_groups=None):
    """A tiny /metrics + /healthz HTTP listener for processes that do
    not run the full REST node (the operator). ``extra_groups`` is a
    zero-arg callable -> dict merged into the exposition. Returns the
    server (``server_address[1]`` is the bound port — pass 0 for an
    ephemeral one); None when port is None. The CALLER owns the
    off-by-default policy (operator.run starts one only when
    --status-port / H2O_TPU_METRICS_PORT says so). Never imports
    rest.py. Stop it with ``shutdown()`` then ``server_close()``."""
    if port is None:
        return None
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _StatusHandler(BaseHTTPRequestHandler):
        server_version = "h2o-torch-status/1"

        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/metrics":
                eg = None
                if extra_groups is not None:
                    try:
                        eg = extra_groups()
                    except Exception:  # noqa: BLE001
                        eg = None
                return write_metrics(self, eg)
            if path == "/healthz":
                return self._send(
                    200, json.dumps(
                        {"alive": True, "build": build_info()}
                    ).encode(), "application/json")
            return self._send(404, b"not found", "text/plain")

    srv = ThreadingHTTPServer((host, int(port)), _StatusHandler)
    t = threading.Thread(target=srv.serve_forever,
                         name="h2o-torch-status", daemon=True)
    t.start()
    return srv
