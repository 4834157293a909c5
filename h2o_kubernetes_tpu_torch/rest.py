"""REST server of a scorer replica, on the PyTorch port.

Routes:

- ``GET /healthz`` — liveness (true through DRAINING);
- ``GET /readyz`` — readiness (SERVING ∧ breaker not open ∧ healthy);
- ``POST /3/ModelRegistry/load`` — load a MOJO-v2 tree artifact
  (``artifact_b64``, or a ``path`` read through ``persist.py``; optional
  ``sha256``, checked with a 409 on a mismatch, and ``warm_buckets``)
  under ``model_id``, warm it, then publish it;
- ``POST /3/Predictions/models/{key}`` — JSON rows in, predictions out;
- ``POST /3/Predictions/models/{key}/contributions`` — JSON rows in,
  per-row TreeSHAP contributions out.

Both prediction routes go through the micro-batcher (``ScoreBatcher``):
concurrent requests for the same (model, kind) within
``H2O_TPU_SCORE_BATCH_US`` coalesce into one device dispatch. Start a
server with ``start_server(port, host, device=None)``; ``device=None``
is the CUDA card.
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import sys
import threading
import time
import urllib.parse
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .runtime import health, lifecycle
from .runtime.backend import resolve_device
from .runtime.health import ClusterHealthError
from .runtime.lifecycle import CircuitOpenError, NodeDrainingError
from .runtime.retry import _env_float

__all__ = ["ScoreBatcher", "BATCHER", "MODELS", "REGISTRY_MODELS",
           "QueueFullError", "start_server"]


class QueueFullError(RuntimeError):
    """The scoring admission queue is full — load shed (REST: 429 +
    Retry-After) instead of queueing into latency collapse."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class _DeadlineExpired(Exception):
    """The request's X-H2O-Deadline-Ms budget ran out (REST: 504)."""


MODELS: dict[str, object] = {}           # model_id -> FlatTreeScorer
# model_id -> {name, version, algo, warmed_buckets, contributions,
#              loaded_at} for artifacts loaded over /3/ModelRegistry/load
REGISTRY_MODELS: dict[str, dict] = {}


# ---------------------------------------------------------------------------
# Scoring micro-batcher
# ---------------------------------------------------------------------------

def _row_cap(env: str) -> int:
    """A H2O_TPU_*_MAX_ROWS knob as an int cap; <= 0 or inf reads as
    uncapped. Never raises (it runs on the dispatcher thread)."""
    v = _env_float(env, 100_000.0)
    if not math.isfinite(v) or v <= 0:
        return sys.maxsize
    return max(1, int(v))


def _score_row_cap() -> int:
    return _row_cap("H2O_TPU_SCORE_MAX_ROWS")


def _contrib_row_cap() -> int:
    return _row_cap("H2O_TPU_CONTRIB_MAX_ROWS")


class _ScoreJob:
    __slots__ = ("model", "X", "offset", "event", "out", "err",
                 "deadline", "kind")

    def __init__(self, model, X, offset, kind="score"):
        self.model = model
        self.X = X
        self.offset = offset
        self.event = threading.Event()
        self.out = None
        self.err = None
        self.deadline = float("inf")
        self.kind = kind        # "score" | "contrib" (dispatch target)


class ScoreBatcher:
    """Collects concurrent scoring requests into per-(model, kind)
    batches: one padded device dispatch per group and window."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending: list[_ScoreJob] = []
        self._inflight: list[_ScoreJob] = []
        self._thread: threading.Thread | None = None
        self._stopped = False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="h2o-torch-score-batcher",
                daemon=True)
            self._thread.start()

    @staticmethod
    def _queue_max() -> int:
        """H2O_TPU_SCORE_QUEUE_MAX admission bound; <= 0 = unbounded."""
        v = _env_float("H2O_TPU_SCORE_QUEUE_MAX", 256.0)
        return sys.maxsize if v <= 0 else max(1, int(v))

    def submit(self, model, X: np.ndarray, offset=None,
               timeout: float | None = None,
               deadline: float | None = None,
               kind: str = "score") -> np.ndarray:
        """Enqueue one scoring request; blocks until its slice of the
        batched result (or raises: health/breaker/drain fail-fast,
        queue-full load shed, deadline, timeout). ``deadline`` is an
        absolute ``time.monotonic()`` instant."""
        if self._stopped or not lifecycle.accepting():
            raise NodeDrainingError(
                f"node {lifecycle.state()}: draining — new scoring "
                "requests are not admitted")
        if not health.healthy():
            raise ClusterHealthError(
                f"node unhealthy: {health.health_status()['error']} — "
                "scoring refused (fail-fast, not queued)")
        # an OPEN breaker rejects at the front door; check() never
        # claims the half-open probe slot (the dispatch does)
        lifecycle.BREAKER.check()
        if timeout is None:
            timeout = _env_float("H2O_TPU_SCORE_TIMEOUT", 60.0)
        job = _ScoreJob(model, X, offset, kind=kind)
        job.deadline = time.monotonic() + timeout
        if deadline is not None:
            job.deadline = min(job.deadline, deadline)
        wait_s = max(0.0, job.deadline - time.monotonic())
        with self._cond:
            if self._stopped or not lifecycle.accepting():
                raise NodeDrainingError(
                    f"node {lifecycle.state()}: draining — new scoring "
                    "requests are not admitted")
            qmax = self._queue_max()
            if len(self._pending) >= qmax:
                raise QueueFullError(
                    f"scoring admission queue is full "
                    f"({len(self._pending)} pending, "
                    f"H2O_TPU_SCORE_QUEUE_MAX={qmax}); "
                    "shed — retry with backoff", retry_after=1.0)
            self._ensure_thread()
            self._pending.append(job)
            self._cond.notify_all()
        if not job.event.wait(wait_s):
            if deadline is not None and time.monotonic() >= deadline:
                raise _DeadlineExpired(
                    "request deadline expired while queued in the "
                    "micro-batcher (X-H2O-Deadline-Ms) — dropped unscored")
            raise TimeoutError(
                f"scoring request timed out after {wait_s:.0f}s in "
                "the micro-batcher (H2O_TPU_SCORE_TIMEOUT / "
                "X-H2O-Deadline-Ms)")
        if job.err is not None:
            raise job.err
        return job.out

    def stop(self, timeout: float | None = 30.0) -> None:
        """Drain-path shutdown: refuse new submits, let the dispatcher
        flush everything already queued, then stop it. Jobs still
        pending past ``timeout`` are failed, never left hanging."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        with self._cond:
            leftovers, self._pending = self._pending, []
            stuck = [j for j in self._inflight if not j.event.is_set()]
        for job in leftovers + stuck:
            job.err = NodeDrainingError(
                "node draining: scoring request could not be flushed "
                "before the drain deadline")
            job.event.set()

    def reset(self) -> None:
        """Back to accepting; the dispatcher respawns on next submit."""
        with self._cond:
            self._stopped = False

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._pending:
                    return
            win = _env_float("H2O_TPU_SCORE_BATCH_US", 2000.0) / 1e6
            if win > 0 and not self._stopped:
                time.sleep(min(win, 1.0))    # collect concurrent arrivals
            with self._cond:
                batch, self._pending = self._pending, []
                self._inflight = batch
            self._dispatch(batch)
            with self._cond:
                self._inflight = []

    def _dispatch(self, batch: list[_ScoreJob]) -> None:
        now = time.monotonic()
        groups: dict[tuple, list[_ScoreJob]] = {}
        for job in batch:
            if now > job.deadline:
                job.err = TimeoutError("scoring request abandoned "
                                       "(client wait expired)")
                job.event.set()
                continue
            # kind in the key: score and contrib dispatches never mix
            groups.setdefault(
                (id(job.model), job.offset is not None, job.kind),
                []).append(job)
        # the per-request row cap also bounds the COALESCED dispatch
        cap = _score_row_cap()
        for jobs in groups.values():
            while jobs:
                rows = 0
                chunk = []
                while jobs and (not chunk
                                or rows + jobs[0].X.shape[0] <= cap):
                    rows += jobs[0].X.shape[0]
                    chunk.append(jobs.pop(0))
                self._score_group(chunk)

    def _score_group(self, jobs: list[_ScoreJob]) -> None:
        try:
            if not health.healthy():
                raise ClusterHealthError(
                    f"node unhealthy: {health.health_status()['error']} "
                    "— queued scoring request dropped (fail-fast)")
            model = jobs[0].model
            contrib = jobs[0].kind == "contrib"

            def dispatch(X, offset=None):
                if contrib:
                    return model.contrib_numpy(X)
                return model.score_numpy(X, offset=offset)

            if len(jobs) == 1:
                jobs[0].out = dispatch(jobs[0].X, offset=jobs[0].offset)
            else:
                X = np.concatenate([j.X for j in jobs])
                off = None
                if jobs[0].offset is not None:
                    off = np.concatenate([j.offset for j in jobs])
                out = dispatch(X, offset=off)
                lo = 0
                for j in jobs:
                    hi = lo + j.X.shape[0]
                    j.out = out[lo:hi]
                    lo = hi
        except BaseException as e:  # noqa: BLE001 — every waiter
            for j in jobs:          # must be released, whatever died
                j.err = e
        finally:
            for j in jobs:
                j.event.set()


BATCHER = ScoreBatcher()


def _request_deadline(headers) -> float | None:
    """Absolute monotonic deadline from X-H2O-Deadline-Ms (the client's
    REMAINING budget in ms), or None. Unparseable -> ValueError (400);
    already <= 0 -> _DeadlineExpired (504)."""
    raw = headers.get("X-H2O-Deadline-Ms")
    if raw is None:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"bad X-H2O-Deadline-Ms {raw!r} (want milliseconds)") \
            from None
    if ms <= 0:
        raise _DeadlineExpired(
            f"request deadline already expired (X-H2O-Deadline-Ms="
            f"{ms:g}) — rejected without a dispatch")
    return time.monotonic() + ms / 1000.0


def _rows_to_matrix(model, rows, columns=None):
    """JSON scoring payload -> [n, F] float32 in TRAINING value space.

    `rows` is a list of per-row dicts (col -> value) or a list of
    lists with `columns` naming their order. Enum levels map through
    the training domain (unseen/None -> NaN = NA)."""
    names = model.feature_names
    if not isinstance(rows, list) or not rows:
        raise ValueError("'rows' must be a non-empty list")
    if isinstance(rows[0], dict):
        missing = [n for n in names if n not in rows[0]]
        if missing:
            raise ValueError(f"missing feature column(s) {missing} "
                             "(send null for NA, not absence)")

        def get(r, name):
            # direct indexing: a LATER row omitting a feature must
            # reject (KeyError -> 400), not silently score it as NA
            return r[name]
    else:
        if not columns:
            raise ValueError(
                "list-shaped rows need 'columns' naming their order")
        pos = {c: i for i, c in enumerate(columns)}
        missing = [n for n in names if n not in pos]
        if missing:
            raise ValueError(f"missing feature column(s) {missing}")

        def get(r, name):
            return r[pos[name]]

    n = len(rows)
    X = np.empty((n, len(names)), dtype=np.float32)
    doms = getattr(model, "feature_domains", {}) or {}
    # domain->code LUTs are request-invariant: cached per model
    luts = model.__dict__.setdefault("_serving_luts", {})
    for j, name in enumerate(names):
        dom = doms.get(name)
        if dom is not None:
            lut = luts.get(name)
            if lut is None:
                lut = {d: float(i) for i, d in enumerate(dom)}
                luts[name] = lut
            X[:, j] = [lut.get(str(v), np.nan)
                       if (v := get(r, name)) is not None else np.nan
                       for r in rows]
        else:
            X[:, j] = [float(v) if (v := get(r, name)) is not None
                       else np.nan for r in rows]
    return X


def _definite(obj):
    """Recursively replace non-finite floats with None (JSON null)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _definite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_definite(v) for v in obj]
    return obj


def _ready_state() -> tuple[bool, list, dict]:
    st = lifecycle.status()
    reasons = []
    if st["state"] != lifecycle.SERVING:
        reasons.append(f"state={st['state']}")
    if st["breaker"]["state"] == "open":
        reasons.append("breaker=open")
    if not st["healthy"]:
        reasons.append("node unhealthy")
    return (not reasons), reasons, st


class _Handler(BaseHTTPRequestHandler):
    server_version = "h2o-torch-rest/1"

    def log_message(self, *a):       # quiet by default
        pass

    def _json(self, obj, code: int = 200, headers: dict | None = None):
        body = json.dumps(_definite(obj)).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str,
               retry_after: float | None = None):
        hdrs = None
        if retry_after is not None:
            hdrs = {"Retry-After": str(max(1, int(retry_after + 0.999)))}
        self._json({"__schema": "H2OErrorV3", "http_status": code,
                    "msg": msg}, code, headers=hdrs)

    def _discard_body(self) -> None:
        """Read and drop an unread body before an early error reply, so
        the client gets the response rather than a connection reset."""
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            return
        while n > 0:
            chunk = self.rfile.read(min(n, 1 << 20))
            if not chunk:
                break
            n -= len(chunk)

    def _params(self) -> dict:
        q = urllib.parse.urlparse(self.path).query
        out = {k: v[0] for k, v in urllib.parse.parse_qs(q).items()}
        ln = int(self.headers.get("Content-Length") or 0)
        if ln:
            raw = self.rfile.read(ln).decode()
            if "json" in self.headers.get("Content-Type", ""):
                body = json.loads(raw)
                if not isinstance(body, dict):
                    raise ValueError("JSON body must be an object")
                out.update(body)
            else:
                out.update({k: v[0] for k, v in
                            urllib.parse.parse_qs(raw).items()})
        return out

    # -- routes --------------------------------------------------------------

    def do_GET(self):
        path = urllib.parse.urlparse(self.path).path.rstrip("/")
        if path == "/healthz":
            st = lifecycle.status()
            if st["state"] == lifecycle.TERMINATED:
                return self._json({"alive": False, **st}, 503)
            return self._json({"alive": True, **st})
        if path == "/readyz":
            ready, reasons, st = _ready_state()
            if ready:
                return self._json({"ready": True, **st})
            return self._json({"ready": False, "reasons": reasons, **st},
                              503)
        return self._error(404, f"no route GET {path}")

    def do_POST(self):
        try:
            path = urllib.parse.urlparse(self.path).path.rstrip("/")
            if not lifecycle.accepting():
                self._discard_body()
                return self._error(
                    503, f"node {lifecycle.state()}: draining — not "
                    "accepting new work; route to a ready replica",
                    retry_after=lifecycle.remaining_drain_budget())
            try:
                params = self._params()
                deadline = _request_deadline(self.headers)
            except ValueError as e:
                return self._error(400, str(e))
            if not health.healthy():
                return self._error(
                    503, f"node unhealthy: "
                    f"{health.health_status()['error']}")
            if path == "/3/ModelRegistry/load":
                return self._registry_load(params)
            if path.startswith("/3/Predictions/models/"):
                rest = path[len("/3/Predictions/models/"):]
                contrib = rest.endswith("/contributions")
                if contrib:
                    rest = rest[: -len("/contributions")]
                mkey = urllib.parse.unquote(rest)
                if mkey not in MODELS:
                    return self._error(404, f"model '{mkey}' not found")
                if contrib:
                    return self._contrib_rows(MODELS[mkey], mkey, params,
                                              deadline)
                return self._score_rows(MODELS[mkey], mkey, params,
                                        deadline)
            return self._error(404, f"no route POST {path}")
        except _DeadlineExpired as e:
            return self._error(504, str(e))
        except QueueFullError as e:
            return self._error(429, str(e), retry_after=e.retry_after)
        except CircuitOpenError as e:
            return self._error(503, str(e), retry_after=e.retry_after)
        except (ClusterHealthError, TimeoutError) as e:
            return self._error(503, str(e))
        except Exception as e:  # noqa: BLE001 — a server bug is a 500
            return self._error(500, f"{type(e).__name__}: {e}")

    def _registry_load(self, params: dict):
        """POST /3/ModelRegistry/load: take the artifact (inline
        ``artifact_b64``, or a ``path`` read through ``persist``), check
        its ``sha256`` when given (409 on a mismatch), load it onto the
        server's device, warm every pow2 bucket (contributions too when
        the artifact supports them), and only then publish."""
        from . import persist
        from .operator.registry import load_artifact

        model_id = params.get("model_id")
        if not model_id or not isinstance(model_id, str):
            return self._error(400, "missing 'model_id'")
        b64 = params.get("artifact_b64")
        path = params.get("path")
        if b64:
            try:
                blob = base64.b64decode(b64, validate=True)
            except Exception:  # noqa: BLE001 — binascii detail useless
                return self._error(400, "bad 'artifact_b64' (not valid "
                                   "base64)")
        elif path:
            try:
                blob = persist.read_bytes(str(path))
            except FileNotFoundError:
                return self._error(404, f"artifact not found at {path!r}")
            except (NotImplementedError, ValueError) as e:
                return self._error(400, str(e))
        else:
            return self._error(400, "need 'path' (persist-readable "
                               "artifact) or 'artifact_b64'")
        want_sha = params.get("sha256")
        if want_sha:
            got = hashlib.sha256(blob).hexdigest()
            if got != str(want_sha):
                return self._error(
                    409, f"artifact digest mismatch (got {got[:12]}, "
                    f"registry says {str(want_sha)[:12]}) — refusing "
                    "to serve a corrupted model")
        try:
            model = load_artifact(blob, device=self.server.device)
        except (ValueError, KeyError) as e:
            return self._error(400, f"unservable artifact: {e}")
        except Exception as e:  # noqa: BLE001 — zip/npz parse errors
            return self._error(400, f"unservable artifact: {e!r}")
        warm_contrib = model.contrib_support() is None
        try:
            warmed = model.warm_up(params.get("warm_buckets"),
                                   contributions=warm_contrib)
        except ValueError as e:
            return self._error(400, str(e))
        MODELS[model_id] = model
        REGISTRY_MODELS[model_id] = {
            "name": params.get("name"),
            "version": params.get("version"),
            "algo": model.algo,
            "warmed_buckets": warmed,
            "contributions": warm_contrib,
            "loaded_at": time.time(),
        }
        return self._json({"model_id": {"name": model_id},
                           "name": params.get("name"),
                           "version": params.get("version"),
                           "algo": model.algo,
                           "device": str(model.device),
                           "warmed_buckets": warmed,
                           "contributions": warm_contrib})

    def _score_rows(self, model, mkey: str, params: dict, deadline):
        """POST /3/Predictions/models/{key}: JSON rows in, predictions
        out, one micro-batched dispatch."""
        rows = params.get("rows")
        if rows is None:
            return self._error(400, "missing 'rows' (JSON list of "
                               "row dicts, or lists + 'columns')")
        max_rows = _score_row_cap()
        if isinstance(rows, list) and len(rows) > max_rows:
            return self._error(
                413, f"{len(rows)} rows exceeds the per-request limit "
                f"of {max_rows} (H2O_TPU_SCORE_MAX_ROWS); split the "
                "batch")
        off = None
        oc = getattr(model, "offset_column", None)
        try:
            X = _rows_to_matrix(model, rows, params.get("columns"))
            if oc:
                if not isinstance(rows[0], dict):
                    raise ValueError(f"offset column '{oc}' needs "
                                     "dict-shaped rows")
                off = np.asarray(
                    [float(r[oc]) if r[oc] is not None else np.nan
                     for r in rows], dtype=np.float32)
        except (ValueError, TypeError, KeyError, IndexError) as e:
            return self._error(400, f"bad scoring payload: {e!r}")
        out = BATCHER.submit(model, X, offset=off, deadline=deadline)
        resp: dict = {"model_id": {"name": mkey}, "rows": len(rows)}
        if getattr(model, "nclasses", 1) > 1:
            dom = model.response_domain or \
                [str(i) for i in range(model.nclasses)]
            labels = out.argmax(axis=1)
            resp["predict"] = [dom[int(i)] for i in labels]
            for k, name in enumerate(dom):
                resp[f"p{name}"] = [float(v) for v in out[:, k]]
        else:
            resp["predict"] = [float(v) for v in np.asarray(out)]
        return self._json(resp)

    def _contrib_rows(self, model, mkey: str, params: dict, deadline):
        """POST /3/Predictions/models/{key}/contributions: per-row
        TreeSHAP, [rows, F+1] with the bias term last. Every
        precondition failure is a clean 400."""
        reason = model.contrib_support()
        if reason:
            return self._error(
                400, f"contributions unavailable for model '{mkey}': "
                f"{reason}")
        rows = params.get("rows")
        if rows is None:
            return self._error(400, "missing 'rows' (JSON list of "
                               "row dicts, or lists + 'columns')")
        max_rows = _contrib_row_cap()
        if isinstance(rows, list) and len(rows) > max_rows:
            return self._error(
                413, f"{len(rows)} rows exceeds the per-request limit "
                f"of {max_rows} (H2O_TPU_CONTRIB_MAX_ROWS); split the "
                "batch")
        try:
            X = _rows_to_matrix(model, rows, params.get("columns"))
        except (ValueError, TypeError, KeyError, IndexError) as e:
            return self._error(400, f"bad contributions payload: {e!r}")
        out = BATCHER.submit(model, X, deadline=deadline, kind="contrib")
        return self._json({
            "model_id": {"name": mkey}, "rows": len(rows),
            "columns": list(model.feature_names) + ["BiasTerm"],
            "contributions": [[float(v) for v in row] for row in out]})


class _Server(ThreadingHTTPServer):
    def __init__(self, addr, handler, device):
        super().__init__(addr, handler)
        self.device = device


_SERVERS: "weakref.WeakSet[_Server]" = weakref.WeakSet()


def _shutdown_servers() -> None:
    """Drain-path hook: stop every live server's accept loop and close
    its listening socket."""
    for srv in list(_SERVERS):
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:  # noqa: BLE001 — drain must not die on one
            pass
        _SERVERS.discard(srv)


def start_server(port: int = 54321, host: str = "127.0.0.1",
                 device=None, background: bool = True,
                 install_signals: bool = False) -> ThreadingHTTPServer:
    """Start the REST server (``port=0`` picks a free port; read it
    from ``server_address``). Artifacts loaded through it live on
    ``device`` (None = the CUDA card; raises without one unless
    ``device="cpu"``). The node goes SERVING, and the server's shutdown
    is registered on the drain path."""
    dev = resolve_device(device)
    srv = _Server((host, port), _Handler, dev)
    lifecycle.mark_serving()
    _SERVERS.add(srv)
    lifecycle.register_shutdown(_shutdown_servers)
    if install_signals:
        lifecycle.install_sigterm(exit_on_drain=True)
    if background:
        threading.Thread(target=srv.serve_forever, name="h2o-torch-rest",
                         daemon=True).start()
    else:
        srv.serve_forever()
    return srv
