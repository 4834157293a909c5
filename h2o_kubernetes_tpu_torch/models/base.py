"""The serving surface of a model: ``score_numpy``, ``contrib_numpy``
and ``warm_up``, over a per-model cache of device tensors.

A model keeps its host state (numpy arrays) and builds its device
state — the flattened trees, the TreeSHAP path tables and pattern
tables — once, on its device, the first time it scores. The cache
counts hits and misses per model and process-wide: a miss is a call
that had to build device state, so warm serving adds only hits.

Batches are padded to power-of-two buckets (``_batch_bucket``) and
contributions are dispatched in chunks of ``_contrib_chunk()`` rows,
the JAX package's serving shapes.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

__all__ = ["Model", "scorer_cache_stats", "model_scorer_counters"]

_SCORE_MIN_BATCH = 128          # smallest padded-batch bucket

_SCORER_STATS = {"hits": 0, "misses": 0, "models": 0}
# guards device-state creation + stats: an HTTP handler thread and the
# REST micro-batcher thread can first-score one model concurrently
_SCORER_LOCK = threading.Lock()


def scorer_cache_stats() -> dict[str, int]:
    """Process-wide device-state cache counters: ``misses`` counts
    calls that built a model's device state, ``hits`` calls that found
    it, ``models`` the models that built one."""
    with _SCORER_LOCK:
        return dict(_SCORER_STATS)


def model_scorer_counters(model) -> dict[str, int]:
    """Per-model cache counters (hits/misses)."""
    return dict(model.__dict__.get("_scorer_counters")
                or {"hits": 0, "misses": 0})


def _batch_bucket(n: int) -> int:
    """Next power-of-two batch size >= max(n, _SCORE_MIN_BATCH)."""
    b = _SCORE_MIN_BATCH
    while b < n:
        b *= 2
    return b


class Model:
    """Serving surface shared by servable models. Subclasses set
    ``feature_names``, ``nclasses``, ``device`` and implement
    ``_serving_prepare``/``_score_matrix`` (and the contribution
    hooks)."""

    algo = "base"

    # -- device-state cache -------------------------------------------------

    def _serving_prepare(self):
        """Hook: build (or fetch) the model's device state; returns it."""
        raise NotImplementedError

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        raise NotImplementedError

    def _cached(self, kind: str) -> None:
        """Make sure the device state for ``kind`` ("score" or
        "contrib") exists, counting a cache hit or a miss."""
        with _SCORER_LOCK:
            ctr = self.__dict__.setdefault("_scorer_counters",
                                           {"hits": 0, "misses": 0})
            key = "_shap_tables" if kind == "contrib" else "_flat_trees"
            if self.__dict__.get(key) is not None:
                ctr["hits"] += 1
                _SCORER_STATS["hits"] += 1
            else:
                if not (ctr["hits"] or ctr["misses"]):
                    _SCORER_STATS["models"] += 1
                ctr["misses"] += 1
                _SCORER_STATS["misses"] += 1
        # built outside the lock (a first contributions call builds the
        # path tables on the host): racing first calls of one model
        # build the same state twice, and other models are not held up
        self._serving_prepare()
        if kind == "contrib":
            self._contrib_prepare()

    # -- TreeSHAP contributions --------------------------------------------

    def contrib_support(self) -> "str | None":
        """None when this model can serve per-row TreeSHAP
        contributions, else the actionable precondition message."""
        return (f"model '{self.algo}' does not support "
                "predict_contributions (tree ensembles only)")

    def _shap_sources(self):
        """Hook: (FlatTrees numpy, flat cover numpy) for the path tables."""
        raise NotImplementedError

    def _contrib_enum_mask(self) -> torch.Tensor:
        """Hook: the device enum mask contributions canonicalize with."""
        raise NotImplementedError

    def _contrib_scale_init(self) -> tuple[float, float]:
        """Hook: (scale, init) applied to the raw kernel output."""
        raise NotImplementedError

    def _contrib_prepare(self):
        """Build (or fetch) the device TreeSHAP state: per-group path
        tables plus — within the per-model byte budget — each group's
        pattern table. The host numpy copies are kept separately and
        built once."""
        st = self.__dict__.get("_shap_tables")
        ct = self.__dict__.get("_shap_ctab")
        if st is not None and ct is not None:
            return st, ct
        stn = self.__dict__.get("_shap_tables_np")
        if stn is None:
            from .tree.shap import (_PATTERN_TABLE_MAX_BYTES,
                                    build_shap_table_groups,
                                    pattern_table)

            flat, cover = self._shap_sources()
            stn = build_shap_table_groups(flat, cover)
            self._shap_tables_np = stn
            # per-group pattern tables against ONE shared per-model byte
            # budget (a group past the remainder runs the DP path)
            remaining = _PATTERN_TABLE_MAX_BYTES
            ctabs = []
            for g in stn:
                c = pattern_table(g, budget=remaining)
                if c is not None:
                    remaining -= c.nbytes
                ctabs.append(c)
            self._shap_ctab_np = ctabs
        from .tree.shap import ShapTables

        dev = self.device
        st = [ShapTables(*(torch.as_tensor(a, device=dev) for a in g))
              for g in stn]
        ct = [None if c is None else torch.as_tensor(c, device=dev)
              for c in self.__dict__["_shap_ctab_np"]]
        self._shap_ctab = ct
        self._shap_tables = st
        return st, ct

    def _contrib_matrix(self, X: torch.Tensor) -> torch.Tensor:
        """[rows, F+1] contributions on raw features: each depth group
        into its own fresh output, summed in ascending-D order, then
        scaled, then init added to the bias column. A group with a
        pattern table goes through ``flat_shap_tab_kernel`` (the CUDA
        kernel on a CUDA device); one without takes the plain DP path."""
        from ..ops.shap_kernel import flat_shap_tab_kernel
        from .tree.shap import flat_shap

        groups, ctabs = self._contrib_prepare()
        em = self._contrib_enum_mask()
        phi = None
        for g, ct in zip(groups, ctabs):
            if ct is None:
                p = flat_shap(g, X, em)
            else:
                p = flat_shap_tab_kernel(g, ct, X, em)
            phi = p if phi is None else phi + p
        scale, init = self._contrib_scale_init()
        phi = phi * float(np.float32(scale))
        phi[:, -1] += float(np.float32(init))
        return phi

    def _contrib_chunk(self) -> int:
        """Rows per TreeSHAP device dispatch: H2O_TPU_CONTRIB_CHUNK
        (default 16384) floored to a power of two, shrunk for
        deep/wide ensembles so [rows × leaves × depth] stays bounded."""
        try:
            cap = int(float(os.environ.get("H2O_TPU_CONTRIB_CHUNK",
                                           "16384")))
        except ValueError:
            cap = 16384
        cap = max(_SCORE_MIN_BATCH, cap)
        c = _SCORE_MIN_BATCH
        while c * 2 <= cap:
            c *= 2
        cap = c
        stn = self.__dict__.get("_shap_tables_np")
        if stn:
            ld = max(g.feat.shape[1] * g.feat.shape[2] for g in stn)
            fit = max((1 << 24) // max(ld, 1), _SCORE_MIN_BATCH)
            while cap > _SCORE_MIN_BATCH and cap > fit:
                cap //= 2
        return cap

    def contrib_numpy(self, X) -> np.ndarray:
        """Serving entry for per-row TreeSHAP contributions: raw [n, F]
        ndarray (training value space, enum codes / NaN NAs) -> [n, F+1]
        float32 contributions, last column the bias term — additive to
        the raw margin. Batches are chunked to ``_contrib_chunk()``
        rows, each padded to its pow2 bucket, under the circuit breaker
        and the device guard."""
        from ..runtime.health import device_dispatch, require_healthy
        from ..runtime.lifecycle import breaker_guard

        reason = self.contrib_support()
        if reason:
            raise ValueError(reason)
        require_healthy()
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2 or X.shape[1] != len(self.feature_names):
            raise ValueError(
                f"contrib_numpy expects [n, {len(self.feature_names)}] "
                f"(features {self.feature_names}), got {X.shape}")
        n = X.shape[0]
        if n == 0:
            raise ValueError("contrib_numpy: empty batch")
        with breaker_guard("contributions scoring"), \
                device_dispatch("contributions scoring", locking=False):
            self._cached("contrib")
            chunk = self._contrib_chunk()
            outs = []
            for s in range(0, n, chunk):
                xs = X[s:s + chunk]
                b = _batch_bucket(xs.shape[0])
                if b != xs.shape[0]:
                    Xp = np.zeros((b, X.shape[1]), dtype=np.float32)
                    Xp[: xs.shape[0]] = xs
                else:
                    Xp = xs
                out = self._contrib_matrix(
                    torch.as_tensor(Xp, device=self.device))
                outs.append(out[: xs.shape[0]])
            out = outs[0] if len(outs) == 1 else torch.cat(outs)
            return out.contiguous().cpu().numpy()

    # -- scoring -------------------------------------------------------------

    def warm_up(self, buckets=None, contributions: bool = False
                ) -> list[int]:
        """Run the serving path once at every pow2 batch bucket up to
        the largest requested one (128, 256, ... top), so device state
        is built and the kernel library loaded before a replica's
        ``/readyz`` flips. ``buckets=None`` reads
        ``H2O_TPU_POOL_WARM_BUCKETS`` (default ``128,1024``). Returns
        the bucket sizes warmed, ascending."""
        if buckets is None:
            raw = os.environ.get("H2O_TPU_POOL_WARM_BUCKETS", "128,1024")
            buckets = [b for b in raw.replace(" ", "").split(",") if b]
        elif isinstance(buckets, (str, bytes)):
            raise ValueError(
                f"warm-up buckets must be a list of ints, got the "
                f"string {buckets!r}")
        try:
            top = max(_batch_bucket(int(b)) for b in buckets)
            if min(int(b) for b in buckets) < 1:
                raise ValueError
        except (TypeError, ValueError):
            raise ValueError(
                f"bad warm-up bucket list {buckets!r} (want positive "
                "ints, e.g. 128,1024)") from None
        padded, b = [], _SCORE_MIN_BATCH
        while b <= top:
            padded.append(b)
            b *= 2
        F = len(self.feature_names)
        need_off = bool(getattr(self, "offset_column", None))
        for b in padded:
            X = np.zeros((b, F), dtype=np.float32)
            off = np.zeros(b, dtype=np.float32) if need_off else None
            self.score_numpy(X, offset=off)
        if contributions:
            reason = self.contrib_support()
            if reason:
                raise ValueError(reason)
            done: set[int] = set()
            for b in padded:
                be = min(b, self._contrib_chunk())
                if be in done:
                    continue
                done.add(be)
                self.contrib_numpy(np.zeros((be, F), dtype=np.float32))
        return padded

    def score_numpy(self, X, offset=None) -> np.ndarray:
        """Serving entry: raw [n, F] ndarray (training value space,
        enum codes / NaN NAs) -> [n, K] probabilities or [n]
        predictions. Rows are padded to a power-of-two bucket; the
        dispatch runs under the serving circuit breaker and the device
        guard."""
        from ..runtime.health import device_dispatch, require_healthy
        from ..runtime.lifecycle import breaker_guard

        require_healthy()
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2 or X.shape[1] != len(self.feature_names):
            raise ValueError(
                f"score_numpy expects [n, {len(self.feature_names)}] "
                f"(features {self.feature_names}), got {X.shape}")
        n = X.shape[0]
        if n == 0:
            raise ValueError("score_numpy: empty batch")
        if getattr(self, "offset_column", None) and offset is None:
            raise ValueError(
                f"this model was trained with offset_column="
                f"'{self.offset_column}'; pass offset= per row")
        b = _batch_bucket(n)
        if b != n:
            Xp = np.zeros((b, X.shape[1]), dtype=np.float32)
            Xp[:n] = X
        else:
            Xp = X
        offp = None
        if offset is not None:
            offset = np.asarray(offset, dtype=np.float32).reshape(-1)
            if offset.shape[0] != n:
                raise ValueError(
                    f"offset has {offset.shape[0]} rows, X has {n}")
            offp = np.zeros(b, dtype=np.float32)
            offp[:n] = offset
            offp = torch.as_tensor(offp, device=self.device)
        with breaker_guard("model scoring"), \
                device_dispatch("model scoring", locking=False):
            self._cached("score")
            out = self._score_matrix(
                torch.as_tensor(Xp, device=self.device), offp)
            return out[:n].cpu().numpy()
