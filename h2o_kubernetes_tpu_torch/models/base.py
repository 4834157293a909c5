"""Model plumbing: training inputs resolved from a Frame
(``TrainData``, ``resolve_xy``), and the surface every model shares —
``predict``/``model_performance``/``confusion_matrix``/``partial_plot``
on a Frame (the metrics through ``score_predictions``, which
cross-validation shares), the ``cross_validation_*`` accessors, and the
serving entries
``score_numpy``, ``contrib_numpy`` and ``warm_up`` over a per-model
cache of device tensors.

A model keeps its host state (numpy arrays) and builds its device
state — the flattened trees, the TreeSHAP path tables and pattern
tables — once, on its device, the first time it scores. The cache
counts hits and misses per model and process-wide: a miss is a call
that had to build device state, so warm serving adds only hits.

Scoring batches are padded to power-of-two buckets (``_batch_bucket``).
Contributions follow ``contrib_dispatch``: on a CUDA device whose depth
groups all have pattern tables the kernel takes the whole batch,
unpadded; elsewhere the JAX package's serving shapes (chunks of
``_contrib_chunk()`` rows, each padded to its bucket).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

__all__ = ["Model", "TrainData", "resolve_xy", "scorer_cache_stats",
           "model_scorer_counters", "contrib_dispatch",
           "score_predictions"]

_SCORE_MIN_BATCH = 128          # smallest padded-batch bucket
_CONTRIB_CHUNK = 16384          # default rows per chunk of the JAX rule
# device bytes of the [rows, F+1] float32 outputs a whole-batch
# contributions dispatch may hold at once: a group's output, the running
# sum over groups and its scaled copy
_CONTRIB_OUT_BYTES = 1 << 30
_CONTRIB_OUT_COPIES = 3

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


@dataclass
class TrainData:
    """Training inputs resolved from a Frame, on the frame's device. The
    tree learners bin straight from the Frame's columns, so there is no
    float design matrix here."""

    feature_names: list[str]
    y: torch.Tensor              # [rows] float32 (class id for enums)
    w: torch.Tensor              # [rows] float32 weights, 0 = dropped
    nrows: int
    nclasses: int                # 1 for regression
    response_domain: list[str] | None
    distribution: str
    feature_domains: dict[str, list[str]] = field(default_factory=dict)
    offset: torch.Tensor | None = None   # [rows] float32, 0 where NA


def resolve_xy(frame, y: str, x: Sequence[str] | None = None,
               ignored: Sequence[str] | None = None,
               weights_column: str | None = None,
               distribution: str = "auto",
               offset_column: str | None = None) -> TrainData:
    """Resolve and validate the response, features, weights and offset;
    infer the distribution from the response (2 levels: bernoulli, more:
    multinomial, numeric: gaussian). Rows with an NA response or offset
    get weight 0."""
    if y not in frame:
        raise ValueError(f"response column '{y}' not in frame")
    ignored = set(ignored or []) | {y}
    for col, what in ((weights_column, "weights"),
                      (offset_column, "offset")):
        if col:
            if col not in frame:
                raise ValueError(f"{what} column '{col}' not in frame")
            if frame.vec(col).is_enum():
                raise ValueError(f"{what} column '{col}' must be numeric")
            ignored.add(col)
    names = list(x) if x else [n for n in frame.names if n not in ignored]
    if x and ignored.intersection(names):
        raise ValueError(
            f"column(s) {sorted(ignored.intersection(names))} are the "
            "response/weights/offset or ignored_columns and cannot also "
            "be features (remove them from x)")
    for n in names:
        if n not in frame:
            raise ValueError(f"feature column '{n}' not in frame")
    yv = frame.vec(y)
    nclasses, domain = 1, None
    if yv.is_enum():
        domain = yv.domain
        nclasses = yv.cardinality()
        if nclasses < 2:
            raise ValueError(f"response '{y}' has {nclasses} classes")
    if distribution == "auto":
        distribution = "bernoulli" if nclasses == 2 else \
            "multinomial" if nclasses > 2 else "gaussian"
    if distribution in ("bernoulli", "multinomial") and nclasses == 1:
        raise ValueError(f"{distribution} needs a categorical response; "
                         f"'{y}' is numeric")
    y_arr = yv.as_float()
    w = torch.ones_like(y_arr)
    if weights_column:
        w = w * frame.vec(weights_column).as_float()
    w = torch.where(torch.isnan(y_arr), 0.0, w)
    off = None
    if offset_column:
        off = frame.vec(offset_column).as_float()
        w = torch.where(torch.isnan(off), 0.0, w)
        off = torch.nan_to_num(off)
    fdoms = {n: list(frame.vec(n).domain) for n in names
             if frame.vec(n).is_enum()}
    return TrainData(names, torch.nan_to_num(y_arr), w, frame.nrows,
                     nclasses, domain, distribution, fdoms, off)


def _batch_bucket(n: int) -> int:
    """Next power-of-two batch size >= max(n, _SCORE_MIN_BATCH)."""
    b = _SCORE_MIN_BATCH
    while b < n:
        b *= 2
    return b


def _pow2_cap(cap: int) -> int:
    """``cap`` floored to a power of two, at least _SCORE_MIN_BATCH."""
    c = _SCORE_MIN_BATCH
    while c * 2 <= cap:
        c *= 2
    return c


def contrib_dispatch(device_type: str,
                     groups: "Sequence[tuple[int, int, bool]]",
                     cap: "int | None", n_features: int
                     ) -> tuple[int, bool]:
    """(rows per TreeSHAP dispatch, pad each dispatch to its pow2
    bucket) for a model on ``device_type`` whose depth groups are
    ``(leaves, depth, has a pattern table)``; ``cap`` is
    H2O_TPU_CONTRIB_CHUNK, None when unset.

    On a CUDA device where every group has a pattern table the kernel
    has no per-row transient and nothing is traced, so it takes the
    whole batch, unpadded: only the cap, when set, and the device bytes
    of the [rows, F+1] outputs cut it. Elsewhere (the CPU, or a group
    on the DP path, whose [L, D, rows] transients are real) the JAX
    package's rule: chunks of the cap (default 16384), shrunk until
    rows × L × D ≤ 2^24, each padded to its bucket. Rows are
    independent, so both give the same bits."""
    if device_type == "cuda" and all(tab for _, _, tab in groups):
        rows = max(_SCORE_MIN_BATCH, _CONTRIB_OUT_BYTES // (
            _CONTRIB_OUT_COPIES * 4 * (n_features + 1)))
        if cap is not None:
            rows = min(rows, _pow2_cap(cap))
        return rows, False
    chunk = _pow2_cap(_CONTRIB_CHUNK if cap is None else cap)
    ld = max((L * D for L, D, _ in groups), default=0)
    if ld:
        fit = max((1 << 24) // ld, _SCORE_MIN_BATCH)
        while chunk > _SCORE_MIN_BATCH and chunk > fit:
            chunk //= 2
    return chunk, True


class Model:
    """Serving surface shared by servable models. Subclasses set
    ``feature_names``, ``nclasses``, ``device`` and implement
    ``_serving_prepare``/``_score_matrix`` (and the contribution
    hooks)."""

    algo = "base"
    # the attribute whose presence marks the scoring device state built
    _score_state = "_flat_trees"
    # models/cv.CVResult when trained with nfolds (models/cv.py)
    cv = None

    # -- cross-validation accessors (h2o-py's cross_validation_*) -----------

    def cross_validation_models(self):
        return self.cv.models if self.cv else None

    def cross_validation_holdout_predictions(self) -> "np.ndarray | None":
        """The holdout predictions as numpy (they live on the frame's
        device)."""
        if self.cv is None or self.cv.holdout_predictions is None:
            return None
        return self.cv.holdout_predictions.cpu().numpy()

    def cross_validation_metrics(self) -> "dict[str, float] | None":
        return self.cv.metrics if self.cv else None

    def cross_validation_metrics_summary(self):
        return self.cv.metrics_summary if self.cv else None

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
            key = "_shap_tables" if kind == "contrib" else \
                self._score_state
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
        from ..ops.shap_kernel import pack_slots
        from .tree.shap import ShapTables

        dev = self.device
        st = [ShapTables(*(torch.as_tensor(a, device=dev) for a in g))
              for g in stn]
        ct = [None if c is None else torch.as_tensor(c, device=dev)
              for c in self.__dict__["_shap_ctab_np"]]
        # the kernel's 16-byte slot records, once per model; set before
        # the tables, whose presence marks the state built
        self._shap_slots = [None if c is None else pack_slots(g)
                            for g, c in zip(st, ct)]
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
        slots = self.__dict__["_shap_slots"]
        em = self._contrib_enum_mask()
        phi = None
        for g, ct, sl in zip(groups, ctabs, slots):
            if ct is None:
                p = flat_shap(g, X, em)
            else:
                p = flat_shap_tab_kernel(g, ct, X, em, slots=sl)
            phi = p if phi is None else phi + p
        scale, init = self._contrib_scale_init()
        phi = phi * float(np.float32(scale))
        phi[:, -1] += float(np.float32(init))
        return phi

    def _contrib_dispatch(self) -> tuple[int, bool]:
        """``contrib_dispatch`` for this model (its groups as built by
        ``_contrib_prepare``) under H2O_TPU_CONTRIB_CHUNK, read now."""
        raw = os.environ.get("H2O_TPU_CONTRIB_CHUNK")
        cap = None
        if raw is not None:
            try:
                cap = int(float(raw))
            except ValueError:
                cap = _CONTRIB_CHUNK
        stn = self.__dict__.get("_shap_tables_np") or []
        cts = self.__dict__.get("_shap_ctab_np") or [None] * len(stn)
        groups = [(g.feat.shape[1], g.feat.shape[2], c is not None)
                  for g, c in zip(stn, cts)]
        return contrib_dispatch(self.device.type, groups, cap,
                                len(self.feature_names))

    def _contrib_chunk(self) -> int:
        """Rows per TreeSHAP dispatch (``_contrib_dispatch``)."""
        return self._contrib_dispatch()[0]

    def contrib_numpy(self, X) -> np.ndarray:
        """Serving entry for per-row TreeSHAP contributions: raw [n, F]
        ndarray (training value space, enum codes / NaN NAs) -> [n, F+1]
        float32 contributions, last column the bias term — additive to
        the raw margin. Batches are dispatched as ``contrib_dispatch``
        says (the whole batch on a CUDA device whose groups all have
        pattern tables; else chunks, each padded to its pow2 bucket),
        under the circuit breaker and the device guard."""
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
            chunk, pad = self._contrib_dispatch()
            outs = []
            for s in range(0, n, chunk):
                xs = X[s:s + chunk]
                b = _batch_bucket(xs.shape[0]) if pad else xs.shape[0]
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
        ``/readyz`` flips; with ``contributions``, contributions too:
        once at the top bucket where the whole batch goes to the
        kernel, else at each chunk size. ``buckets=None`` reads
        ``H2O_TPU_POOL_WARM_BUCKETS`` (default ``128,1024``). Returns
        the scoring bucket sizes warmed, ascending."""
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
            # the whole-batch dispatch launches the same kernels at any
            # row count: one call warms them; chunks warm each size
            self._cached("contrib")
            chunk, pad = self._contrib_dispatch()
            sizes = {min(b, chunk) for b in padded} if pad else {top}
            for be in sorted(sizes):
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

    # -- Frame surface ---------------------------------------------------------

    def _design_matrix(self, frame) -> torch.Tensor:
        """[rows, F] float32 on the model's device, in TRAINING value
        space: enum codes of a scoring frame are remapped to the
        training domain (unseen levels -> NA)."""
        cols = []
        for name in self.feature_names:
            v = frame.vec(name)
            tdom = self.feature_domains.get(name)
            if (tdom is not None) != v.is_enum():
                raise ValueError(
                    f"column '{name}' is {v.kind} in the scoring frame "
                    "but was not at training time")
            if tdom is not None and list(v.domain) != list(tdom):
                lut = {d: i for i, d in enumerate(tdom)}
                perm = torch.as_tensor(
                    [lut.get(d, -1) for d in v.domain] + [-1],
                    dtype=torch.int64, device=v.device)  # last slot = NA
                idx = torch.where(v.data < 0, len(v.domain), v.data)
                remap = perm[idx.long()]
                cols.append(torch.where(remap < 0, float("nan"),
                                        remap.float()))
            else:
                cols.append(v.as_float())
        return torch.stack(cols, dim=1).to(self.device)

    def _predict_device(self, frame) -> torch.Tensor:
        """[n, K] class probabilities, or [n] regression predictions, on
        the model's device."""
        return self._score_matrix(self._design_matrix(frame),
                                  self._offset_of(frame))

    def predict_raw(self, frame) -> np.ndarray:
        """[n, K] class probabilities, or [n] regression predictions."""
        return self._predict_device(frame).cpu().numpy()

    def predict(self, frame):
        """H2O-style prediction frame: ``predict`` (+ per-class probs),
        on the CPU."""
        from ..frame import Frame, Vec

        out = self.predict_raw(frame)
        if self.nclasses == 1:
            return Frame.from_arrays({"predict": out}, device="cpu")
        dom = self.response_domain or [str(i) for i in
                                       range(self.nclasses)]
        pf = Frame.from_arrays(
            {"predict": out.argmax(axis=1).astype(np.int32)},
            domains={"predict": dom}, device="cpu")
        for k, name in enumerate(dom):
            pf[f"p{name}"] = Vec.from_numpy(out[:, k], device="cpu")
        return pf

    def _offset_of(self, frame) -> "torch.Tensor | None":
        """The frame's offset column on the model's device, or None when
        the model has no offset."""
        if not getattr(self, "offset_column", None):
            return None
        if self.offset_column not in frame:
            raise ValueError(
                f"this model was trained with offset_column="
                f"'{self.offset_column}' which is missing from the "
                "scoring frame")
        return frame.vec(self.offset_column).as_float().to(self.device)

    def partial_plot(self, frame, cols: Sequence[str], nbins: int = 20,
                     plot: bool = False) -> list:
        """Partial dependence: per column, set it to each value of a
        grid for every row and record the mean, standard deviation and
        standard error of the model's response (the positive-class
        probability, or the prediction). Enum columns sweep their
        training levels, numeric ones ``nbins`` quantiles. One CPU
        Frame per column; ``plot`` is accepted and ignored."""
        from ..frame import Frame, Vec

        if self.nclasses > 2:
            raise ValueError("partial_plot supports binomial and "
                             "regression models only")
        del plot
        n = frame.nrows
        X = self._design_matrix(frame)
        off = self._offset_of(frame)
        out_frames = []
        for col in cols:
            if col not in self.feature_names:
                raise ValueError(
                    f"partial_plot: '{col}' is not a model feature")
            j = self.feature_names.index(col)
            tdom = self.feature_domains.get(col)
            if tdom is not None:
                grid, labels = list(range(len(tdom))), list(tdom)
            else:
                x = frame.vec(col).to_numpy()
                finite = x[~np.isnan(x)]
                if finite.size == 0:
                    raise ValueError(f"partial_plot: '{col}' is all-NA")
                grid = list(np.unique(np.quantile(
                    finite, np.linspace(0, 1, nbins))))
                labels = None
            means, sds, sems = [], [], []
            for gv in grid:
                Xg = X.clone()
                Xg[:, j] = float(gv)
                pred = self._score_matrix(Xg, off).cpu().numpy()
                resp = pred[:, 1] if self.nclasses == 2 else pred
                means.append(float(np.mean(resp)))
                sds.append(float(np.std(resp, ddof=1)) if n > 1 else 0.0)
                sems.append(sds[-1] / np.sqrt(n))
            pd_out = Frame()
            if labels is not None:
                pd_out[col] = Vec.from_numpy(
                    np.arange(len(grid), dtype=np.int32), col,
                    domain=labels, device="cpu")
            else:
                pd_out[col] = Vec.from_numpy(
                    np.asarray(grid, dtype=np.float32), col, device="cpu")
            for name, vals in (("mean_response", means),
                               ("stddev_response", sds),
                               ("std_error_mean_response", sems)):
                pd_out[name] = Vec.from_numpy(
                    np.asarray(vals, dtype=np.float32), name, device="cpu")
            out_frames.append(pd_out)
        return out_frames

    def confusion_matrix(self, frame, y: str,
                         threshold: float | None = None) -> np.ndarray:
        """Confusion matrix, rows actual and columns predicted: binomial
        2x2 at ``threshold`` (the F1-optimal one when None), multinomial
        KxK argmax counts."""
        from .. import metrics as M

        yv = frame.vec(y)
        preds = self.predict_raw(frame)
        codes = yv.to_numpy()
        if self.nclasses == 2:
            ok = codes >= 0 if yv.is_enum() else ~np.isnan(codes)
            return M.confusion_matrix(codes[ok], preds[ok][:, 1],
                                      threshold=threshold)
        if self.nclasses > 2:
            ok = codes >= 0
            lab = preds[ok].argmax(axis=1)
            K = self.nclasses
            cm = np.zeros((K, K))
            np.add.at(cm, (codes[ok].astype(int), lab), 1.0)
            return cm
        raise ValueError("confusion_matrix needs a classification model")

    def model_performance(self, frame, y: str) -> dict[str, float]:
        """Metrics of this model on ``frame``'s response ``y`` (rows with
        an NA response dropped), from ``score_predictions``: scores,
        response and metrics stay on the model's device."""
        out = self._predict_device(frame)
        yt = frame.vec(y).as_float().to(self.device)   # enum NA -> NaN
        ok = ~torch.isnan(yt)
        return score_predictions(self.nclasses,
                                 getattr(self, "distribution", None),
                                 yt[ok], out[ok])


def score_predictions(nclasses: int, distribution: str | None,
                      y_true, preds: torch.Tensor) -> dict[str, float]:
    """The metric dispatch that ``model_performance`` and
    cross-validation share, on the predictions' device (on a card each
    score histogram is the CUDA kernel's; a binomial AUC and its
    threshold table share one). ``y_true``: class ids or the numeric
    response, NA rows already dropped; ``preds``: [n, K] probabilities
    or [n] predictions. Binomial: auc/logloss/rmse and the threshold
    table's pr_auc/gini/f1/max_f1_threshold/mean_per_class_error (a
    single-class holdout keeps the first three); multinomial logloss/
    accuracy/mean_per_class_error and the macro one-vs-rest auc;
    regression rmse/mae/r2/mean_residual_deviance (poisson's deviance
    for poisson)."""
    from .. import metrics as M

    yt = y_true if isinstance(y_true, torch.Tensor) else \
        torch.as_tensor(np.asarray(y_true, dtype=np.float32))
    yt = yt.to(device=preds.device, dtype=torch.float32)
    if yt.shape[0] == 0:
        raise ValueError("cannot score an empty holdout "
                         "(no rows with a valid response)")
    if nclasses == 2:
        p1 = preds[:, 1]
        auc, stats = M.binomial_auc_and_stats(yt, p1)
        res = {"auc": auc, "logloss": M.logloss(yt, p1),
               "rmse": M.rmse(yt, p1)}
        if stats is None:                   # one class in the holdout
            return res
        return res | {k: stats[k] for k in
                      ("pr_auc", "gini", "f1", "max_f1_threshold",
                       "mean_per_class_error")}
    if nclasses > 2:
        lab = preds.argmax(dim=1)
        yc = yt.long()
        present = [k for k in range(nclasses) if bool((yc == k).any())]
        # mean per-class error: the mean of 1 - recall over the classes
        # present; auc: the macro one-vs-rest mean
        errs = [float((lab[yc == k] != k).double().mean())
                for k in present]
        aucs = [M.roc_auc((yc == k).float(), preds[:, k])
                for k in present]
        return {"logloss": M.multinomial_logloss(yt, preds),
                "accuracy": M.accuracy(yt, lab),
                "mean_per_class_error": float(np.mean(errs)) if errs
                else float("nan"),
                "auc": float(np.mean(aucs)) if aucs else float("nan")}
    dist = "poisson" if distribution == "poisson" else "gaussian"
    return {"rmse": M.rmse(yt, preds), "mae": M.mae(yt, preds),
            "r2": M.r2(yt, preds),
            "mean_residual_deviance": M.mean_residual_deviance(
                yt, preds, dist)}
