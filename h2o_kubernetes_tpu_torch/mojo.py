"""MOJO-v2 artifacts: a zip of ``model.json`` metadata plus an
``arrays.npz`` of numpy arrays, the JAX package's format.

A tree ensemble carries the flattened serving arrays (``flat_*``), the
per-node ``flat_cover`` that TreeSHAP needs, ``init_score`` and
``enum_mask``; its meta names the algo, features and their domains,
classes, distribution, offset column, depth, bins, ``drf_mode``, tree
count, NA bin and laplace's ``margin_scale``. A GLM carries its
coefficients ``beta`` and its design layout (``means``, ``stds``; the
meta's ``numeric_idx``, ``enum_specs`` and ``drop_first``), family and
link. ``export_mojo`` writes a port GBM/DRF/XGBoost/GLM model (or a
loaded tree scorer) as one; ``read_mojo_parts`` reads any;
``import_mojo``/``MojoModel`` score a tree or GLM artifact with numpy
only, on any host. The JAX package's other algos raise, naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

__all__ = ["MOJO_FORMAT", "read_mojo_parts", "write_mojo_parts",
           "export_mojo", "import_mojo", "MojoModel", "TREE_ALGOS",
           "SCORED_ALGOS"]

# format 2: tree ensembles carry the flattened serving arrays (flat_*)
_FORMAT = "h2o_kubernetes_tpu/mojo/2"
_READABLE_FORMATS = ("h2o_kubernetes_tpu/mojo/1", _FORMAT)

# the format a scorer replica serves (v1 artifacts have no flat arrays)
MOJO_FORMAT = _FORMAT

TREE_ALGOS = ("gbm", "drf", "xgboost")
# the algos whose artifacts this module writes and scores
SCORED_ALGOS = TREE_ALGOS + ("glm",)
# the JAX package's other artifact algos, by the ROADMAP item (Queue 1)
# that ports them
_UNPORTED_ALGOS = {
    "deeplearning": "item 7", "word2vec": "item 7",
    "kmeans": "item 7", "pca": "item 7", "glrm": "item 7",
    "naivebayes": "item 7", "isolationforest": "item 7",
    "coxph": "item 7", "targetencoder": "item 7",
    "stackedensemble": "item 8"}


def _unported(algo) -> str:
    item = _UNPORTED_ALGOS.get(algo)
    where = f"ROADMAP Queue 1 {item}" if item else "not a JAX package algo"
    return f"algo '{algo}' artifacts are not ported ({where})"


def read_mojo_parts(path, want_nested: bool = False
                    ) -> tuple[dict, dict, dict]:
    """(meta, arrays, nested) of a mojo artifact (a path or a binary
    file-like object). ``nested`` holds the inner ``*.mojo`` blobs of a
    stackedensemble artifact when ``want_nested``; empty otherwise."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("model.json"))
        if meta.get("format") not in _READABLE_FORMATS:
            raise ValueError(f"not a {_FORMAT} artifact "
                             f"(format={meta.get('format')!r})")
        with np.load(io.BytesIO(z.read("arrays.npz"))) as npz:
            arrays = {k: npz[k] for k in npz.files}
        nested = {}
        if want_nested:
            nested = {n: z.read(n) for n in z.namelist()
                      if n.endswith(".mojo")}
    return meta, arrays, nested


def write_mojo_parts(meta: dict, arrays: dict, path) -> None:
    """Write ``meta`` (as ``model.json``, with this format's tag) and
    ``arrays`` (as a compressed ``arrays.npz``) to ``path``, a
    filesystem path or a binary file-like object."""
    npz = io.BytesIO()
    np.savez_compressed(npz, **arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.json", json.dumps(dict(meta, format=_FORMAT)))
        z.writestr("arrays.npz", npz.getvalue())


def export_mojo(model, path):
    """Write ``model`` (a port GBM/DRF/XGBoost/GLM model, or a scorer
    loaded from an artifact) as a MOJO-v2 artifact at ``path`` (a
    filesystem path or a binary file-like object); returns ``path``. The
    arrays are the ones the model serves from (a tree model's
    flattening, a GLM's coefficients and design layout), so an artifact
    scores as the model does."""
    algo = getattr(model, "algo", None)
    if algo not in SCORED_ALGOS or not hasattr(model, "_artifact_arrays"):
        raise ValueError(f"mojo export: {_unported(algo)}")
    write_mojo_parts(model._artifact_meta, model._artifact_arrays, path)
    return path


def import_mojo(path) -> "MojoModel":
    return MojoModel(path)


class MojoModel:
    """A tree or GLM artifact scored with numpy only (no torch, no
    device)."""

    def __init__(self, path):
        self.meta, self.arrays, _ = read_mojo_parts(path)
        self.algo = self.meta["algo"]
        if self.algo not in SCORED_ALGOS:
            raise NotImplementedError(_unported(self.algo))
        if self.algo in TREE_ALGOS and "flat_split_feat" not in self.arrays:
            raise ValueError("format-v1 tree artifacts (heap trees + bin "
                             "edges) are not read by the port — re-export "
                             "the model")
        self.feature_names = self.meta["feature_names"]
        self.nclasses = self.meta["nclasses"]

    def _matrix(self, data) -> np.ndarray:
        """[n, F] float32 from a mapping name -> array (numbers, or
        strings of an enum column's levels) or a Frame (its enum codes
        decoded to levels: a scoring frame's domain need not be the
        training one)."""
        if hasattr(data, "vec") and hasattr(data, "names"):
            tdoms = self.meta["feature_domains"]
            decoded = {}
            for n in self.feature_names:
                if n not in data.names:
                    raise ValueError(f"missing feature column '{n}'")
                v = data.vec(n)
                if (tdoms.get(n) is not None) != v.is_enum():
                    raise ValueError(
                        f"column '{n}' is {v.kind} in the scoring frame "
                        "but was not at training time")
                if v.is_enum():
                    dom = np.array(list(v.domain or []) + [None],
                                   dtype=object)
                    codes = v.to_numpy()
                    decoded[n] = dom[np.where(codes < 0, len(dom) - 1,
                                              codes)]
                else:
                    decoded[n] = v.to_numpy()
            data = decoded
        cols = []
        doms = self.meta["feature_domains"]
        for name in self.feature_names:
            if name not in data:
                raise ValueError(f"missing feature column '{name}'")
            col = np.asarray(data[name])
            dom = doms.get(name)
            if dom is not None and col.dtype.kind in ("U", "S", "O"):
                lut = {d: i for i, d in enumerate(dom)}
                col = np.array([lut.get(str(s), -1) for s in col],
                               dtype=np.float32)
                col[col < 0] = np.nan
            cols.append(col.astype(np.float32))
        return np.stack(cols, axis=1)

    def _offset(self, data) -> np.ndarray | None:
        """Per-row offset of an offset-trained artifact: the column must
        be in the scoring data (NA offsets give NaN)."""
        oc = self.meta.get("offset_column")
        if not oc:
            return None
        if isinstance(data, np.ndarray):
            raise ValueError(
                f"this artifact was trained with offset_column='{oc}'; "
                "score with a dict/Frame including that column, not a "
                "bare matrix")
        if hasattr(data, "vec") and hasattr(data, "names"):
            if oc not in data.names:
                raise ValueError(f"offset column '{oc}' missing from "
                                 "the scoring frame")
            return data.vec(oc).to_numpy().astype(np.float64)
        if oc not in data:
            raise ValueError(f"offset column '{oc}' missing from the "
                             "scoring data")
        return np.asarray(data[oc], dtype=np.float64)

    def predict(self, data) -> np.ndarray:
        """[n, K] probabilities or [n] predictions."""
        off = self._offset(data)
        X = data.astype(np.float32) if isinstance(data, np.ndarray) \
            else self._matrix(data)
        if self.algo == "glm":
            return self._predict_glm(X, off)
        return self._combine(self._totals(X), off)

    def _expand(self, X) -> np.ndarray:
        """The GLM design expansion (``models/datainfo.expand``) in
        numpy float32: mean-imputed standardized numerics, one-hot enums,
        the intercept last."""
        m = self.meta
        means, stds = self.arrays["means"], self.arrays["stds"]
        out = []
        for j, i in enumerate(m["numeric_idx"]):
            c = X[:, i].copy()
            c[np.isnan(c)] = means[j]
            out.append((c - means[j]) / stds[j])
        mats = [np.stack(out, axis=1)] if out else []
        for (i, L, has_na, mode) in m["enum_specs"]:
            c = X[:, i]
            code = np.where(np.isnan(c), L, c).astype(np.int32)
            if not has_na:
                code = np.where(code >= L, mode, code)
            lo = 1 if m["drop_first"] else 0
            width = L - lo + (1 if has_na else 0)
            levels = np.arange(lo, lo + width)
            mats.append((code[:, None] == levels[None, :])
                        .astype(np.float32))
        mats.append(np.ones((X.shape[0], 1), dtype=np.float32))
        return np.concatenate(mats, axis=1)

    def _predict_glm(self, X, off=None) -> np.ndarray:
        """[n, K] probabilities (binomial, multinomial) or [n] means."""
        eta = self._expand(X) @ self.arrays["beta"]
        if off is not None:
            eta = eta + off
        fam = self.meta["family"]
        if fam == "multinomial":
            z = np.exp(eta - eta.max(axis=1, keepdims=True))
            return z / z.sum(axis=1, keepdims=True)
        link = self.meta.get("link", "identity")
        if link == "logit":
            mu = 1.0 / (1.0 + np.exp(-eta))
        elif link == "log":
            mu = np.exp(np.clip(eta, -30, 30))
        elif link == "inverse":
            e = np.where(np.abs(eta) < 1e-6,
                         np.where(eta < 0, -1e-6, 1e-6), eta)
            mu = 1.0 / e
        else:
            mu = eta
        if fam == "binomial":
            return np.stack([1 - mu, mu], axis=1)
        return mu

    def _totals(self, X):
        """[n, K] per-class float64 leaf-value sums over the flattened
        ensemble (raw-feature thresholds, the descent of
        ``models/tree/core.flat_margin``)."""
        m, a = self.meta, self.arrays
        sf, th, lf = a["flat_split_feat"], a["flat_thresh"], a["flat_left"]
        nl, val = a["flat_na_left"], a["flat_value"]
        enum_mask = a["enum_mask"].astype(bool)
        Xc = np.where(enum_mask[None, :] & (X < 0), np.nan, X)
        n = Xc.shape[0]
        K = m["nclasses"] if m["nclasses"] > 2 else 1
        totals = np.zeros((n, K), dtype=np.float64)
        rows = np.arange(n)
        for t in range(sf.shape[0]):
            node = np.zeros(n, dtype=np.int64)
            for _ in range(m["max_depth"]):
                f = sf[t][node]
                x = Xc[rows, np.maximum(f, 0)]
                with np.errstate(invalid="ignore"):
                    go_right = np.where(np.isnan(x), ~nl[t][node],
                                        x >= th[t][node])
                node = np.where(f >= 0, lf[t][node]
                                + go_right.astype(np.int64), node)
            totals[:, t % K] += val[t][node]
        return totals

    def _combine(self, totals, off=None):
        """Totals -> predictions: init, DRF averaging, the link."""
        m = self.meta
        K = m["nclasses"] if m["nclasses"] > 2 else 1
        init = np.atleast_1d(self.arrays["init_score"].astype(np.float64))
        if m["drf_mode"]:
            totals = totals / (m["ntrees"] // K)
        probsum = totals + init[None, :]
        if off is not None:
            probsum = probsum + off[:, None]
        d = m["distribution"]
        if d == "bernoulli":
            mgn = probsum[:, 0]
            p1 = np.clip(mgn, 0, 1) if m["drf_mode"] else \
                1.0 / (1.0 + np.exp(-mgn))
            return np.stack([1 - p1, p1], axis=1)
        if d == "multinomial":
            if m["drf_mode"]:
                z = np.clip(probsum, 0, None)
                return z / (z.sum(axis=1, keepdims=True) + 1e-10)
            z = np.exp(probsum - probsum.max(axis=1, keepdims=True))
            return z / z.sum(axis=1, keepdims=True)
        if d in ("poisson", "gamma", "tweedie"):
            return np.exp(probsum[:, 0])
        scale = m.get("margin_scale", 1.0)
        if scale != 1.0:
            # laplace's scaling never meets an offset (training refuses)
            return init[0] + scale * totals[:, 0]
        return probsum[:, 0]
