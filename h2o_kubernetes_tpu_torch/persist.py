"""Persistence: raw bytes over pluggable backends, model save and load
(every learner of the port but Word2Vec, with their cross-validation;
an aggregator keeps its exemplar rows), and frame files
(``export_file`` CSV, ``save_frame`` / ``load_frame`` npz + JSON
metadata, both the JAX package's formats).

Backends (the JAX package's ``PERSIST_SCHEMES`` registry): bare paths
are the local file system, ``mem://`` an in-process object store.
HTTP(S) and the cloud stores (``s3://``, ``gs://``, ``hdfs://``) raise,
naming ROADMAP Queue 1 item 13, which ports them.

A model file holds plain data only: numpy arrays, numbers, strings,
lists and dicts, pickled from the CPU behind a magic line; the loader
refuses every other global, so a tampered file cannot construct
arbitrary objects. ``load_model`` rebuilds the model on the device it
resolves (the card by default).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import pickle
from typing import Callable

import numpy as np

__all__ = ["save_model", "load_model", "export_file", "save_frame",
           "load_frame", "PERSIST_SCHEMES", "read_bytes",
           "write_bytes", "write_bytes_atomic", "list_names", "is_remote",
           "join_path"]

_MAGIC = b"H2OTPU-TORCH1\n"

_MEM_STORE: dict[str, bytes] = {}


def _mem_read(path: str) -> bytes:
    if path not in _MEM_STORE:
        raise FileNotFoundError(path)
    return _MEM_STORE[path]


def _mem_write(path: str, data: bytes) -> None:
    _MEM_STORE[path] = data


def _unported_scheme(scheme: str):
    def refuse(path: str, *_):
        raise NotImplementedError(
            f"the {scheme}:// persist backend is not ported (ROADMAP "
            "Queue 1 item 13); use a local path or mem://")
    return refuse


# scheme -> (reader: path -> bytes, writer: path, bytes -> None)
PERSIST_SCHEMES: dict[str, tuple[Callable, Callable]] = {
    "mem": (_mem_read, _mem_write)}
for _s in ("http", "https", "s3", "gs", "hdfs"):
    PERSIST_SCHEMES[_s] = (_unported_scheme(_s), _unported_scheme(_s))


def _scheme(path: str) -> str:
    scheme = path.split("://", 1)[0] if "://" in path else ""
    if scheme and scheme not in PERSIST_SCHEMES:
        raise ValueError(f"no persist backend for scheme '{scheme}://' "
                         "(register in PERSIST_SCHEMES)")
    return scheme


def write_bytes(path: str, data: bytes) -> None:
    scheme = _scheme(path)
    if scheme:
        PERSIST_SCHEMES[scheme][1](path, data)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def read_bytes(path: str) -> bytes:
    scheme = _scheme(path)
    if scheme:
        return PERSIST_SCHEMES[scheme][0](path)
    with open(path, "rb") as f:
        return f.read()


def write_bytes_atomic(path: str, data: bytes, verify: bool = True) -> None:
    """Crash-safe write: readers see the old bytes or the new ones,
    never a torn prefix. A local path is written to a temporary file in
    the same directory, fsynced and renamed over ``path``; scheme
    backends replace whole objects. ``verify`` reads the bytes back and
    compares digests."""
    if is_remote(path):
        write_bytes(path, data)
    else:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    if verify:
        got = read_bytes(path)
        if hashlib.sha256(got).digest() != hashlib.sha256(data).digest():
            raise IOError(f"atomic write to {path} did not read back "
                          f"intact ({len(got)} bytes back vs {len(data)} "
                          "written)")


def list_names(base: str) -> list[str]:
    """Child object names directly under a local directory or a
    ``mem://`` prefix; a missing directory gives []."""
    if not is_remote(base):
        try:
            return sorted(n for n in os.listdir(base)
                          if os.path.isfile(os.path.join(base, n)))
        except (FileNotFoundError, NotADirectoryError):
            return []
    if base.startswith("mem://"):
        prefix = base.rstrip("/") + "/"
        return sorted({k[len(prefix):] for k in list(_MEM_STORE)
                       if k.startswith(prefix) and k[len(prefix):]
                       and "/" not in k[len(prefix):]})
    _scheme(base)
    return []


def is_remote(path: str) -> bool:
    """True when ``path`` routes through a PERSIST_SCHEMES backend."""
    return "://" in path


def join_path(base: str, name: str) -> str:
    """Join a child name onto a local directory or a scheme:// one."""
    if is_remote(base):
        return base.rstrip("/") + "/" + name
    return os.path.join(base, name)


# the globals a model file may name: plain containers and numpy's array
# reconstruction; nothing that runs code
_SAFE_GLOBALS = {
    ("builtins", "dict"), ("builtins", "list"), ("builtins", "tuple"),
    ("builtins", "set"), ("builtins", "int"), ("builtins", "float"),
    ("builtins", "str"), ("builtins", "bytes"), ("builtins", "bool"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
    ("_codecs", "encode"),
}


class _DataUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"model file references {module}.{name}, which is not plain "
            "data — refusing to load (possible tampering; use MOJO "
            "artifacts for untrusted scoring)")


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


_TREE_ALGOS = ("gbm", "drf", "xgboost")
# the learners of models/base.LearnerModel
_LEARNER_ALGOS = ("naivebayes", "pca", "kmeans", "glrm",
                  "isolationforest", "coxph")
_FILE_ALGOS = _TREE_ALGOS + ("glm", "deeplearning", "stackedensemble") \
    + _LEARNER_ALGOS + ("targetencoder", "aggregator")


def _meta_state(model) -> dict:
    return {"feature_names": list(model.feature_names),
            "feature_domains": dict(model.feature_domains),
            "nclasses": int(model.nclasses),
            "response_domain": model.response_domain,
            "distribution": model.distribution,
            "offset_column": getattr(model, "offset_column", None)}


def _dinfo_state(d) -> dict:
    return {"coef_names": list(d.coef_names),
            "numeric_idx": [int(i) for i in d.numeric_idx],
            "enum_specs": [[int(i), int(L), bool(na), int(m)]
                           for i, L, na, m in d.enum_specs],
            "means": np.asarray(d.means), "stds": np.asarray(d.stds),
            "n_expanded": int(d.n_expanded),
            "drop_first": bool(d.drop_first)}


def _cv_state(cv) -> dict | None:
    if cv is None:
        return None
    hp = cv.holdout_predictions
    return {"fold_ids": np.asarray(cv.fold_ids),
            "models": None if cv.models is None else
            [_model_state(m) for m in cv.models],
            "holdout_predictions": None if hp is None else _np(hp),
            "metrics": dict(cv.metrics),
            "metrics_summary": {k: dict(v) for k, v in
                                cv.metrics_summary.items()},
            "fold_metrics": [dict(f) for f in cv.fold_metrics]}


def _frame_state(frame) -> dict:
    """A Frame's columns as plain data (``to_numpy`` values, kinds and
    domains)."""
    return {"names": list(frame.names),
            "cols": {n: (frame.vec(n).kind, frame.vec(n).domain,
                         frame.vec(n).to_numpy()) for n in frame.names}}


def _frame_from_state(st: dict, dev):
    from .frame import Frame, Vec

    return Frame({n: Vec.from_numpy(st["cols"][n][2], n,
                                    domain=st["cols"][n][1],
                                    kind=st["cols"][n][0], device=dev)
                  for n in st["names"]})


def _learner_state(model) -> dict:
    """The fitted state of a ``LearnerModel`` beside its layout."""
    algo = model.algo
    st = {"params": dataclasses.asdict(model.params)}
    if getattr(model, "dinfo", None) is not None:
        st["dinfo"] = _dinfo_state(model.dinfo)
    if algo == "naivebayes":
        st.update(priors=_np(model.priors), num_mean=_np(model.num_mean),
                  num_sd=_np(model.num_sd),
                  enum_tables=[_np(t) for t in model.enum_tables],
                  enum_cols=list(model.enum_cols),
                  num_cols=list(model.num_cols))
    elif algo == "pca":
        st.update(eigvec=_np(model.eigenvectors),
                  eigval=_np(model.eigenvalues), n_obs=float(model.n_obs),
                  total_var=float(model._total_var))
    elif algo == "kmeans":
        st.update(centers=_np(model.centers_std), size=_np(model.size),
                  withinss=float(model.tot_withinss),
                  iterations=int(model.iterations))
    elif algo == "glrm":
        st.update(U=_np(model.U), V=_np(model.V),
                  objective=float(model.objective), nrows=int(model._nrows))
    elif algo == "isolationforest":
        st.update(trees={f: _np(getattr(model.trees, f))
                         for f in model.trees._fields},
                  sample=int(model.sample_size_effective))
    else:
        st.update(beta=_np(model.beta), names=list(model._names),
                  loglik=float(model.loglik),
                  loglik_null=float(model.loglik_null),
                  n_events=int(model.n_events),
                  iterations=int(model.iterations))
    return st


def _learner_from_state(algo: str, td, st: dict, dev):
    import torch

    from .models.datainfo import DataInfo

    dinfo = None
    if "dinfo" in st:
        d = st["dinfo"]
        dinfo = DataInfo(list(d["coef_names"]), list(d["numeric_idx"]),
                         [tuple(e) for e in d["enum_specs"]], d["means"],
                         d["stds"], d["n_expanded"], d["drop_first"])

    def t(a):
        return torch.as_tensor(a, device=dev)
    if algo == "naivebayes":
        from .models.naivebayes import NaiveBayesModel, NaiveBayesParams

        return NaiveBayesModel(td, NaiveBayesParams(**st["params"]),
                               st["priors"], st["num_mean"], st["num_sd"],
                               st["enum_tables"], st["enum_cols"],
                               st["num_cols"], dev)
    if algo == "pca":
        from .models.pca import PCAModel, PCAParams

        return PCAModel(td, PCAParams(**st["params"]), dinfo,
                        t(st["eigvec"]), t(st["eigval"]), st["n_obs"],
                        st["total_var"])
    if algo == "kmeans":
        from .models.kmeans import KMeansModel, KMeansParams

        return KMeansModel(td, KMeansParams(**st["params"]), dinfo,
                           t(st["centers"]), st["size"], st["withinss"],
                           st["iterations"])
    if algo == "glrm":
        from .models.glrm import GLRMModel, GLRMParams

        return GLRMModel(td, GLRMParams(**st["params"]), dinfo, t(st["U"]),
                         t(st["V"]), st["objective"], st["nrows"])
    if algo == "isolationforest":
        from .models.isolationforest import (IsolationForestModel,
                                             IsolationForestParams, IsoTree)

        trees = IsoTree(*(t(st["trees"][f]) for f in IsoTree._fields))
        return IsolationForestModel(td, IsolationForestParams(
            **st["params"]), trees, st["sample"])
    from .models.coxph import CoxPHModel, CoxPHParams

    return CoxPHModel(td, CoxPHParams(**st["params"]), dinfo, t(st["beta"]),
                      st["names"], st["loglik"], st["loglik_null"],
                      st["n_events"], st["iterations"])


def _model_state(model) -> dict:
    """A model as plain data (its cross-validation included)."""
    algo = getattr(model, "algo", None)
    if algo not in _FILE_ALGOS:
        raise ValueError(f"save_model: algo '{algo or '?'}' has no model "
                         "file (Word2Vec models leave as artifacts)")
    if algo == "targetencoder":
        return {"algo": algo, "params": dataclasses.asdict(model.params),
                "y": model.y, "columns": list(model.columns),
                "prior": float(model.prior),
                "tables": {c: dict(t) for c, t in model.tables.items()}}
    if algo == "aggregator":
        return {"algo": algo, "params": dataclasses.asdict(model.params),
                "feature_names": list(model.feature_names),
                "exemplars": _frame_state(
                    model._frame.select_rows(model._ex_idx)),
                "counts": np.asarray(model._counts)}
    st = {"algo": algo, "meta": _meta_state(model),
          "scoring_history": [dict(h) for h in model.scoring_history],
          "validation_metrics": model.validation_metrics,
          "cv": _cv_state(model.cv)}
    if algo in _TREE_ALGOS:
        spec = model.bin_spec
        st["meta"]["margin_scale"] = model._artifact_meta.get(
            "margin_scale")
        st.update(
            params=dataclasses.asdict(dataclasses.replace(
                model.params, checkpoint=None)),
            bin_spec={"names": list(spec.names),
                      "is_enum": [bool(e) for e in spec.is_enum],
                      "n_bins": int(spec.n_bins),
                      "edges": _np(spec.edges_matrix())},
            trees={f: _np(getattr(model.trees, f))
                   for f in model.trees._fields},
            init_score=np.asarray(model.init_score, dtype=np.float32),
            group_column=getattr(model, "_group_column", None))
    elif algo == "glm":
        st.update(params=dataclasses.asdict(model.params),
                  dinfo=_dinfo_state(model.dinfo), beta=_np(model.beta),
                  fit=[float(model.lambda_used),
                       float(model.null_deviance),
                       float(model.residual_deviance),
                       int(model.n_iterations)],
                  inference={a: dict(getattr(model, a)) for a in (
                      "_std_errs", "_z_values", "_p_values")
                      if hasattr(model, a)})
    elif algo == "deeplearning":
        st.update(params=dataclasses.asdict(dataclasses.replace(
            model.params, checkpoint=None)),
            dinfo=_dinfo_state(model.dinfo), net=model.net_numpy(),
            loss_kind=model.loss_kind)
    elif algo in _LEARNER_ALGOS:
        st["learner"] = _learner_state(model)
    else:
        st.update(base=[_model_state(m) for m in model.base_models],
                  metalearner=_model_state(model.metalearner),
                  base_tags=list(model.base_tags))
    return st


def save_model(model, path: str, force: bool = True) -> str:
    """Save a port model (any learner but Word2Vec), with its
    cross-validation, at ``path`` (a path without an
    extension is a directory: the file is ``<algo>.model`` in it);
    returns the file's path."""
    state = _model_state(model)
    if not force and not is_remote(path) and os.path.exists(path):
        raise FileExistsError(path)
    if not is_remote(path) and not os.path.splitext(path)[1]:
        path = os.path.join(path, f"{model.algo}.model")
    buf = io.BytesIO()
    buf.write(_MAGIC)
    pickle.dump(state, buf, protocol=pickle.HIGHEST_PROTOCOL)
    write_bytes(path, buf.getvalue())
    return path


def _model_from_state(st: dict, dev):
    import torch

    from .models.base import TrainData
    from .models.cv import CVResult
    from .models.datainfo import DataInfo

    algo = st["algo"]
    if algo == "targetencoder":
        from .models.targetencoder import (TargetEncoderModel,
                                           TargetEncoderParams)

        return TargetEncoderModel(TargetEncoderParams(**st["params"]),
                                  st["y"], st["columns"], st["prior"],
                                  st["tables"])
    if algo == "aggregator":
        from .models.aggregator import AggregatorModel, AggregatorParams

        ex = _frame_from_state(st["exemplars"], dev)
        td = TrainData(list(st["feature_names"]), None, None, 0, 1, None,
                       "gaussian")
        return AggregatorModel(td, AggregatorParams(**st["params"]), ex,
                               np.arange(ex.nrows), st["counts"])
    m = st["meta"]
    td = TrainData(list(m["feature_names"]), torch.zeros(0), torch.zeros(0),
                   0, int(m["nclasses"]), m["response_domain"],
                   m["distribution"], dict(m["feature_domains"] or {}))
    if algo in ("glm", "deeplearning"):
        d = st["dinfo"]
        dinfo = DataInfo(list(d["coef_names"]), list(d["numeric_idx"]),
                         [tuple(e) for e in d["enum_specs"]], d["means"],
                         d["stds"], d["n_expanded"], d["drop_first"])
    if algo in _TREE_ALGOS:
        from .models.drf import DRFModel
        from .models.gbm import GBMModel, GBMParams
        from .models.tree.binning import BinSpec
        from .models.tree.core import Tree
        from .models.xgboost import XGBoostModel

        bs = st["bin_spec"]
        spec = BinSpec(bs["names"], bs["is_enum"], bs["n_bins"],
                       torch.as_tensor(bs["edges"], device=dev))
        trees = Tree(*(torch.as_tensor(st["trees"][f], device=dev)
                       for f in Tree._fields))
        init = st["init_score"]
        K = td.nclasses if td.nclasses > 2 else 1
        cls = {"drf": DRFModel, "xgboost": XGBoostModel}.get(algo,
                                                            GBMModel)
        model = cls(td, GBMParams(**st["params"]), spec, trees,
                    init if K > 1 else float(init.reshape(-1)[0]),
                    m["offset_column"], device=dev,
                    margin_scale=float(m["margin_scale"]))
        if st.get("group_column"):
            model._group_column = st["group_column"]
    elif algo == "glm":
        from .models.glm import GLMModel, GLMParams

        model = GLMModel(td, GLMParams(**st["params"]), dinfo,
                         torch.as_tensor(st["beta"], device=dev),
                         *st["fit"])
        model.offset_column = m["offset_column"]
        for a, v in st["inference"].items():
            setattr(model, a, v)
    elif algo == "deeplearning":
        from .models.deeplearning import (DeepLearningModel,
                                          DeepLearningParams, carry_net)

        p = DeepLearningParams(**st["params"])
        model = DeepLearningModel(td, p, dinfo,
                                  carry_net(st["net"], dev, p.activation),
                                  st["loss_kind"])
        model.offset_column = m["offset_column"]
    elif algo in _LEARNER_ALGOS:
        model = _learner_from_state(algo, td, st["learner"], dev)
    else:
        from .models.stackedensemble import StackedEnsembleModel

        model = StackedEnsembleModel(
            td, [_model_from_state(b, dev) for b in st["base"]],
            _model_from_state(st["metalearner"], dev), st["base_tags"])
    model.scoring_history = st["scoring_history"]
    model.validation_metrics = st["validation_metrics"]
    cv = st["cv"]
    if cv is not None:
        hp = cv["holdout_predictions"]
        model.cv = CVResult(
            cv["fold_ids"],
            None if cv["models"] is None else
            [_model_from_state(s, dev) for s in cv["models"]],
            None if hp is None else torch.as_tensor(hp, device=dev),
            cv["metrics"], cv["metrics_summary"], cv["fold_metrics"])
    return model


def load_model(path: str, device=None):
    """Load a model ``save_model`` wrote onto ``device`` (None = the
    CUDA card; raises without one unless ``device="cpu"``)."""
    from .runtime.backend import resolve_device

    dev = resolve_device(device)
    data = read_bytes(path)
    if not data.startswith(_MAGIC):
        raise ValueError(f"{path} is not a model file of this package")
    return _model_from_state(
        _DataUnpickler(io.BytesIO(data[len(_MAGIC):])).load(), dev)


# -- frame files ---------------------------------------------------------------

def export_file(frame, path: str, header: bool = True,
                sep: str = ",") -> str:
    """h2o.export_file analog: write a Frame as CSV (local or scheme),
    byte for byte as the JAX package writes it: numbers as ``%g``, enum
    labels, time columns as ISO datetimes to the millisecond, NA as an
    empty field, RFC 4180 quoting."""
    cols = []
    for name in frame.names:
        v = frame.vec(name)
        if v.is_enum():
            codes = v.to_numpy()
            dom = np.array(list(v.domain) + [""], dtype=object)
            col = dom[np.where(codes < 0, len(dom) - 1, codes)]
        elif v.kind == "time":
            col = np.array(
                [np.datetime64(int(m), "ms").astype(str) if m == m else ""
                 for m in v.to_numpy()], dtype=object)
        else:
            x = v.to_numpy()
            col = np.where(np.isnan(x), "",
                           np.char.mod("%g", np.nan_to_num(x)))
        cols.append(col.astype(object))
    out = io.StringIO()
    if header:
        out.write(sep.join(frame.names) + "\n")
    quoted = []
    for c in cols:
        # RFC 4180: embedded quotes double inside a quoted field
        quoted.append(np.array(
            [f'"{str(s).replace(chr(34), chr(34) * 2)}"'
             if (sep in str(s) or '"' in str(s) or "\n" in str(s))
             else str(s) for s in c], dtype=object))
    for i in range(frame.nrows):
        out.write(sep.join(str(q[i]) for q in quoted) + "\n")
    write_bytes(path, out.getvalue().encode())
    return path


def save_frame(frame, path: str) -> str:
    """Binary frame file: an npz of the columns (``to_numpy``: enum
    codes, float32 numbers, float64 absolute epoch-ms) and JSON metadata
    (names, kinds, domains, time origins) — the JAX package's format, so
    either package loads the other's files. Data only, no pickle."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"names": frame.names, "kinds": {}, "domains": {},
                  "origins": {}}
    for name in frame.names:
        v = frame.vec(name)
        arrays[f"col_{name}"] = v.to_numpy()
        meta["kinds"][name] = v.kind
        if v.domain is not None:
            meta["domains"][name] = list(v.domain)
        if v.kind == "time":
            meta["origins"][name] = v.origin
    buf = io.BytesIO()
    np.savez_compressed(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    write_bytes(path, buf.getvalue())
    return path


def load_frame(path: str, device=None):
    """A ``save_frame`` file (of either package) as a Frame on
    ``device`` (None = the CUDA card; raises without one unless
    ``device="cpu"``)."""
    from .frame import Frame, Vec
    from .runtime.backend import resolve_device

    dev = resolve_device(device)
    with np.load(io.BytesIO(read_bytes(path)), allow_pickle=False) as z:
        try:
            meta = json.loads(z["__meta__"].tobytes().decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise ValueError(
                f"{path}: frame metadata is not JSON — this looks like a "
                "frame saved by a pre-0.2 build (pickle metadata); "
                "re-export it with export_file/save_frame") from None
        vecs = {}
        for name in meta["names"]:
            arr = z[f"col_{name}"]
            kind = meta["kinds"][name]
            if kind == "time":
                # to_numpy wrote absolute epoch-ms float64
                vecs[name] = Vec.from_numpy(arr, name, kind="time",
                                            device=dev)
            elif kind == "enum":
                vecs[name] = Vec.from_numpy(
                    arr.astype(np.int32), name,
                    domain=meta["domains"][name], kind="enum", device=dev)
            else:
                vecs[name] = Vec.from_numpy(arr, name, device=dev)
    return Frame(vecs)
