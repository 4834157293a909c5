"""Persistence: raw bytes over pluggable backends, and GBM/DRF model
save and load.

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
import os
import pickle
from typing import Callable

import numpy as np

__all__ = ["save_model", "load_model", "PERSIST_SCHEMES", "read_bytes",
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


def save_model(model, path: str, force: bool = True) -> str:
    """Save a port GBM/DRF/XGBoost model at ``path`` (a path without an
    extension is a directory: the file is ``<algo>.model`` in it);
    returns the file's path."""
    from .models.gbm import GBMModel

    if not isinstance(model, GBMModel):
        raise ValueError(f"save_model: algo '{getattr(model, 'algo', '?')}'"
                         " is not ported (GBM, DRF and XGBoost models "
                         "are)")
    if not force and not is_remote(path) and os.path.exists(path):
        raise FileExistsError(path)
    if not is_remote(path) and not os.path.splitext(path)[1]:
        path = os.path.join(path, f"{model.algo}.model")
    params = dataclasses.asdict(dataclasses.replace(model.params,
                                                    checkpoint=None))
    spec = model.bin_spec
    state = {
        "algo": model.algo,
        "meta": {k: model._artifact_meta.get(k) for k in (
            "feature_names", "feature_domains", "nclasses",
            "response_domain", "distribution", "offset_column",
            "margin_scale")},
        "params": params,
        "bin_spec": {"names": list(spec.names),
                     "is_enum": [bool(e) for e in spec.is_enum],
                     "n_bins": int(spec.n_bins),
                     "edges": _np(spec.edges_matrix())},
        "trees": {f: _np(getattr(model.trees, f))
                  for f in model.trees._fields},
        "init_score": np.asarray(model.init_score, dtype=np.float32),
        "scoring_history": [dict(h) for h in model.scoring_history],
        "validation_metrics": model.validation_metrics,
        "group_column": getattr(model, "_group_column", None),
    }
    buf = io.BytesIO()
    buf.write(_MAGIC)
    pickle.dump(state, buf, protocol=pickle.HIGHEST_PROTOCOL)
    write_bytes(path, buf.getvalue())
    return path


def load_model(path: str, device=None):
    """Load a model ``save_model`` wrote onto ``device`` (None = the
    CUDA card; raises without one unless ``device="cpu"``)."""
    import torch

    from .models.base import TrainData
    from .models.drf import DRFModel
    from .models.gbm import GBMModel, GBMParams
    from .models.xgboost import XGBoostModel
    from .models.tree.binning import BinSpec
    from .models.tree.core import Tree
    from .runtime.backend import resolve_device

    dev = resolve_device(device)
    data = read_bytes(path)
    if not data.startswith(_MAGIC):
        raise ValueError(f"{path} is not a model file of this package")
    st = _DataUnpickler(io.BytesIO(data[len(_MAGIC):])).load()
    m = st["meta"]
    td = TrainData(list(m["feature_names"]), torch.zeros(0), torch.zeros(0),
                   0, int(m["nclasses"]), m["response_domain"],
                   m["distribution"], dict(m["feature_domains"] or {}))
    bs = st["bin_spec"]
    spec = BinSpec(bs["names"], bs["is_enum"], bs["n_bins"],
                   torch.as_tensor(bs["edges"], device=dev))
    trees = Tree(*(torch.as_tensor(st["trees"][f], device=dev)
                   for f in Tree._fields))
    init = st["init_score"]
    K = td.nclasses if td.nclasses > 2 else 1
    cls = {"drf": DRFModel, "xgboost": XGBoostModel}.get(st["algo"],
                                                        GBMModel)
    model = cls(td, GBMParams(**st["params"]), spec, trees,
                init if K > 1 else float(init.reshape(-1)[0]),
                m["offset_column"], device=dev,
                margin_scale=float(m["margin_scale"]))
    model.scoring_history = st["scoring_history"]
    model.validation_metrics = st["validation_metrics"]
    if st.get("group_column"):
        model._group_column = st["group_column"]
    return model
