"""Model registry: versioned MOJO-v2 artifacts, and the replica scorer.

The training side publishes a trained tree ensemble as a versioned
MOJO-v2 artifact (``ModelRegistry.publish``) under a ``persist.py`` root
(a local directory or ``mem://``), and pushes it to scorer replicas
(``push``: ``POST /3/ModelRegistry/load`` with the artifact's path and
sha256 for a file root, the bytes inline for ``mem://``).

A scorer replica never sees the training stack: it wraps the artifact's
flat arrays in a ``FlatTreeScorer`` — a ``Model`` whose
``_score_matrix`` descends ``flat_margin`` over the artifact's
``flat_*`` arrays, and whose contributions come from the TreeSHAP
tables built from the same arrays plus ``flat_cover``. A trained
``GBMModel`` is a ``FlatTreeScorer`` over the arrays it flattened, so a
pushed artifact scores as the model did. Format-v1 artifacts (heap
trees + bin edges) are rejected: they have no serving arrays.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
from typing import Sequence

import numpy as np
import torch

from .. import persist
from ..models.base import Model
from ..mojo import MOJO_FORMAT, read_mojo_parts, write_mojo_parts
from ..runtime.backend import resolve_device

__all__ = ["ModelRegistry", "FlatTreeScorer", "load_artifact",
           "SERVABLE_ALGOS"]

SERVABLE_ALGOS = ("gbm", "drf", "xgboost")

_FLAT_PARTS = ("split_feat", "thresh", "left", "na_left", "value")


def _check_flat_arrays(arrays: dict, n_features: int) -> None:
    """Reject flat arrays whose indices leave their tables. Artifacts
    arrive over REST; on a CUDA device an out-of-range split feature or
    child pointer is an unchecked gather in the descent and an
    unchecked write into φ in the TreeSHAP kernel."""
    sf = arrays["flat_split_feat"]
    if sf.ndim != 2 or sf.shape[1] < 1:
        raise ValueError(f"flat_split_feat must be [trees, nodes], got "
                         f"{sf.shape}")
    for k, a in arrays.items():
        if k.startswith("flat_") and a.shape != sf.shape:
            raise ValueError(f"{k} has shape {a.shape}, flat_split_feat "
                             f"{sf.shape}")
    if arrays["enum_mask"].shape != (n_features,):
        raise ValueError(f"enum_mask has shape {arrays['enum_mask'].shape}"
                         f" for {n_features} features")
    split = sf >= 0
    if (sf[split] >= n_features).any():
        raise ValueError(f"flat_split_feat names a feature >= "
                         f"{n_features} — corrupt or tampered")
    left = arrays["flat_left"][split].astype(np.int64)
    if ((left < 1) | (left + 1 >= sf.shape[1])).any():
        raise ValueError(f"flat_left points outside the {sf.shape[1]} "
                         "nodes of a tree — corrupt or tampered")


class FlatTreeScorer(Model):
    """Servable model built from a MOJO-v2 tree artifact's numpy
    arrays and ``model.json`` meta, on ``device`` (None = the CUDA
    card; raises without one unless ``device="cpu"``)."""

    def __init__(self, meta: dict, arrays: dict, device=None):
        self.device = resolve_device(device)
        self._artifact_meta = dict(meta)
        keep = ["init_score", "enum_mask"] + [f"flat_{f}"
                                              for f in _FLAT_PARTS]
        if "flat_cover" in arrays:
            # optional cover part: enables serving contributions
            keep.append("flat_cover")
        self._artifact_arrays = {k: np.asarray(arrays[k]) for k in keep}
        _check_flat_arrays(self._artifact_arrays,
                           len(meta["feature_names"]))
        self.algo = meta["algo"]
        self.feature_names = list(meta["feature_names"])
        self.feature_domains = dict(meta.get("feature_domains") or {})
        self.nclasses = int(meta["nclasses"])
        self.response_domain = meta.get("response_domain")
        self.distribution = meta.get("distribution")
        self.offset_column = meta.get("offset_column")
        self.ntrees = int(meta["ntrees"])
        self.max_depth = int(meta["max_depth"])
        self.drf_mode = bool(meta["drf_mode"])
        self.margin_scale = float(meta.get("margin_scale", 1.0))
        self.init_score = np.asarray(self._artifact_arrays["init_score"])

    def _serving_prepare(self):
        """Build (or fetch) the device arrays; returns (FlatTrees,
        enum mask, init score)."""
        ft = self.__dict__.get("_flat_trees")
        if ft is not None:
            return ft, self._enum_mask, self._init_t
        from ..models.tree.core import FlatTrees

        a = self._artifact_arrays
        dev = self.device
        self._enum_mask = torch.as_tensor(
            np.asarray(a["enum_mask"]).astype(bool), device=dev)
        self._init_t = torch.as_tensor(
            np.asarray(a["init_score"], dtype=np.float32).reshape(-1),
            device=dev)
        ft = FlatTrees(*(torch.as_tensor(a[f"flat_{f}"], device=dev)
                         for f in _FLAT_PARTS))
        self._flat_trees = ft
        return ft, self._enum_mask, self._init_t

    # -- TreeSHAP contributions ---------------------------------------------

    def contrib_support(self) -> "str | None":
        if int(self.nclasses) > 2:
            return ("predict_contributions supports binomial "
                    "and regression models only")
        if self.offset_column:
            return ("predict_contributions is not supported "
                    "for models trained with an offset")
        if "flat_cover" not in self._artifact_arrays:
            return (
                "this artifact was exported without per-node cover; "
                "TreeSHAP needs it — re-export the model")
        return None

    def _shap_sources(self):
        from ..models.tree.core import FlatTrees

        a = self._artifact_arrays
        flat = FlatTrees(*(np.asarray(a[f"flat_{f}"]) for f in _FLAT_PARTS))
        return flat, np.asarray(a["flat_cover"])

    def _contrib_enum_mask(self) -> torch.Tensor:
        return self._serving_prepare()[1]

    def _contrib_scale_init(self) -> tuple[float, float]:
        scale = float(self.margin_scale)
        if self.drf_mode:
            scale /= self.ntrees
        return scale, float(np.asarray(self.init_score).ravel()[0])

    def export_artifact(self) -> bytes:
        """This model as MOJO-v2 artifact bytes: its meta and the arrays
        it serves from (a loaded scorer's are the artifact's own, so it
        can be published again; the zip bytes, and so the digest, may
        differ from the artifact it came from)."""
        buf = io.BytesIO()
        write_mojo_parts(self._artifact_meta, self._artifact_arrays, buf)
        return buf.getvalue()

    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        from ..models.tree.core import flat_margin

        ft, em, init = self._serving_prepare()
        K = self.nclasses if self.nclasses > 2 else 1
        lv = flat_margin(ft, X, em, self.max_depth, K)      # [K, rows]
        if K == 1:
            m = lv[0]
            if self.drf_mode:
                m = m / self.ntrees
            base = init if offset is None else init + offset
            m = base + self.margin_scale * m
        else:
            if self.drf_mode:
                lv = lv / (self.ntrees // K)
            m = (init[:, None] + lv).T
        d = self.distribution
        if d == "bernoulli":
            p1 = torch.clamp(m, 0.0, 1.0) if self.drf_mode \
                else torch.sigmoid(m)
            return torch.stack([1.0 - p1, p1], dim=1)
        if d == "multinomial":
            if self.drf_mode:
                m = torch.clamp(m, min=0.0)
                return m / (torch.sum(m, dim=1, keepdim=True) + 1e-10)
            return torch.softmax(m, dim=1)
        if d in ("poisson", "gamma", "tweedie"):
            return torch.exp(m)
        return m


def load_artifact(blob: bytes, device=None) -> FlatTreeScorer:
    """MOJO-v2 artifact bytes -> a servable FlatTreeScorer on
    ``device``. Rejects format-v1 artifacts and non-tree algos."""
    meta, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    if meta.get("format") != MOJO_FORMAT:
        raise ValueError(
            f"artifact format {meta.get('format')!r} is not servable "
            f"by a scorer replica (need {MOJO_FORMAT}): format-v1 "
            "artifacts carry heap trees + bin edges, not the flattened "
            "serving arrays — re-export the model")
    if meta.get("algo") not in SERVABLE_ALGOS:
        raise ValueError(
            f"algo '{meta.get('algo')}' is not servable by a scorer "
            f"replica (supported: {', '.join(SERVABLE_ALGOS)})")
    if "flat_split_feat" not in arrays:
        raise ValueError("artifact claims MOJO-v2 but lacks the flat_* "
                         "serving arrays — corrupt or tampered")
    return FlatTreeScorer(meta, arrays, device=device)


class ModelRegistry:
    """Versioned artifact store rooted at a ``persist.py`` path: a local
    directory or a ``mem://`` prefix.

    Layout: ``<root>/index.json`` (name -> {latest, versions}) plus
    ``<root>/<name>-v<N>.mojo`` blobs. Single writer by design (one
    operator process owns a registry root); replicas only read."""

    def __init__(self, root: str):
        self.root = root

    # -- index ----------------------------------------------------------------

    def _index_path(self) -> str:
        return persist.join_path(self.root, "index.json")

    def _load_index(self) -> dict:
        try:
            return json.loads(persist.read_bytes(self._index_path()))
        except FileNotFoundError:
            return {}       # fresh registry root

    def _save_index(self, idx: dict) -> None:
        # atomic and read back: a publish that dies mid-write leaves the
        # previous index, never a torn one
        persist.write_bytes_atomic(self._index_path(),
                                   json.dumps(idx, indent=1).encode())

    # -- publish / fetch ------------------------------------------------------

    def artifact_path(self, name: str, version: int) -> str:
        return persist.join_path(self.root, f"{name}-v{int(version)}.mojo")

    def publish(self, model, name: str) -> int:
        """Export ``model`` (a port GBM/DRF model or a loaded scorer) as
        the next version of artifact ``name``; returns the version."""
        if getattr(model, "algo", None) not in SERVABLE_ALGOS or \
                not hasattr(model, "export_artifact"):
            raise ValueError(
                f"cannot publish algo '{getattr(model, 'algo', '?')}' "
                f"to a scorer pool (supported: "
                f"{', '.join(SERVABLE_ALGOS)})")
        blob = model.export_artifact()
        idx = self._load_index()
        ent = idx.setdefault(name, {"latest": 0, "versions": {}})
        version = int(ent["latest"]) + 1
        path = self.artifact_path(name, version)
        # blob first, index second: a crash between the two leaves an
        # unreferenced blob, never an index entry without bytes
        persist.write_bytes_atomic(path, blob)
        ent["versions"][str(version)] = {
            "path": path,
            "bytes": len(blob),
            "sha256": hashlib.sha256(blob).hexdigest(),
            "algo": model.algo,
        }
        ent["latest"] = version
        self._save_index(idx)
        return version

    def latest(self, name: str) -> int:
        ent = self._load_index().get(name)
        if not ent or not ent["latest"]:
            raise KeyError(f"no artifact '{name}' in registry "
                           f"{self.root}")
        return int(ent["latest"])

    def info(self, name: str, version: int) -> dict:
        ent = self._load_index().get(name) or {"versions": {}}
        try:
            return dict(ent["versions"][str(int(version))])
        except KeyError:
            raise KeyError(f"no artifact '{name}' v{version} in "
                           f"registry {self.root}") from None

    def fetch(self, name: str, version: int) -> bytes:
        """The artifact's bytes, checked against the indexed sha256."""
        blob = persist.read_bytes(self.artifact_path(name, version))
        want = self.info(name, version)["sha256"]
        got = hashlib.sha256(blob).hexdigest()
        if got != want:
            raise IOError(
                f"artifact '{name}' v{version} digest mismatch "
                f"({got[:12]} != indexed {want[:12]}) — refusing to "
                "serve a corrupted model")
        return blob

    # -- push to a replica ----------------------------------------------------

    def push(self, base_url: str, name: str, version: int,
             model_key: str, warm_buckets: Sequence[int] | None = None,
             timeout: float = 300.0) -> dict:
        """POST the artifact to a replica's ``/3/ModelRegistry/load`` and
        wait until it has loaded and warmed (the route warms before it
        answers). ``warm_buckets=None`` lets the replica use its own
        ``H2O_TPU_POOL_WARM_BUCKETS``. A file root sends the artifact's
        path and sha256 (the replica reads and checks it); a ``mem://``
        root, which exists only in this process, sends the bytes."""
        body = {"model_id": model_key, "name": name,
                "version": int(version)}
        if warm_buckets is not None:
            body["warm_buckets"] = [int(b) for b in warm_buckets]
        if self.root.startswith("mem://"):
            body["artifact_b64"] = base64.b64encode(
                self.fetch(name, version)).decode()
        else:
            body["path"] = self.artifact_path(name, version)
            body["sha256"] = self.info(name, version)["sha256"]
        return self._post_json(base_url, "/3/ModelRegistry/load",
                               body, timeout)

    def push_many(self, base_url: str, items: Sequence[Sequence],
                  warm_buckets: Sequence[int] | None = None,
                  timeout: float = 300.0) -> list[dict]:
        """Push a set of artifacts to one replica: ``items`` is a
        sequence of (artifact, version, model_key) entries; returns the
        per-artifact load responses. (The JAX package's replica also
        takes a required-model set first, ``/3/ModelRegistry/require``;
        the port's replica gains that route with ROADMAP Queue 1 item
        7b-2.)"""
        return [self.push(base_url, name, version, key,
                          warm_buckets=warm_buckets, timeout=timeout)
                for name, version, key in items]

    @staticmethod
    def _post_json(base_url: str, path: str, body: dict,
                   timeout: float) -> dict:
        """POST with ``runtime/retry.py``'s backoff on transient
        failures (replica 5xx/429, connection refused or reset, timeout);
        a 4xx other than 429 (a bad artifact, a digest mismatch) raises
        on the first attempt. The load route is idempotent, so retrying
        a push whose answer was lost is safe."""
        import urllib.error
        import urllib.request

        from ..runtime import retry as _retry

        data = json.dumps(body).encode()

        def attempt() -> dict:
            req = urllib.request.Request(
                base_url.rstrip("/") + path, data=data, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code == 429 or e.code >= 500:
                    ra = e.headers.get("Retry-After")
                    try:
                        ra = float(ra) if ra is not None else None
                    except ValueError:
                        ra = None
                    detail = e.read()[:200]
                    raise _retry.TransientError(
                        f"replica POST {path}: HTTP {e.code} "
                        f"{detail!r}", retry_after=ra) from None
                raise                       # 4xx: permanent, no retry
            except urllib.error.URLError as e:
                raise _retry.TransientError(
                    f"replica POST {path}: {e.reason!r}") from None
            except (TimeoutError, ConnectionError, OSError) as e:
                raise _retry.TransientError(
                    f"replica POST {path}: {e!r}") from None

        return _retry.call(attempt, describe=f"registry push {path}")
