"""Frame: a columnar table whose columns are tensors on one device.

The JAX package keeps each column as one row-sharded ``jax.Array``
padded to the mesh's ROWS axis. The port holds the whole frame on one
device — the CUDA card unless the caller asks for the CPU — so a column
is one unpadded tensor and ``nrows`` is its length.

Column kinds (the JAX package's, minus the time and string kinds the
training slice does not need):
  numeric — float32, NA = NaN
  enum    — int32 category codes + host-side ``domain``, NA = -1
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from ..runtime.backend import resolve_device

__all__ = ["Frame", "Vec", "NA_ENUM"]

NA_ENUM = -1  # NA sentinel for enum codes


class Vec:
    """One column: a device tensor plus host-side metadata."""

    def __init__(self, data: torch.Tensor, kind: str = "numeric",
                 domain: list[str] | None = None, name: str = ""):
        self.data = data
        self.nrows = int(data.shape[0])
        self.kind = kind          # numeric | enum
        self.domain = domain
        self.name = name
        self._rollups: dict[str, float] | None = None

    @staticmethod
    def from_numpy(x, name: str = "", domain=None, kind: str | None = None,
                   device=None) -> "Vec":
        """Host array -> Vec on ``device`` (None = the CUDA card)."""
        x = np.asarray(x)
        dev = resolve_device(device)
        if kind is None:
            kind = "enum" if domain is not None else "numeric"
        if x.dtype.kind == "M" or kind not in ("numeric", "enum"):
            raise NotImplementedError(
                f"column '{name}': only numeric and enum columns are "
                "ported (time/string columns: ROADMAP Queue 1 item 2b)")
        if kind == "enum":
            if x.dtype.kind == "f":  # pre-encoded float codes: NaN is NA
                x = np.where(np.isnan(x), NA_ENUM, x)
            data = torch.as_tensor(x.astype(np.int32), device=dev)
        else:
            data = torch.as_tensor(x.astype(np.float32), device=dev)
        return Vec(data, kind=kind, domain=domain, name=name)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_enum(self) -> bool:
        return self.kind == "enum"

    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    def as_float(self) -> torch.Tensor:
        """The column as float32 with NA -> NaN."""
        if self.kind == "enum":
            return torch.where(self.data == NA_ENUM, float("nan"),
                               self.data.float())
        return self.data

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def rollups(self) -> dict[str, float]:
        """min/max/mean/sigma/nacnt/zeros/rows over the non-NA values
        (the JAX package's ``_rollup_map`` reductions), cached."""
        if self._rollups is None:
            x = self.as_float()
            ok = ~torch.isnan(x)
            xz = torch.where(ok, x, torch.zeros_like(x))
            n = float(ok.sum())
            s = float(xz.sum())
            ss = float((xz * xz).sum())
            mean = s / n if n > 0 else float("nan")
            var = ss / n - mean * mean if n > 1 else 0.0
            self._rollups = dict(
                min=float(torch.where(ok, x, float("inf")).min())
                if n else float("nan"),
                max=float(torch.where(ok, x, float("-inf")).max())
                if n else float("nan"),
                mean=mean,
                sigma=float(np.sqrt(max(var * n / (n - 1), 0.0)))
                if n > 1 else 0.0,
                nacnt=int(self.nrows - n),
                zeros=int((ok & (x == 0.0)).sum()), rows=int(n))
        return self._rollups

    def min(self): return self.rollups()["min"]
    def max(self): return self.rollups()["max"]
    def mean(self): return self.rollups()["mean"]
    def sigma(self): return self.rollups()["sigma"]
    def nacnt(self): return self.rollups()["nacnt"]


class Frame:
    """An ordered collection of equal-length Vecs on one device."""

    def __init__(self, vecs: Mapping[str, Vec] | None = None):
        self._vecs: dict[str, Vec] = dict(vecs or {})
        if len({v.nrows for v in self._vecs.values()}) > 1:
            raise ValueError("ragged columns")
        if len({v.device for v in self._vecs.values()}) > 1:
            raise ValueError("columns on different devices")
        # binned-matrix cache (binned / binning.fused_fit_bins), valid
        # while the content version holds; __setitem__ bumps it
        self._binned_cache: dict = {}
        self._version = 0

    @staticmethod
    def from_arrays(cols: Mapping[str, Any],
                    domains: Mapping[str, list[str]] | None = None,
                    device=None) -> "Frame":
        """Build from {name: array-like} on ``device`` (None = the CUDA
        card; raises without one unless ``device="cpu"``). Object/str
        columns become enums."""
        dev = resolve_device(device)
        domains = dict(domains or {})
        vecs: dict[str, Vec] = {}
        for name, col in cols.items():
            arr = np.asarray(col)
            if name in domains:
                codes = _factorize(arr, domains[name])[0] \
                    if arr.dtype.kind in "OUS" else arr
                vecs[name] = Vec.from_numpy(codes, name, domains[name],
                                            device=dev)
            elif arr.dtype.kind in "OUS":
                codes, domain = _factorize(arr)
                vecs[name] = Vec.from_numpy(codes, name, domain,
                                            device=dev)
            else:
                vecs[name] = Vec.from_numpy(arr.astype(np.float32)
                                            if arr.dtype.kind == "b"
                                            else arr, name, device=dev)
        return Frame(vecs)

    @property
    def names(self) -> list[str]:
        return list(self._vecs)

    @property
    def nrows(self) -> int:
        return next(iter(self._vecs.values())).nrows if self._vecs else 0

    @property
    def device(self) -> torch.device:
        return next(iter(self._vecs.values())).device

    def vec(self, name: str) -> Vec:
        return self._vecs[name]

    def __getitem__(self, name: str) -> Vec:
        return self._vecs[name]

    def __setitem__(self, name: str, vec: Vec):
        if self._vecs and (vec.nrows != self.nrows
                           or vec.device != self.device):
            raise ValueError("nrows or device mismatch")
        self._vecs[name] = vec
        self._binned_cache.clear()
        self._version += 1

    def __contains__(self, name: str) -> bool:
        return name in self._vecs

    def columns(self, names: Iterable[str] | None = None) -> list[Vec]:
        return [self._vecs[n] for n in
                (self.names if names is None else names)]

    def binned(self, bin_spec) -> torch.Tensor:
        """[F, rows] feature-major uint8 bin codes under ``bin_spec``
        (models/tree/binning.BinSpec), cached per frame under the
        content version and a fingerprint of the edges, so a spec fit
        on another frame never collides with this frame's own."""
        import hashlib

        from ..models.tree.binning import bin_frame

        fp = hashlib.sha1(bin_spec.edges_matrix().cpu().numpy().tobytes()
                          + np.array(bin_spec.is_enum).tobytes()
                          ).hexdigest()[:16]
        key = ("binned", tuple(bin_spec.names), bin_spec.n_bins, fp,
               self._version)
        hit = self._binned_cache.get(key)
        if hit is None:
            hit = bin_frame(self, bin_spec)
            self.cache_put(key, hit)
        return hit

    def cache_put(self, key, value) -> None:
        """Two-entry LRU of binned matrices (e.g. a 256-bin and a 64-bin
        working set side by side)."""
        while len(self._binned_cache) >= 2:
            self._binned_cache.pop(next(iter(self._binned_cache)))
        self._binned_cache[key] = value


def _factorize(arr: np.ndarray, domain: list[str] | None = None
               ) -> tuple[np.ndarray, list[str]]:
    """String column -> (int32 codes, sorted vocab). NA is None / float
    NaN cells in object arrays and empty strings (the JAX package's
    rule: literal tokens like "NA" stay categories)."""
    if arr.dtype.kind == "O":
        isna = np.array([x is None or x != x for x in arr], dtype=bool)
    else:
        isna = np.zeros(len(arr), dtype=bool)
    s = np.where(isna, "", arr.astype(str))
    isna |= s == ""
    if domain is None:
        uniq, inv = np.unique(s[~isna], return_inverse=True)
        domain = [str(d) for d in uniq]
        codes = np.full(len(s), NA_ENUM, dtype=np.int32)
        codes[~isna] = inv.astype(np.int32)
    else:
        lookup = {d: i for i, d in enumerate(domain)}
        codes = np.array([lookup.get(x, NA_ENUM) for x in s],
                         dtype=np.int32)
        codes[isna] = NA_ENUM
    return codes, domain
