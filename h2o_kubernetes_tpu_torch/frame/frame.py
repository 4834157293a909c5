"""Frame: a columnar table whose columns are tensors on one device.

The JAX package keeps each column as one row-sharded ``jax.Array``
padded to the mesh's ROWS axis. The port holds a frame on one device —
the CUDA card unless the caller asks for the CPU — so a column is one
unpadded tensor and ``nrows`` is its length. Every Vec an operation
makes lives on its source's device.

On a row group (``runtime/mesh.py``, world size > 1) a frame is built
from the same host data on every rank and each rank keeps only its own
padded row shard (``runtime/mrtask.shard_rows``: rank r holds padded
rows [r·m, (r+1)·m)); ``nrows`` stays the global row count. Padding
rows are NA (NaN, or -1 for enum codes), so NA-aware reductions skip
them and training gives them weight 0 (``Frame.valid_mask``). Rollups
reduce through ``mrtask.doall`` and the numpy accessors gather the
shards and drop the padding; elementwise algebra stays on the shard.
Row operations that move rows between ranks (selection, sorting,
splits, joins, group-by, factoring) raise ``NotImplementedError`` on a
sharded frame.

Column kinds (the JAX package's, minus its host-only string kind):
  numeric — float32, NA = NaN
  enum    — int32 category codes + host-side ``domain``, NA = -1
  time    — float32 epoch-ms RELATIVE to a float64 ``origin`` (the
            column's nanmin), NA = NaN: at 2026 epoch magnitudes a
            float32 ulp is ~131 s, so the shift keeps timestamps exact

Elementwise algebra follows the JAX package's ``jnp`` semantics where
torch's defaults differ: ``//`` is ``jnp.floor_divide`` (NaN on a zero
divisor, round half away from zero), ``sign`` keeps NaN and ``-0.``,
and ``sqrt`` and ``**`` go through float64 (torch's float32 CPU sqrt
is not always correctly rounded; the reference's pow is the C
library's ``powf``, which no torch op reproduces bit for bit).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from ..runtime import mrtask
from ..runtime.backend import resolve_device
from ..runtime.mesh import n_row_shards

__all__ = ["Frame", "Vec", "NA_ENUM"]

NA_ENUM = -1  # NA sentinel for enum codes


def _f32(x, device) -> torch.Tensor:
    """A 0-dim float32 tensor of the Python/numpy scalar ``x``, rounded
    as ``jnp`` rounds a weakly typed scalar into a float32 operation."""
    return torch.tensor(np.float32(x), device=device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: ±1, and NaN and ±0 kept as they are."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``: to the nearest integer, halves away from zero."""
    t = torch.trunc(x)
    return torch.where(torch.abs(x - t) >= 0.5, t + _sign(x), t)


def _floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.floor_divide`` of floats (CPython's float_divmod): NaN on a
    zero divisor, where torch's gives ±inf."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (_sign(b) != _sign(mod))
    return _round_away(torch.where(ind, div - 1.0, div))


def _pow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a ** b`` through float64, so correctly rounded (bar a
    double rounding): the JAX package's CPU pow is the C library's
    ``powf``, within 1 ulp of it, with denormal results flushed."""
    return torch.pow(a.double(), b.double())


def _time_vec(ms: torch.Tensor, name: str) -> "Vec":
    """float64 absolute epoch-ms (NaN = NA) on a device -> a time Vec
    there, as ``Vec.from_numpy(ms, kind="time")`` would build it: the
    origin is the nanmin (NaN when every value is NA), the offsets
    ``(ms - origin)`` rounded to float32 once."""
    if ms.numel() == 0:
        return Vec(ms.to(torch.float32), kind="time", name=name, origin=0.0)
    live = ms[~torch.isnan(ms)]
    origin = float(live.min()) if live.numel() else float("nan")
    return Vec((ms - origin).to(torch.float32), kind="time", name=name,
               origin=origin)


def _rollup_map(x: torch.Tensor) -> dict:
    """One shard's float64 count and sum of the non-NA values, its
    extremes and its zero count."""
    ok = ~torch.isnan(x)
    return {"cnt": ok.sum(dtype=torch.float64),
            "sum": torch.where(ok, x.double(), 0.0).sum(),
            "min": torch.where(ok, x, float("inf")).min(),
            "max": torch.where(ok, x, float("-inf")).max(),
            "zeros": (ok & (x == 0.0)).sum(dtype=torch.float64)}


def _rollup_ss(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """One shard's float64 Σ(x − mean)² over the non-NA values."""
    ok = ~torch.isnan(x)
    return torch.where(ok, (x.double() - mean) ** 2, 0.0).sum()


def _local_only(sharded: bool, what: str) -> None:
    """Refuse a row operation on a row-sharded column."""
    if sharded:
        raise NotImplementedError(
            f"{what} on a row-sharded Frame is not ported (ROADMAP.md, "
            "item 14's Queue 1: munging on a group)")


def _num_str(v) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


class Vec:
    """One column: a device tensor plus host-side metadata. ``nrows``
    given makes it a row shard: ``data`` is this rank's padded shard and
    ``nrows`` the global row count."""

    def __init__(self, data: torch.Tensor, kind: str = "numeric",
                 domain: list[str] | None = None, name: str = "",
                 origin: float = 0.0, nrows: int | None = None):
        self.data = data
        self.sharded = nrows is not None
        self.nrows = int(data.shape[0]) if nrows is None else int(nrows)
        self.kind = kind          # numeric | enum | time
        self.domain = domain
        self.name = name
        self.origin = origin      # time columns: float64 epoch-ms
        self._rollups: dict[str, float] | None = None

    @staticmethod
    def from_numpy(x, name: str = "", domain=None, kind: str | None = None,
                   device=None) -> "Vec":
        """Host array -> Vec on ``device`` (None = the CUDA card).
        ``datetime64`` arrays become time columns. On a row group, this
        rank's padded shard of it."""
        x = np.asarray(x)
        dev = resolve_device(device)
        if kind is None:
            kind = "enum" if domain is not None else \
                "time" if x.dtype.kind == "M" else "numeric"
        if kind not in ("numeric", "enum", "time"):
            raise ValueError(f"column '{name}': unknown kind {kind!r}")
        origin = 0.0
        if kind == "enum":
            if x.dtype.kind == "f":  # pre-encoded float codes: NaN is NA
                x = np.where(np.isnan(x), NA_ENUM, x)
            arr, pad = x.astype(np.int32), NA_ENUM
        elif kind == "time":
            if x.dtype.kind == "M":
                ms = x.astype("datetime64[ms]").astype(np.float64)
                ms[np.isnat(x)] = np.nan  # NaT would otherwise be -2^63
            else:
                ms = x.astype(np.float64)
            origin = float(np.nanmin(ms)) if len(ms) else 0.0
            arr, pad = (ms - origin).astype(np.float32), np.nan
        else:
            arr, pad = x.astype(np.float32), np.nan
        if n_row_shards() > 1:
            return Vec(mrtask.shard_rows(arr, pad, device=dev), kind=kind,
                       domain=domain, name=name, origin=origin,
                       nrows=len(arr))
        return Vec(torch.as_tensor(arr, device=dev), kind=kind,
                   domain=domain, name=name, origin=origin)

    # -- basics ---------------------------------------------------------------

    def __len__(self) -> int:
        return self.nrows

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_enum(self) -> bool:
        return self.kind == "enum"

    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    def as_float(self) -> torch.Tensor:
        """The column as float32 with NA -> NaN. Time columns come back
        as absolute epoch-ms, ``data + f32(origin)`` in float32 (fine
        for binning and models; ``to_numpy`` keeps exact timestamps)."""
        if self.kind == "enum":
            return torch.where(self.data == NA_ENUM, float("nan"),
                               self.data.float())
        if self.kind == "time":
            return self.data + _f32(self.origin, self.device)
        return self.data

    def _abs_ms(self) -> torch.Tensor:
        """A time column as float64 absolute epoch-ms, on its device."""
        return self.data.double() + self.origin

    def to_numpy(self) -> np.ndarray:
        """The whole column on the host (a sharded one gathered from
        every rank, its padding dropped)."""
        d = self._abs_ms() if self.kind == "time" else self.data
        if self.sharded:
            d = mrtask.gather_rows(d)[: self.nrows]
        return d.cpu().numpy()

    def _like(self, data: torch.Tensor) -> "Vec":
        """A Vec of this one's kind, domain, name, origin and row
        layout."""
        return Vec(data, kind=self.kind, domain=self.domain, name=self.name,
                   origin=self.origin,
                   nrows=self.nrows if self.sharded else None)

    def _new(self, data: torch.Tensor, **kw) -> "Vec":
        """A Vec of ``data`` in this one's row layout (an elementwise
        result)."""
        return Vec(data, nrows=self.nrows if self.sharded else None, **kw)

    # -- rollups --------------------------------------------------------------

    def rollups(self) -> dict[str, float]:
        """min/max/mean/sigma/nacnt/zeros/rows over the non-NA values,
        cached. The count, the mean and Σ(x − mean)² are float64 sums
        in two passes on the column's device (``DataInfo`` rounds the
        mean and sigma to float32 once), so the card and the CPU give
        the same float32 statistics; min, max and the counts are the
        JAX package's ``_rollup_map`` reductions. Time columns are
        reduced origin-relative and shifted back (sigma does not
        move)."""
        if self._rollups is not None:
            return self._rollups
        if self.nrows == 0:
            self._rollups = dict(min=float("nan"), max=float("nan"),
                                 mean=float("nan"), sigma=0.0, nacnt=0,
                                 zeros=0, rows=0)
            return self._rollups
        x = self.data if self.kind == "time" else self.as_float()
        # two doall passes (one on a single process): the counts, sums
        # and extremes, then Σ(x − mean)² about the global mean
        first = mrtask.doall(_rollup_map, x, reduce={
            "cnt": "sum", "sum": "sum", "min": "min", "max": "max",
            "zeros": "sum"})
        cnt = first["cnt"]
        mean = first["sum"] / cnt
        ss = mrtask.doall(lambda c: _rollup_ss(c, mean), x)
        stats = torch.stack([
            cnt, mean, ss, first["min"].double(), first["max"].double(),
            first["zeros"]]).cpu().tolist()
        n, mean, ss, lo, hi, zeros = stats
        shift = self.origin if (self.kind == "time" and n) else 0.0
        self._rollups = dict(
            min=(lo + shift) if n else float("nan"),
            max=(hi + shift) if n else float("nan"),
            mean=(mean + shift) if n else float("nan"),
            sigma=float(np.sqrt(ss / (n - 1))) if n > 1 else 0.0,
            nacnt=int(self.nrows - n), zeros=int(zeros), rows=int(n))
        return self._rollups

    def min(self): return self.rollups()["min"]
    def max(self): return self.rollups()["max"]
    def mean(self): return self.rollups()["mean"]
    def sigma(self): return self.rollups()["sigma"]
    def nacnt(self): return self.rollups()["nacnt"]

    # -- row/type ops ---------------------------------------------------------

    def select_rows(self, idx) -> "Vec":
        """New Vec of the rows at ``idx`` (int indices or a bool mask):
        one gather on the column's device. Values pass through
        bit-exactly; time columns keep their origin."""
        return self._gather(torch.as_tensor(_check_index(idx, self.nrows),
                                            device=self.device))

    def _gather(self, idx: torch.Tensor) -> "Vec":
        _local_only(self.sharded, "select_rows")
        out = self._like(self.data.index_select(0, idx))
        if idx.numel() == 0 and self.kind == "time":
            out.origin = 0.0        # an empty time column's origin
        return out

    def asfactor(self) -> "Vec":
        """Numeric -> enum, domain = the sorted distinct values (h2o
        asfactor); time columns factor their exact epoch-ms."""
        if self.is_enum():
            return self
        _local_only(self.sharded, "asfactor")
        x = self._abs_ms() if self.kind == "time" else self.data
        ok = ~torch.isnan(x)
        vals, inv = torch.unique(x[ok], sorted=True, return_inverse=True)
        codes = torch.full((self.nrows,), NA_ENUM, dtype=torch.int32,
                           device=self.device)
        codes[ok] = inv.to(torch.int32)
        domain = [_num_str(v) for v in vals.cpu().numpy()]
        return Vec(codes, kind="enum", domain=domain, name=self.name)

    def asnumeric(self) -> "Vec":
        """Enum -> numeric: the domain labels parsed as numbers where
        they all parse, else the codes (h2o asnumeric)."""
        if not self.is_enum():
            return self
        if not self.domain:  # all-NA enum column
            return self._new(torch.full_like(self.data, float("nan"),
                                             dtype=torch.float32),
                             name=self.name)
        try:
            lut = np.array([float(d) for d in self.domain], dtype=np.float32)
        except ValueError:
            lut = np.arange(len(self.domain), dtype=np.float32)
        lut = torch.as_tensor(lut, device=self.device)
        a = self.data.long()
        out = torch.where(a >= 0, lut[a.clamp(min=0)], float("nan"))
        return self._new(out, name=self.name)

    # -- elementwise algebra (the Rapids expression surface) ------------------

    def _operand(self, other, op: str = "arithmetic") -> torch.Tensor:
        if isinstance(other, Vec):
            if other.nrows != self.nrows:
                raise ValueError("Vec length mismatch "
                                 f"({other.nrows} vs {self.nrows})")
            if other.is_enum():
                raise TypeError(
                    f"{op} is not applicable to enum column "
                    f"'{other.name}' (use asnumeric() first)")
            return other.as_float().to(self.device)
        if isinstance(other, (bool, int, float, np.floating, np.integer)):
            return _f32(float(other), self.device)
        raise TypeError(f"cannot combine Vec with {type(other).__name__}")

    def _arith(self, other, fn, name="") -> "Vec":
        if self.is_enum():
            raise TypeError(f"arithmetic is not applicable to enum column "
                            f"'{self.name}' (use asnumeric() first)")
        a, b = self.as_float(), self._operand(other)
        out = fn(a, b.expand_as(a))
        return self._new(out.to(torch.float32), name=name or self.name)

    def __add__(self, o): return self._arith(o, torch.add)
    def __radd__(self, o): return self._arith(o, lambda a, b: b + a)
    def __sub__(self, o): return self._arith(o, torch.sub)
    def __rsub__(self, o): return self._arith(o, lambda a, b: b - a)
    def __mul__(self, o): return self._arith(o, torch.mul)
    def __rmul__(self, o): return self._arith(o, lambda a, b: b * a)
    def __truediv__(self, o): return self._arith(o, torch.div)
    def __rtruediv__(self, o): return self._arith(o, lambda a, b: b / a)
    def __pow__(self, o): return self._arith(o, _pow)
    def __mod__(self, o): return self._arith(o, torch.remainder)
    def __floordiv__(self, o): return self._arith(o, _floor_divide)
    def __neg__(self): return self._arith(0.0, lambda a, _: -a)

    def _cmp(self, other, fn) -> "Vec":
        if isinstance(other, str):
            # enum == "label": compare codes against the domain index
            # (h2o-py `fr["c"] == "cat"`); an unknown label matches nothing
            if not self.is_enum():
                raise TypeError(
                    f"'{self.name}': string comparison needs an enum column")
            dom = self.domain or []
            code = dom.index(other) if other in dom else -2
            a = torch.where(self.data == NA_ENUM, float("nan"),
                            self.data.float())
            b = _f32(code, self.device)
        else:
            if self.is_enum():
                raise TypeError(
                    f"numeric comparison is not applicable to enum column "
                    f"'{self.name}' (compare against a level string)")
            a, b = self.as_float(), self._operand(other, "comparison")
        res = fn(a, b).to(torch.float32)
        bad = torch.isnan(a) | torch.isnan(b)
        return self._new(torch.where(bad, float("nan"), res),  # NA is NA
                         name=self.name)

    def __lt__(self, o): return self._cmp(o, torch.lt)
    def __le__(self, o): return self._cmp(o, torch.le)
    def __gt__(self, o): return self._cmp(o, torch.gt)
    def __ge__(self, o): return self._cmp(o, torch.ge)
    def __eq__(self, o): return self._cmp(o, torch.eq)       # noqa: E731
    def __ne__(self, o): return self._cmp(o, torch.ne)       # noqa: E731
    __hash__ = None  # mirrors h2o-py: Vecs are expressions, not dict keys

    def _bool(self) -> torch.Tensor:
        """Truth mask with NA -> False (filter semantics)."""
        a = self.as_float()
        return torch.where(torch.isnan(a), 0.0, a) != 0.0

    def __and__(self, o):
        if not isinstance(o, Vec):
            raise TypeError("& needs two Vecs")
        return self._new((self._bool() & o._bool().to(self.device)).float(),
                         name=self.name)

    def __or__(self, o):
        if not isinstance(o, Vec):
            raise TypeError("| needs two Vecs")
        return self._new((self._bool() | o._bool().to(self.device)).float(),
                         name=self.name)

    def __invert__(self):
        return self._new((~self._bool()).float(), name=self.name)

    def _math(self, fn) -> "Vec":
        if self.is_enum():
            raise TypeError(f"math is not applicable to enum column "
                            f"'{self.name}' (use asnumeric() first)")
        return self._new(fn(self.as_float()).to(torch.float32),
                         name=self.name)

    def log(self): return self._math(torch.log)
    def log1p(self): return self._math(torch.log1p)
    def exp(self): return self._math(torch.exp)
    def sqrt(self): return self._math(lambda a: torch.sqrt(a.double()))
    def abs(self): return self._math(torch.abs)
    def floor(self): return self._math(torch.floor)
    def ceil(self): return self._math(torch.ceil)
    def sign(self): return self._math(_sign)

    def unique(self):
        """Distinct non-NA values as a 1-column Frame (h2o unique)."""
        from .munge import unique as _unique
        _local_only(self.sharded, "unique")
        return _unique(self)

    def isna(self) -> "Vec":
        """1.0 where the value is NA (h2o isna)."""
        na = (self.data == NA_ENUM) if self.kind == "enum" \
            else torch.isnan(self.data)
        return self._new(na.float(), name=self.name)


def _check_index(idx, nrows: int) -> np.ndarray:
    """int64 row indices from an int or bool host array, numpy's rules:
    negative indices count from the end, out of range and float indices
    raise."""
    idx = np.asarray(idx)
    if idx.dtype == bool:
        idx = np.flatnonzero(idx)
    elif idx.size and not np.issubdtype(idx.dtype, np.integer):
        raise IndexError(f"select_rows: indices must be integers or "
                         f"booleans, got {idx.dtype}")
    idx = idx.astype(np.int64)
    idx = np.where(idx < 0, idx + nrows, idx)
    if len(idx) and (idx.min() < 0 or idx.max() >= nrows):
        raise IndexError(f"select_rows: index out of range for {nrows} rows")
    return idx


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
        # import_file's CSV reader for this frame: "arrow" | "python"
        self.csv_path: str | None = None

    @staticmethod
    def from_arrays(cols: Mapping[str, Any],
                    domains: Mapping[str, list[str]] | None = None,
                    device=None) -> "Frame":
        """Build from {name: array-like} on ``device`` (None = the CUDA
        card; raises without one unless ``device="cpu"``). Object/str
        columns become enums, ``datetime64`` columns time columns."""
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

    @staticmethod
    def from_pandas(df, device=None) -> "Frame":
        return Frame.from_arrays({c: df[c].to_numpy() for c in df.columns},
                                 device=device)

    # -- basics ---------------------------------------------------------------

    @property
    def names(self) -> list[str]:
        return list(self._vecs)

    @property
    def nrows(self) -> int:
        return next(iter(self._vecs.values())).nrows if self._vecs else 0

    @property
    def ncols(self) -> int:
        return len(self._vecs)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def device(self) -> torch.device:
        return next(iter(self._vecs.values())).device

    @property
    def sharded(self) -> bool:
        """Whether the columns are this rank's row shards."""
        return bool(self._vecs) and next(iter(self._vecs.values())).sharded

    @property
    def local_rows(self) -> int:
        """Rows this process holds: ``nrows``, or its padded shard's."""
        return int(next(iter(self._vecs.values())).data.shape[0]) \
            if self._vecs else 0

    def valid_mask(self) -> torch.Tensor:
        """float32 [local_rows] on the frame's device: 1 for a logical
        row, 0 for a shard's padding."""
        if not self._vecs:
            raise ValueError("valid_mask() on an empty Frame")
        lo = mrtask.shard_bounds(self.nrows)[0] if self.sharded else 0
        return (torch.arange(lo, lo + self.local_rows, device=self.device)
                < self.nrows).to(torch.float32)

    def vec(self, name: str) -> Vec:
        return self._vecs[name]

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._vecs[key]
        if isinstance(key, Vec):
            # boolean row filter: fr[fr["x"] > 0]; NA mask rows drop
            # (h2o-py Rapids row-slice semantics)
            if key.nrows != self.nrows:
                raise ValueError("filter mask length != nrows")
            return self.select_rows(key._bool())
        if isinstance(key, (list, tuple)):
            return Frame({k: self._vecs[k] for k in key})
        raise TypeError(f"bad key {key!r}")

    def __setitem__(self, name: str, vec: Vec):
        if self._vecs and (vec.nrows != self.nrows
                           or vec.device != self.device):
            raise ValueError("nrows or device mismatch")
        self._vecs[name] = vec
        self._binned_cache.clear()
        self._version += 1

    def __contains__(self, name: str) -> bool:
        return name in self._vecs

    def drop(self, names: str | Sequence[str]) -> "Frame":
        if isinstance(names, str):
            names = [names]
        return Frame({k: v for k, v in self._vecs.items() if k not in names})

    def _to(self, device) -> "Frame":
        """This frame's columns copied to ``device``."""
        dev = torch.device(device)
        return Frame({n: v._like(v.data.to(dev))
                      for n, v in self._vecs.items()})

    # -- device views ---------------------------------------------------------

    def columns(self, names: Iterable[str] | None = None) -> list[Vec]:
        return [self._vecs[n] for n in
                (self.names if names is None else names)]

    def to_matrix(self, names: Iterable[str] | None = None) -> torch.Tensor:
        """[rows, k] float32 matrix (enums as raw codes, NA -> NaN)."""
        return torch.stack([v.as_float() for v in self.columns(names)],
                           dim=1)

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

    def to_pandas(self):
        import pandas as pd
        out = {}
        for n, v in self._vecs.items():
            a = v.to_numpy()
            if v.is_enum():
                dom = np.asarray(list(v.domain) + [None], dtype=object)
                out[n] = dom[np.where(a >= 0, a, len(dom) - 1)]
            else:
                out[n] = a
        return pd.DataFrame(out)

    def summary(self) -> dict[str, dict[str, float]]:
        return {n: v.rollups() for n, v in self._vecs.items()}

    # -- row ops --------------------------------------------------------------

    def select_rows(self, idx) -> "Frame":
        """New Frame of the rows at ``idx`` (int indices or a bool mask,
        numpy or a tensor): one gather per column on the frame's
        device."""
        if isinstance(idx, torch.Tensor):
            idx = idx.to(self.device) if self._vecs else idx
            if idx.dtype == torch.bool:
                if idx.shape[0] != self.nrows:
                    raise ValueError("mask length != nrows")
                idx = torch.nonzero(idx).squeeze(1)
            idx = idx.long()
        else:
            idx = np.asarray(idx)
            if idx.dtype == bool and len(idx) != self.nrows:
                raise ValueError("mask length != nrows")
            idx = torch.as_tensor(_check_index(idx, self.nrows),
                                  device=self.device if self._vecs
                                  else None)
        return Frame({n: v._gather(idx) for n, v in self._vecs.items()})

    def head(self, n: int = 10) -> "Frame":
        return self.select_rows(np.arange(min(n, self.nrows)))

    def split_frame(self, ratios: Sequence[float] = (0.75,),
                    seed: int = -1) -> list["Frame"]:
        """Random row split into len(ratios)+1 frames (h2o split_frame):
        one uniform draw per row from numpy's ``default_rng(seed)`` on
        the host against the cumulative ratio boundaries, as the JAX
        package draws them, so the parts are the same rows."""
        _local_only(self.sharded, "split_frame")
        if sum(ratios) >= 1.0:
            raise ValueError("ratios must sum to < 1")
        rng = np.random.default_rng(None if seed < 0 else seed)
        u = rng.random(self.nrows)
        bounds = np.cumsum(list(ratios) + [1.0])
        part = torch.as_tensor(np.searchsorted(bounds, u, side="right"),
                               device=self.device)
        return [self.select_rows(part == k) for k in range(len(bounds))]

    def rbind(self, other: "Frame") -> "Frame":
        """Stack the rows of two column-compatible frames. Enum domains
        merge sorted; time columns re-derive their origin."""
        _local_only(self.sharded or other.sharded, "rbind")
        if self.names != other.names:
            raise ValueError("rbind: column names differ")
        out: dict[str, Vec] = {}
        for n in self.names:
            a, b = self._vecs[n], other._vecs[n]
            if a.kind != b.kind:
                raise ValueError(f"rbind: column '{n}' kinds differ "
                                 f"({a.kind} vs {b.kind})")
            bd = b.data.to(a.device)
            if a.is_enum() and list(a.domain) != list(b.domain):
                dom = sorted(set(a.domain) | set(b.domain))
                pos = {d: i for i, d in enumerate(dom)}

                def remap(v, codes):
                    lut = torch.as_tensor([pos[d] for d in v.domain]
                                          + [NA_ENUM], dtype=torch.int32,
                                          device=a.device)
                    c = codes.long()
                    return lut[torch.where(c < 0, len(lut) - 1, c)]
                out[n] = Vec(torch.cat([remap(a, a.data), remap(b, bd)]),
                             kind="enum", domain=dom, name=n)
            elif a.kind == "time":
                out[n] = _time_vec(torch.cat([a._abs_ms(),
                                              bd.double() + b.origin]), n)
            else:
                out[n] = Vec(torch.cat([a.data, bd]), kind=a.kind,
                             domain=a.domain, name=n)
        return Frame(out)

    def group_by(self, by) -> "Any":
        """h2o-py GroupBy builder: fr.group_by("c").sum("x").get_frame()."""
        from .munge import GroupBy
        _local_only(self.sharded, "group_by")
        return GroupBy(self, by)

    def merge(self, other: "Frame", by=None, all_x: bool = False) -> "Frame":
        """Join on key columns (h2o merge: inner, or left when all_x)."""
        from .munge import merge as _merge
        _local_only(self.sharded or other.sharded, "merge")
        return _merge(self, other, by=by, all_x=all_x)

    def impute(self, column: str, method: str = "mean", by=None):
        """Fill NAs in place (h2o.impute: mean/median/mode, by-groups)."""
        from .munge import impute as _impute
        _local_only(self.sharded, "impute")
        return _impute(self, column, method=method, by=by)

    def table(self, col: str, col2: str | None = None) -> "Frame":
        """Frequency table of 1-2 categorical columns (h2o table)."""
        from .munge import table as _table
        _local_only(self.sharded, "table")
        return _table(self, col, col2)

    def quantile(self, prob=None) -> "Frame":
        """Per-numeric-column quantiles (h2o quantile defaults)."""
        from .munge import quantile as _quantile
        _local_only(self.sharded, "quantile")
        return _quantile(self) if prob is None else _quantile(self, prob)

    def sort(self, by, ascending: bool = True) -> "Frame":
        """Rows ordered by the given column(s) (h2o sort): the JAX
        package's ``np.lexsort`` permutation — stable, NA rows last in
        either direction, descending by negated keys — as one stable
        device sort per key from the last key to the first."""
        _local_only(self.sharded, "sort")
        keys = [by] if isinstance(by, str) else list(by)
        perm = torch.arange(self.nrows, device=self.device)
        for k in reversed(keys):
            v = self._vecs[k]
            if v.is_enum():
                a = v.data.double()
                na = v.data < 0
            else:
                a = v._abs_ms() if v.kind == "time" else v.data.double()
                na = torch.isnan(a)
            # + 0.0 folds -0.0 into 0.0, which lexsort holds equal
            key = torch.where(na, float("inf"), (a if ascending else -a)
                              + 0.0)[perm]
            perm = perm[torch.sort(key, stable=True).indices]
        return self.select_rows(perm)

    def cbind(self, other: "Frame") -> "Frame":
        """Adjoin columns of an equal-length frame (suffix dups like h2o)."""
        if other.nrows != self.nrows:
            raise ValueError("cbind: nrows differ")
        out = dict(self._vecs)
        for n, v in other._vecs.items():
            name = n
            while name in out:
                name += "0"   # h2o suffixes duplicate names
            out[name] = v
        return Frame(out)


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
