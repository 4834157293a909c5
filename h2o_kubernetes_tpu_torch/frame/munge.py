"""Group-by aggregation, joins, impute, table, quantile and unique — the
Rapids munging surface (h2o-py's ``H2OFrame.group_by``, ``h2o.merge``,
``impute``, ``table``, ``quantile``, ``unique``), on the frame's device.

The JAX package's semantics, with one device and no mesh:
- ``GroupBy`` segment-sums each statistic into a dense [G] accumulator
  over a mixed-radix composite key (G = the product of the key
  cardinalities, each with one NA bucket) with ``index_add_`` (float64,
  rounded to float32 once: the reference sums in float32, whose drift
  over thousands of rows a group depends on the order of the adds) and
  ``scatter_reduce`` (min, max); the per-group arithmetic after the
  sums is the reference's, in float32 numpy on the host.
- ``merge`` resolves matches on the host as the reference does (keys
  re-encoded to a shared vocabulary, a stable sort and searchsorted),
  then gathers every column on the device.
- ``impute`` takes its fill value from the reference's host arithmetic
  and fills on the device; ``quantile`` is ``jnp.nanquantile`` as XLA
  compiles it (``runtime/quantile.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..runtime.quantile import nanquantile
from .frame import NA_ENUM, Frame, Vec, _time_vec


class GroupBy:
    """Builder collecting aggregate specs, h2o-py style:

        g = fr.group_by("c1").sum("x").mean(["x", "y"]).count()
        out = g.get_frame()

    Aggregate columns are named ``<stat>_<col>`` (count -> ``nrow``).
    """

    def __init__(self, frame: Frame, by):
        self._fr = frame
        self._by = [by] if isinstance(by, str) else list(by)
        for k in self._by:
            if k not in frame:
                raise KeyError(f"group_by key '{k}' not in frame")
        self._aggs: list[tuple[str, str]] = []   # (stat, col)

    def _add(self, stat: str, cols) -> "GroupBy":
        if cols is None:
            raise ValueError(f"{stat}() needs a column name")
        for c in ([cols] if isinstance(cols, str) else cols):
            if c not in self._fr:
                raise KeyError(f"column '{c}' not in frame")
            if self._fr.vec(c).is_enum():
                raise ValueError(f"cannot aggregate enum column '{c}'")
            self._aggs.append((stat, c))
        return self

    def sum(self, col=None): return self._add("sum", col)
    def mean(self, col=None): return self._add("mean", col)
    def min(self, col=None): return self._add("min", col)
    def max(self, col=None): return self._add("max", col)
    def sd(self, col=None): return self._add("sd", col)
    def var(self, col=None): return self._add("var", col)

    def count(self) -> "GroupBy":
        self._aggs.append(("nrow", ""))
        return self

    @property
    def frame(self) -> Frame:
        return self.get_frame()

    def get_frame(self) -> Frame:
        fr = self._fr
        dev = fr.device
        # mixed-radix composite key over the (factorized) key columns;
        # one extra bucket per key for NA groups (h2o keeps NA groups)
        key_vecs = [fr.vec(k) if fr.vec(k).is_enum() else
                    fr.vec(k).asfactor() for k in self._by]
        cards = [len(v.domain) + 1 for v in key_vecs]
        G = int(np.prod(cards))
        combined = torch.zeros(fr.nrows, dtype=torch.int64, device=dev)
        for v, card in zip(key_vecs, cards):
            code = torch.where(v.data == NA_ENUM, card - 1, v.data).long()
            combined = combined * card + code

        def seg(vals):
            # float64 accumulators, rounded to float32 once: the sum of
            # float32 values does not depend on the order the atomics
            # add them in, so the card and the CPU agree
            return torch.zeros(G, dtype=torch.float64, device=dev
                               ).index_add_(0, combined, vals.double()
                                            ).to(torch.float32)

        def segext(x, ok, how, fill):
            v = torch.where(ok, x, fill)
            out = torch.full((G,), fill, dtype=torch.float32, device=dev
                             ).scatter_reduce_(0, combined, v, reduce=how)
            # the reference's segment_min/max: an infinite result (an
            # empty group, or a real ±inf) reads as the fill
            return torch.where(torch.isfinite(out), out, fill)

        acc = {"nrow": seg(torch.ones(fr.nrows, device=dev))}
        for name in sorted({c for _, c in self._aggs if c}):
            x = fr.vec(name).as_float()
            ok = ~torch.isnan(x)
            xz = torch.where(ok, x, 0.0)
            acc[f"cnt_{name}"] = seg(ok.float())
            acc[f"sum_{name}"] = seg(xz)
            acc[f"ssq_{name}"] = seg(xz * xz)
            acc[f"min_{name}"] = segext(x, ok, "amin", float("inf"))
            acc[f"max_{name}"] = segext(x, ok, "amax", float("-inf"))
        acc = {k: v.cpu().numpy() for k, v in acc.items()}

        live = np.flatnonzero(acc["nrow"] > 0)       # groups present
        # decode composite ids back into per-key label columns
        out_cols: dict[str, np.ndarray] = {}
        rem = live.copy()
        for k, card in zip(reversed(self._by), reversed(cards)):
            code = rem % card
            rem = rem // card
            out_cols[k] = np.where(code == card - 1, NA_ENUM,
                                   code).astype(np.int32)
        vecs: dict[str, Vec] = {}
        for k, v in zip(self._by, key_vecs):
            kv = Vec.from_numpy(out_cols[k], k, domain=v.domain, device=dev)
            if not fr.vec(k).is_enum():
                # a numeric key was factorized only for segmenting: give
                # it back as numbers (h2o GroupBy keeps key types)
                kv = kv.asnumeric()
            vecs[k] = kv
        result = Frame(vecs)

        for stat, c in self._aggs:
            if stat == "nrow":
                result["nrow"] = Vec.from_numpy(
                    acc["nrow"][live].astype(np.float32), "nrow",
                    device=dev)
                continue
            cnt = acc[f"cnt_{c}"][live]
            s = acc[f"sum_{c}"][live]
            with np.errstate(invalid="ignore", divide="ignore"):
                if stat == "sum":
                    col = s
                elif stat == "mean":
                    col = np.where(cnt > 0, s / cnt, np.nan)
                elif stat in ("sd", "var"):
                    mean = np.where(cnt > 0, s / cnt, np.nan)
                    var = acc[f"ssq_{c}"][live] / cnt - mean * mean
                    var = np.where(cnt > 1, var * cnt / (cnt - 1), np.nan)
                    col = np.sqrt(np.maximum(var, 0)) if stat == "sd" \
                        else np.maximum(var, 0)
                else:                                 # min / max
                    col = acc[f"{stat}_{c}"][live]
                    col = np.where(cnt > 0, col, np.nan)
            result[f"{stat}_{c}"] = Vec.from_numpy(
                col.astype(np.float32), f"{stat}_{c}", device=dev)
        return result.sort(self._by)


# -- merge --------------------------------------------------------------------

def _key_codes(vl: Vec, vr: Vec) -> tuple[np.ndarray, np.ndarray, int]:
    """Encode one key column from both frames against a shared vocab:
    (left_codes, right_codes, cardinality) with NA -> card-1 (its own
    value: h2o merge matches NA to NA)."""
    if vl.is_enum() != vr.is_enum():
        raise ValueError(f"merge key '{vl.name}': enum vs numeric")
    if vl.is_enum():
        dom = sorted(set(vl.domain or []) | set(vr.domain or []))
        pos = {d: i for i, d in enumerate(dom)}

        def enc(v):
            lut = np.array([pos[d] for d in (v.domain or [])] + [len(dom)],
                           dtype=np.int64)
            c = v.to_numpy().astype(np.int64)
            return lut[np.where(c < 0, len(lut) - 1, c)]

        return enc(vl), enc(vr), len(dom) + 1
    a, b = vl.to_numpy().astype(np.float64), vr.to_numpy().astype(np.float64)
    vals = np.unique(np.concatenate([a[~np.isnan(a)], b[~np.isnan(b)]]))

    def enc(x):
        c = np.searchsorted(vals, x)
        return np.where(np.isnan(x), len(vals), c).astype(np.int64)

    return enc(a), enc(b), len(vals) + 1


def merge(left: Frame, right: Frame, by=None, all_x: bool = False) -> Frame:
    """Inner (or left, when all_x) join on shared key columns."""
    if by is None:
        by = [c for c in left.names if c in right.names]
    by = [by] if isinstance(by, str) else list(by)
    if not by:
        raise ValueError("merge: no common key columns")

    lk = np.zeros(left.nrows, dtype=np.int64)
    rk = np.zeros(right.nrows, dtype=np.int64)
    for k in by:
        cl, cr, card = _key_codes(left.vec(k), right.vec(k))
        lk = lk * card + cl
        rk = rk * card + cr

    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, side="left")
    hi = np.searchsorted(rs, lk, side="right")
    cnt = hi - lo
    if all_x:
        cnt = np.maximum(cnt, 1)             # unmatched left rows survive
    li = np.repeat(np.arange(left.nrows), cnt)
    # right row index per output row; -1 marks an unmatched left-join row:
    # output row j of left row i maps to sorted right position
    # lo[i] + (j - start[i])
    total = int(cnt.sum())
    pos = np.cumsum(cnt) - cnt                    # output start per row
    offset = np.arange(total) - np.repeat(pos, cnt)
    src = np.repeat(lo, cnt) + offset
    matched_row = np.repeat(hi > lo, cnt)
    ri = np.where(matched_row, order[np.minimum(src, len(order) - 1)]
                  if len(order) else -1, -1)

    out = left.select_rows(li)
    dev = out.device if out.ncols else left.device
    ri_t = torch.as_tensor(ri, device=dev)
    hit = ri_t >= 0
    safe = ri_t.clamp(min=0)
    for name in right.names:
        if name in by:
            continue
        v = right.vec(name)
        if v.nrows:
            src_v = v.data.to(dev)[safe]
        else:
            src_v = torch.zeros(len(ri), dtype=v.data.dtype, device=dev)
        if v.is_enum():
            nv = Vec(torch.where(hit, src_v, NA_ENUM).to(torch.int32),
                     kind="enum", domain=v.domain, name=name)
        elif v.kind == "time":
            nv = _time_vec(torch.where(hit, src_v.double() + v.origin,
                                       float("nan")), name)
        else:
            nv = Vec(torch.where(hit, src_v, float("nan")), name=name)
        n = name
        while n in out:
            n += "0"                          # cbind-style dedup suffix
        out[n] = nv
    return out


# -- impute / table / quantile / unique ---------------------------------------

def impute(frame: Frame, column: str, method: str = "mean",
           by=None) -> float | str:
    """Fill NAs in ``column`` in place; returns the fill value used (or
    the per-group fill vector's mean when ``by`` is given).

    method: mean | median (numeric) | mode (enum). ``by`` (mean only):
    group-wise fill from the group means, NA groups fall back to the
    global mean. The fill values are the JAX package's host arithmetic
    (numpy's float32 ``nanmean``, its ``nanmedian``, float64 group sums)
    on a copy of the column; the fill itself runs on the device. A time
    column stays time (its origin re-derived, as the reference's)."""
    v = frame.vec(column)
    if method not in ("mean", "median", "mode"):
        raise ValueError(f"unknown impute method '{method}'")
    dev = v.device
    if v.is_enum():
        if method != "mode":
            raise ValueError(f"impute '{column}': categorical columns "
                             "impute with method='mode'")
        codes = v.data.long()
        counts = torch.bincount(codes[codes >= 0],
                                minlength=v.cardinality())
        fill = int(torch.argmax(counts))
        out = torch.where(codes < 0, fill, codes).to(torch.int32)
        frame[column] = Vec(out, kind="enum", domain=v.domain, name=column)
        return (v.domain or [])[fill]
    x = v.to_numpy()
    if by is not None:
        if method != "mean":
            raise ValueError("grouped impute supports method='mean'")
        by = [by] if isinstance(by, str) else list(by)
        if len(by) != 1:
            raise ValueError("impute by= takes one grouping column")
        g = frame.vec(by[0])
        if not g.is_enum():
            raise ValueError(f"impute by='{by[0]}': must be categorical")
        G = g.cardinality()
        codes = g.to_numpy().astype(np.int64)
        ok = ~np.isnan(x) & (codes >= 0)
        s = np.bincount(codes[ok], weights=x[ok], minlength=G)
        c = np.bincount(codes[ok], minlength=G)
        gmean = np.divide(s, c, out=np.full(G, np.nan), where=c > 0)
        glob = float(np.nanmean(x)) if np.any(~np.isnan(x)) else 0.0
        gmean = np.where(np.isnan(gmean), glob, gmean)
        # the fill per row: its group's mean, the global mean for an NA
        # group; gathered on the device from the G + 1 means
        lut = torch.as_tensor(np.append(gmean, glob), device=dev)
        gc = g.data.long()
        fill_vec = lut[torch.where(gc >= 0, gc, G)]
        _fill(frame, column, v, fill_vec)
        return float(np.mean(gmean))
    if not np.any(~np.isnan(x)):
        fill = 0.0
    elif method == "mean":
        fill = float(np.nanmean(x))
    else:
        fill = float(np.nanmedian(x))
    _fill(frame, column, v, torch.tensor(fill, dtype=torch.float64,
                                         device=dev))
    return fill


def _fill(frame: Frame, column: str, v: Vec, fill: torch.Tensor) -> None:
    """``frame[column]`` = v with its NAs replaced by the float64
    ``fill`` (a scalar or one per row): rounded to float32 for a numeric
    column, as the reference's ``np.where`` + ``from_numpy`` rounds it;
    a time column filled in absolute float64 epoch-ms."""
    if v.kind == "time":
        ms = v._abs_ms()
        frame[column] = _time_vec(torch.where(torch.isnan(ms), fill, ms),
                                  column)
        return
    frame[column] = Vec(torch.where(torch.isnan(v.data),
                                    fill.to(torch.float32), v.data),
                        name=column)


def table(frame: Frame, col: str, col2: str | None = None) -> Frame:
    """Frequency table of one or two categorical columns -> Frame with
    the level column(s) + 'Count' (NA rows excluded, zero rows left out,
    h2o table semantics). Counted on the device."""
    v1 = frame.vec(col)
    if not v1.is_enum():
        raise ValueError(f"table: '{col}' must be categorical")
    dev = v1.device
    c1 = v1.data.long()
    d1 = list(v1.domain or [])
    if col2 is None:
        cnt = torch.bincount(c1[c1 >= 0], minlength=len(d1)).cpu().numpy()
        keep = cnt > 0
        out = Frame()
        out[col] = Vec.from_numpy(np.flatnonzero(keep).astype(np.int32),
                                  col, domain=d1, device=dev)
        out["Count"] = Vec.from_numpy(cnt[keep].astype(np.float32),
                                      "Count", device=dev)
        return out
    v2 = frame.vec(col2)
    if not v2.is_enum():
        raise ValueError(f"table: '{col2}' must be categorical")
    c2 = v2.data.long()
    d2 = list(v2.domain or [])
    ok = (c1 >= 0) & (c2 >= 0)
    flat = c1[ok] * len(d2) + c2[ok]
    cnt = torch.bincount(flat, minlength=len(d1) * len(d2)).cpu().numpy()
    keep = cnt > 0
    lv = np.flatnonzero(keep)
    out = Frame()
    out[col] = Vec.from_numpy((lv // len(d2)).astype(np.int32), col,
                              domain=d1, device=dev)
    out[col2] = Vec.from_numpy((lv % len(d2)).astype(np.int32), col2,
                               domain=d2, device=dev)
    out["Count"] = Vec.from_numpy(cnt[keep].astype(np.float32), "Count",
                                  device=dev)
    return out


def quantile(frame: Frame, prob: Sequence[float] = (
        0.001, 0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9, 0.99,
        0.999)) -> Frame:
    """Per-numeric-column quantiles -> Frame with 'Probs' + one column
    per numeric input: ``jax.jit(jnp.nanquantile)`` over the whole
    column as XLA compiles it (one stable sort, ``fma(hi, hw, lo·lw)``
    rounded once), on the frame's device."""
    probs = np.asarray(list(prob), dtype=np.float32)
    if probs.size == 0 or np.any((probs < 0) | (probs > 1)):
        raise ValueError("quantile probs must be in [0, 1]")
    dev = frame.device
    out = Frame()
    out["Probs"] = Vec.from_numpy(probs, "Probs", device=dev)
    qs = torch.as_tensor(probs, device=dev)
    for name in frame.names:
        v = frame.vec(name)
        if v.is_enum():
            continue
        out[name] = Vec(nanquantile(v.as_float(), qs, fused="hi"),
                        name=name)
    if out.ncols == 1:
        raise ValueError("quantile: frame has no numeric columns")
    return out


def unique(vec: Vec) -> Frame:
    """Distinct non-NA values of one column as a single-column Frame,
    sorted (time columns: their exact epoch-ms, rounded to float32)."""
    out = Frame()
    if vec.is_enum():
        codes = vec.data
        lv = torch.unique(codes[codes >= 0], sorted=True)
        out[vec.name or "C1"] = Vec(lv.to(torch.int32), kind="enum",
                                    domain=vec.domain, name=vec.name)
        return out
    x = vec._abs_ms() if vec.kind == "time" else vec.data
    vals = torch.unique(x[~torch.isnan(x)], sorted=True)
    out[vec.name or "C1"] = Vec(vals.to(torch.float32), name=vec.name)
    return out
