"""Feature binning for the histogram tree learners.

Layout (the JAX package's): B total bins per feature, bin B-1 reserved
for NA. Numeric features use quantile edges (at most B-2 finite bins);
categorical features use their codes directly; past B-1 levels,
contiguous code ranges share bins through synthetic numeric edges.

The port stores the binned matrix FEATURE-MAJOR, [F, rows] uint8: a
histogram CTA that reads one feature's codes gets coalesced loads.

Quantile edges match the JAX package bit for bit. Above
``_QUANTILE_SAMPLE`` (65,536) rows both packages fit the edges on a
65,536-row sample drawn with replacement by
``randint(key(0x51BB), (65536,), 0, rows)``: the JAX package with
``jax.random``, the port with its threefry twin (``runtime/prng.py``),
so the samples are the same rows.

On a row group the sample is drawn over the global padded row ids (the
JAX package draws over its padded length too), the same ids on every
rank; each rank fills in the values of the ids it holds and one integer
all-reduce of their bit patterns (every id has one owner, the others
add 0) gives every rank the sample bit for bit, so the edges are the
same on every rank and, where the row count divides evenly, the same as
one process's. Below the sample size the ranks gather their columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...runtime import mrtask, prng
from ...runtime.mesh import global_mesh
from ...runtime.quantile import nanquantile

__all__ = ["BinSpec", "fit_bins", "apply_bins", "bin_frame",
           "fused_fit_bins", "bin_frame_host_chunks", "host_codes_block"]

# above this many rows the quantile edges come from a uniform row sample
_QUANTILE_SAMPLE = 1 << 16
_SAMPLE_SEED = 0x51BB
# columns binned per device pass of ``host_codes_block``: a 128-column
# block of 1,000,000 rows is a 128 MB uint8 transient
_CODES_BLOCK = 128


@dataclass
class BinSpec:
    """Binning model: the [F, B-2] edge matrix (+inf padded) on the
    frame's device, and which features are enums."""

    names: list[str]
    is_enum: list[bool]
    n_bins: int
    edges: torch.Tensor

    @property
    def na_bin(self) -> int:
        return self.n_bins - 1

    def edges_matrix(self) -> torch.Tensor:
        return self.edges


def _check_n_bins(n_bins: int) -> None:
    if not 4 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [4, 256] (uint8 bin codes), "
                         f"got {n_bins}")


def _quantiles(sample: torch.Tensor, n_q: int) -> torch.Tensor:
    """[Fn, n] -> [Fn, n_q] NaN-skipping linear quantiles at the interior
    points of an (n_q + 2)-point linspace over [0, 1] — the arithmetic of
    the JAX package's compiled ``jnp.nanquantile``, so the edges agree
    bitwise: the points are ``i * f32(1 / (n_q + 1))`` (XLA's linspace
    multiplies by the reciprocal), then ``runtime.quantile.nanquantile``
    with this program's contraction, ``fma(lo, lw, hi * hw)``, rounded
    once."""
    div = n_q + 1
    step = torch.tensor(np.float32(1) / np.float32(div), device=sample.device)
    qs = torch.arange(1, div, dtype=torch.float32,
                      device=sample.device) * step            # [n_q]
    return nanquantile(sample, qs, fused="lo")


def _sampled_feature_matrix(num_cols: list[torch.Tensor]) -> torch.Tensor:
    """[Fn, min(n, S)]: the numeric columns, or a with-replacement row
    sample of them past ``_QUANTILE_SAMPLE`` rows (the ONE draw site);
    n counts the padded rows of every rank of the row group."""
    g = global_mesh()
    m = num_cols[0].shape[0]
    n = m * g.world_size
    if n > _QUANTILE_SAMPLE:
        idx = prng.randint(prng.key(_SAMPLE_SEED, num_cols[0].device),
                           (_QUANTILE_SAMPLE,), 0, n)
        if g.world_size == 1:
            return torch.stack([c[idx] for c in num_cols], dim=0)
        loc = idx - g.rank * m
        mine = (loc >= 0) & (loc < m)
        loc = loc.clamp(0, m - 1)
        bits = torch.stack([c[loc] for c in num_cols], dim=0).view(
            torch.int32)
        bits = mrtask.allreduce(torch.where(mine, bits, 0), "sum", g,
                                site="bins")
        return bits.view(torch.float32)
    if g.world_size == 1:
        return torch.stack(num_cols, dim=0)
    return mrtask.gather_rows(torch.stack(num_cols, dim=1), g, "bins").T


def _classify_features(frame, feature_names: list[str], n_bins: int
                       ) -> tuple[list[bool], list[int], list, np.ndarray]:
    """(is_enum, num_idx, num_cols, base): the feature-kind
    classification. ``base`` is the host [F, B-2] +inf edge matrix with
    the range-grouping edges of high-cardinality enums filled in: past
    B-1 levels, n_bins-3 edges between codes split [0, card) into
    n_bins-2 near-equal ranges, and the feature bins as numeric."""
    is_enum: list[bool] = []
    num_idx: list[int] = []
    num_cols = []
    base = np.full((len(feature_names), n_bins - 2), np.inf,
                   dtype=np.float32)
    for name in feature_names:
        v = frame.vec(name)
        if v.is_enum():
            card = v.cardinality()
            if card > n_bins - 1:
                base[len(is_enum), : n_bins - 3] = (
                    np.arange(1, n_bins - 2, dtype=np.float32)
                    * card / (n_bins - 2)) - 0.5
                is_enum.append(False)
                continue
            is_enum.append(True)
            continue
        num_idx.append(len(is_enum))
        num_cols.append(v.as_float())
        is_enum.append(False)
    return is_enum, num_idx, num_cols, base


def fit_bins(frame, feature_names: list[str], n_bins: int = 256) -> BinSpec:
    """Quantile edges per numeric feature, on the frame's device. An
    all-NA column's edges are +inf; tied quantiles are kept (they only
    make empty bins)."""
    _check_n_bins(n_bins)
    is_enum, num_idx, num_cols, base = _classify_features(
        frame, feature_names, n_bins)
    M = torch.as_tensor(base, device=frame.device)
    if num_cols:
        Q = _quantiles(_sampled_feature_matrix(num_cols), n_bins - 3)
        Q = torch.where(torch.isnan(Q), float("inf"), Q)
        M[torch.as_tensor(num_idx, device=M.device), : n_bins - 3] = Q
    return BinSpec(names=list(feature_names), is_enum=is_enum,
                   n_bins=n_bins, edges=M)


def apply_bins(col: torch.Tensor, edges: torch.Tensor, is_enum: bool,
               na_bin: int) -> torch.Tensor:
    """One float column [rows] -> uint8 codes [rows]. Numeric: the
    right-side searchsorted into the feature's edges; enum: the code IS
    the bin. NaN (or a negative enum code) -> the NA bin."""
    if is_enum:
        b = col.clamp(0, na_bin - 1).nan_to_num(0.0).long()
        na = torch.isnan(col) | (col < 0)
    else:
        b = torch.searchsorted(edges.contiguous(), col.contiguous(),
                               right=True)
        na = torch.isnan(col)
    return torch.where(na, na_bin, b).to(torch.uint8)


def bin_frame(frame, bin_spec: BinSpec) -> torch.Tensor:
    """[F, rows] uint8 codes (a row shard's: its local rows), one column
    at a time (the largest float32 transient is one column)."""
    names = bin_spec.names
    edges = bin_spec.edges_matrix()
    out = torch.empty((len(names), frame.local_rows), dtype=torch.uint8,
                      device=frame.device)
    for j, name in enumerate(names):
        out[j] = apply_bins(frame.vec(name).as_float(), edges[j],
                            bin_spec.is_enum[j], bin_spec.na_bin)
    return out


def fused_fit_bins(frame, feature_names: list[str], n_bins: int = 256
                   ) -> tuple[BinSpec, torch.Tensor]:
    """(BinSpec, [F, rows] uint8 codes), cached on the frame under
    (names, n_bins, content version): a second model on the same frame
    pays neither the fit nor the apply. The JAX package fuses the two
    into one XLA dispatch; eager torch has nothing to fuse, so this is
    fit, then apply."""
    _check_n_bins(n_bins)
    key = ("fitbin", tuple(feature_names), n_bins, frame._version)
    hit = frame._binned_cache.get(key)
    if hit is None:
        spec = fit_bins(frame, feature_names, n_bins)
        hit = (spec, bin_frame(frame, spec))
        frame.cache_put(key, hit)
    return hit


def host_codes_block(frame, bin_spec: BinSpec, js, rows: int | None = None
                     ) -> np.ndarray:
    """Bin codes of features ``js`` (indices into ``bin_spec``) as a
    host uint8 [len(js), rows] block, feature-major: ``_CODES_BLOCK``
    columns at a time are binned on the frame's device and copied to the
    host together, so a wide frame never holds a dense [F, rows] matrix
    on the device. ``rows`` keeps the first rows only (the EFB
    planner's sample)."""
    edges = bin_spec.edges_matrix()
    js = list(js)
    n = frame.nrows if rows is None else rows
    out = np.empty((len(js), n), dtype=np.uint8)
    for lo in range(0, len(js), _CODES_BLOCK):
        blk = js[lo: lo + _CODES_BLOCK]
        codes = torch.stack([
            apply_bins(frame.vec(bin_spec.names[j]).as_float()[:n]
                       .contiguous(), edges[j], bin_spec.is_enum[j],
                       bin_spec.na_bin) for j in blk])
        out[lo: lo + len(blk)] = codes.cpu().numpy()
    return out


def bin_frame_host_chunks(frame, bin_spec: BinSpec, chunk_rows: int,
                          pin_memory: bool = False) -> list[torch.Tensor]:
    """The binned matrix as host row chunks for out-of-core training:
    each chunk its own contiguous [F, chunk_rows] uint8 tensor (pinned
    with ``pin_memory``, so a copy to the card can overlap other work),
    allocated once. Columns are binned one at a time on the frame's
    device and copied to the host, so the device holds one float32 and
    one uint8 column at a time. Chunk c holds rows [c·chunk_rows,
    (c+1)·chunk_rows) of ``bin_frame``'s output; rows past the frame's
    end get the NA bin (their weight is 0 downstream)."""
    names = bin_spec.names
    edges = bin_spec.edges_matrix()
    rows = frame.nrows
    n_chunks = -(-rows // chunk_rows)
    bufs = [torch.full((len(names), chunk_rows), bin_spec.na_bin,
                       dtype=torch.uint8, pin_memory=pin_memory)
            for _ in range(n_chunks)]
    for j, name in enumerate(names):
        b = apply_bins(frame.vec(name).as_float(), edges[j],
                       bin_spec.is_enum[j], bin_spec.na_bin).cpu()
        for c in range(n_chunks):
            lo = c * chunk_rows
            hi = min(lo + chunk_rows, rows)
            bufs[c][j, : hi - lo] = b[lo:hi]
    return bufs
