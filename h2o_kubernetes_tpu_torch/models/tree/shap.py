"""TreeSHAP serving — per-row feature contributions for tree ensembles.

The path-enumeration form of path-dependent TreeSHAP (Lundberg et al.
2018) over per-leaf path tables precomputed from the flattened serving
arrays. Two parts:

1. Host builders, numpy, float64 inside (``_enumerate_paths``,
   ``_pack_tables``, ``build_shap_table_groups``, ``_weight_sums``,
   ``pattern_table``): per-model preparation that must give the same
   arrays as the JAX package's builders, so they are kept line for
   line. Duplicate features on a root→leaf path are MERGED
   (cover-fraction products, conjunction of hot conditions); every
   path is padded to its group depth with (one=1, zero=1) slots,
   which are neutral to the Shapley weights; leaves of the whole
   ensemble pool into virtual trees bucketed by their own merged
   depth, so total work is Σ_leaf depth_leaf.

2. Plain torch evaluators (``flat_shap``, the DP path for groups too
   deep for a pattern table, and ``flat_shap_tab``, the pattern-table
   path). Both run rows-minor ([F+1, rows] accumulator) and add each
   (leaf, slot) term into its feature row in a fixed order — leaves
   outer, slots inner, the virtual tree's bias after its leaves — with
   one ``add_`` per term, never an atomic scatter, so the f32 sum is
   deterministic on every device. ``ops/shap_kernel.py`` holds the
   CUDA kernel of ``flat_shap_tab``, which adds the same values in the
   same order.

Additivity invariant: sum_f phi[:, f] + phi[:, bias] equals the raw
margin of the ensemble (after the caller's scale and init).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ShapTables", "build_shap_table_groups", "flat_shap",
           "flat_shap_tab", "pattern_table"]


class ShapTables(NamedTuple):
    """Per-leaf root→leaf path tables over the flattened serving
    ensemble. All arrays are [T, L, D] (virtual trees × leaves × unique
    path features) except ``leaf_val``/``bias``; hot conditions live in
    RAW feature space (the same thresholds ``flat_margin`` descends).
    Built as numpy arrays; the serving path moves them to the device as
    tensors.

    Padding is self-neutralizing: dummy slots carry (feat=-1,
    lo=-inf, hi=NaN, na_ok=True, z=1) — their one_fraction is 1 for
    every row, so (o - z) = 0; padded leaves carry leaf_val=0."""

    feat: np.ndarray      # int32 [T, L, D]; -1 = padding slot
    lo: np.ndarray        # f32: hot needs x >= lo (-inf = no lower bound)
    hi: np.ndarray        # f32: hot needs NOT x >= hi (NaN = no upper
    #                       bound; -inf = branch unreachable for non-NA)
    na_ok: np.ndarray     # bool: NA rows of `feat` follow this path
    zfrac: np.ndarray     # f32: merged cover-fraction product (1 on pad)
    leaf_val: np.ndarray  # f32 [T, L]; 0 on padded leaves
    bias: np.ndarray      # f32 [T]: per-tree expectation Σ v_l · P(l)


def _enumerate_paths(flat, cover: np.ndarray) -> list[list]:
    """Per tree, the merged per-leaf path entries: a list of
    (merged {feat -> {lo, hi, na, z}}, leaf_value, P_leaf) triples.

    Splits on the SAME feature merge into one slot: zero_fractions
    multiply and the hot condition becomes the interval conjunction of
    the split decisions (`x >= thresh` for every right turn => lo =
    max; its negation for every left turn => hi = min over finite
    thresholds; a NaN threshold is the always-left cut, so a left turn
    there binds nothing and a right turn marks the branch dead for
    non-NA rows, encoded hi = -inf). NA routing stays per-feature via
    ``na`` (conjunction of the learned na_left directions)."""
    sf = np.asarray(flat.split_feat)
    th = np.asarray(flat.thresh).astype(np.float64)
    lf = np.asarray(flat.left)
    nl = np.asarray(flat.na_left).astype(bool)
    val = np.asarray(flat.value).astype(np.float64)
    cov = np.asarray(cover).astype(np.float64)
    T = sf.shape[0]
    per_tree: list[list] = []
    for t in range(T):
        leaves = []
        stack: list[tuple[int, list]] = [(0, [])]
        while stack:
            node, path = stack.pop()
            if len(path) > 64:
                raise ValueError(
                    "malformed flat tree: root→leaf path exceeds 64 "
                    "nodes (cyclic left pointers?)")
            f = int(sf[t, node])
            if f < 0:
                merged: dict[int, dict] = {}
                P = 1.0
                for (d, thr, right, naleft, ratio) in path:
                    P *= ratio
                    e = merged.get(d)
                    if e is None:
                        e = merged[d] = {"lo": -np.inf, "hi": np.nan,
                                         "na": True, "z": 1.0}
                    e["z"] *= ratio
                    e["na"] = e["na"] and \
                        ((not naleft) if right else naleft)
                    if right:
                        if np.isnan(thr):
                            # right past the always-left cut: no non-NA
                            # row can take this branch
                            e["hi"] = -np.inf
                        else:
                            e["lo"] = max(e["lo"], thr)
                    elif not np.isnan(thr):
                        e["hi"] = thr if np.isnan(e["hi"]) \
                            else min(e["hi"], thr)
                leaves.append((merged, float(val[t, node]), P))
                continue
            left = int(lf[t, node])
            cj = max(cov[t, node], 1e-12)
            thr = float(th[t, node])
            naleft = bool(nl[t, node])
            stack.append((left, path + [(f, thr, False, naleft,
                                         float(cov[t, left]) / cj)]))
            stack.append((left + 1, path + [(f, thr, True, naleft,
                                             float(cov[t, left + 1])
                                             / cj)]))
        per_tree.append(leaves)
    return per_tree


def _pack_tables(per_tree: list[list]) -> ShapTables:
    """Pad a group of enumerated trees to its own (L, D) and pack the
    dense numpy arrays."""
    T = len(per_tree)
    L = max(max(len(lv) for lv in per_tree), 1)
    D = max(max((len(m) for m, _, _ in lv), default=0)
            for lv in per_tree)
    D = max(D, 1)
    feat = np.full((T, L, D), -1, dtype=np.int32)
    lo = np.full((T, L, D), -np.inf, dtype=np.float32)
    hi = np.full((T, L, D), np.nan, dtype=np.float32)
    na_ok = np.ones((T, L, D), dtype=bool)
    z = np.ones((T, L, D), dtype=np.float32)
    leaf_val = np.zeros((T, L), dtype=np.float32)
    bias = np.zeros(T, dtype=np.float32)
    for t, leaves in enumerate(per_tree):
        b = 0.0
        for li, (merged, v, P) in enumerate(leaves):
            leaf_val[t, li] = v
            b += v * P
            for si, (d, e) in enumerate(merged.items()):
                feat[t, li, si] = d
                lo[t, li, si] = e["lo"]
                hi[t, li, si] = e["hi"]
                na_ok[t, li, si] = e["na"]
                z[t, li, si] = e["z"]
        bias[t] = b
    return ShapTables(feat, lo, hi, na_ok, z, leaf_val, bias)


# leaves per VIRTUAL tree in the serving groups
_VLEAVES = 32


def build_shap_table_groups(flat, cover: np.ndarray
                            ) -> list[ShapTables]:
    """Bucketed table bundles for the serving kernel: all leaves of the
    ensemble pool together, bucket by their OWN merged path depth D,
    and pack into virtual trees of _VLEAVES leaves each. Group order is
    ascending D, so the cross-group f32 sum order is fixed."""
    per_tree = _enumerate_paths(flat, cover)
    buckets: dict[int, list] = {}
    for leaves in per_tree:
        for leaf in leaves:
            D_l = max(len(leaf[0]), 1)
            buckets.setdefault(D_l, []).append(leaf)
    groups = []
    for D_l in sorted(buckets):
        leaves = buckets[D_l]
        Lv = 1
        while Lv < min(len(leaves), _VLEAVES):
            Lv *= 2
        groups.append(_pack_tables(
            [leaves[i:i + Lv] for i in range(0, len(leaves), Lv)]))
    return groups


# total pattern-table budget PER MODEL, across all depth groups: a
# group that would push the model past it runs the DP path instead
_PATTERN_TABLE_MAX_BYTES = 64 << 20


def _weight_sums(xp, o, z, w0) -> list:
    """EXTEND + per-slot UNWIND-sum Shapley weight recurrence over a
    padded path — shared by the f32 DP evaluator (``flat_shap``,
    xp=torch) and the f64 host pattern-table builder (``pattern_table``,
    xp=np). ``o``/``z`` are length-D sequences of per-slot arrays
    broadcastable against the all-ones ``w0`` (which fixes the working
    shape and dtype). Returns the per-slot weight sums; callers apply
    leaf_val · (o_i − z_i)."""
    D = len(o)
    w = [w0]
    for j in range(D):
        Ln = j + 1
        oj, zj = o[j], z[j]
        nxt = []
        for i in range(j + 2):
            v = None
            if i <= j:
                v = zj * w[i] * ((Ln - i) / (Ln + 1))
            if i >= 1:
                up = oj * w[i - 1] * (i / (Ln + 1))
                v = up if v is None else v + up
            nxt.append(v)
        w = nxt
    totals = []
    for i in range(D):
        oi, zi = o[i], z[i]
        nonzero = oi != 0
        zi_safe = xp.where(zi == 0, 1e-12, zi)
        n = w[D]
        total = xp.zeros_like(w0)
        for jj in range(D - 1, -1, -1):
            tmp = n * ((D + 1) / (jj + 1))
            n = w[jj] - tmp * zi * ((D - jj) / (D + 1))
            w_z = w[jj] * ((D + 1) / (D - jj)) / zi_safe
            total = total + xp.where(nonzero, tmp, w_z)
        totals.append(total)
    return totals


def pattern_table(tables: ShapTables,
                  budget: "int | None" = None) -> "np.ndarray | None":
    """[T, L, D, 2^D] float32 precomputed per-slot contributions
    ``leaf_val · (o_i − z_i) · G_i(pattern)`` for EVERY possible hot
    pattern of a leaf's D slots: one_fractions are binary, so a (row,
    leaf)'s Shapley weight computation collapses to a D-bit pattern
    index and a table lookup. Built host-side in float64. Returns None
    when the table would exceed ``budget`` (default
    _PATTERN_TABLE_MAX_BYTES) or D > 14."""
    feat = np.asarray(tables.feat)
    T, L, D = feat.shape
    P = 1 << D
    if budget is None:
        budget = _PATTERN_TABLE_MAX_BYTES
    if D > 14 or T * L * P * D * 4 > budget:
        return None
    z64 = np.asarray(tables.zfrac).astype(np.float64)
    val64 = np.asarray(tables.leaf_val).astype(np.float64)
    pats = np.arange(P)
    obits = ((pats[:, None] >> np.arange(D)[None, :]) & 1).astype(
        np.float64)                                   # [P, D]
    out = np.zeros((T, L, D, P), dtype=np.float32)
    for t in range(T):
        # [L, 1] zero-fractions x [1, P] hot bits -> [L, P] work shape
        o = [obits[:, i][None, :] for i in range(D)]
        zb = [z64[t][:, i][:, None] for i in range(D)]
        totals = _weight_sums(np, o, zb, np.ones((L, P)))
        for i in range(D):
            out[t, :, i, :] = (val64[t][:, None] * (o[i] - zb[i])
                               * totals[i]).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Plain torch evaluators
# ---------------------------------------------------------------------------

def canonical_xt(X: torch.Tensor, enum_mask: torch.Tensor) -> torch.Tensor:
    """[F, rows] contiguous transposed features with negative enum
    codes rewritten to NaN (the NA canonicalization of flat_margin)."""
    Xc = torch.where(enum_mask[None, :] & (X < 0),
                     torch.full_like(X, float("nan")), X)
    return Xc.T.contiguous()


def _one_fractions(XT, feat, lo, hi, na_ok):
    """[L, D, rows] bool hot indicators from one virtual tree's
    interval tables over the transposed [F, rows] features. `x >= NaN`
    is False for every x, so the NaN no-upper-bound sentinel needs no
    isnan, and a NaN feature fails both comparisons (the NA branch is
    a plain OR)."""
    x = XT[feat.clamp(min=0).long()]                  # [L, D, rows]
    hot = (x >= lo[..., None]) & ~(x >= hi[..., None])
    return (torch.isnan(x) & na_ok[..., None]) | hot


def _ordered_add(phi, tgt: list, contrib) -> None:
    """phi[tgt[l][d]] += contrib[l, d] for l, then d, in that order —
    one in-place row add per term (no atomics, fixed f32 order)."""
    for l, row in enumerate(tgt):
        for d, j in enumerate(row):
            phi[j].add_(contrib[l, d])


def _targets(feat, F: int) -> list:
    """Host [T][L][D] accumulator rows: padding slots go to the bias
    row F (their contribution is exactly 0)."""
    return torch.where(feat < 0, F, feat).tolist()


def flat_shap(tables: ShapTables, X: torch.Tensor,
              enum_mask: torch.Tensor) -> torch.Tensor:
    """[rows, F+1] path-dependent TreeSHAP contributions on RAW
    features (last column = the sum of per-tree expected values; the
    caller scales and adds init). The DP path: per (row, leaf) the
    EXTEND recurrence runs over the D padded slots and each slot's
    UNWIND-sum uses the binary-one_fraction simplification."""
    XT = canonical_xt(X, enum_mask)
    F, rows = XT.shape
    T, Lv, D = tables.feat.shape
    tgt = _targets(tables.feat, F)
    phi = torch.zeros((F + 1, rows), dtype=torch.float32, device=X.device)
    ones = torch.ones((Lv, rows), dtype=torch.float32, device=X.device)
    for t in range(T):
        ob = _one_fractions(XT, tables.feat[t], tables.lo[t],
                            tables.hi[t], tables.na_ok[t]).float()
        o = [ob[:, j, :] for j in range(D)]
        zb = [tables.zfrac[t][:, j, None] for j in range(D)]
        totals = _weight_sums(torch, o, zb, ones)
        contrib = torch.stack(
            [tables.leaf_val[t][:, None] * (o[i] - zb[i]) * totals[i]
             for i in range(D)], dim=1)              # [L, D, rows]
        _ordered_add(phi, tgt[t], contrib)
        phi[F].add_(tables.bias[t])
    return phi.T


def flat_shap_tab(tables: ShapTables, ctab: torch.Tensor,
                  X: torch.Tensor, enum_mask: torch.Tensor
                  ) -> torch.Tensor:
    """The pattern-table path of ``flat_shap`` (same [rows, F+1]
    contract): per (row, leaf) only the D hot bits are computed, folded
    into a pattern index (bit d = slot d), and the precomputed per-slot
    contributions ``ctab[t, l, :, pattern]`` are added into phi in
    leaf-then-slot order, then the virtual tree's bias into row F.

    This is the plain version of the CUDA kernel
    ``ops/shap_kernel.flat_shap_tab_kernel``: the same f32 values are
    added in the same order."""
    XT = canonical_xt(X, enum_mask)
    F, rows = XT.shape
    T, L, D = tables.feat.shape
    tgt = _targets(tables.feat, F)
    phi = torch.zeros((F + 1, rows), dtype=torch.float32, device=X.device)
    shifts = torch.arange(D, device=X.device)[None, :, None]
    for t in range(T):
        o = _one_fractions(XT, tables.feat[t], tables.lo[t],
                           tables.hi[t], tables.na_ok[t])
        pat = (o.long() << shifts).sum(dim=1)        # [L, rows]
        contrib = torch.take_along_dim(ctab[t], pat[:, None, :],
                                       dim=2)         # [L, D, rows]
        _ordered_add(phi, tgt[t], contrib)
        phi[F].add_(tables.bias[t])
    return phi.T
