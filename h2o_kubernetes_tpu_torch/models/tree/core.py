"""Flattened tree-ensemble scoring on raw features.

``FlatTrees`` are the compact serving arrays a MOJO-v2 artifact
carries (``flat_*``): per tree, the reachable nodes in BFS slot order,
root = slot 0, right child = left child + 1, with raw-feature
thresholds, so serving never re-bins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FlatTrees", "flat_margin"]

# rounds descended together: bounds the [rounds·K, rows] int64 node
# cursor of one block on very large ensembles
_ROUND_BLOCK = 256


class FlatTrees(NamedTuple):
    """Compact serving ensemble: [T, M] node arrays, M = max reachable
    nodes per tree (BFS slot order, root = slot 0, right = left + 1)."""

    split_feat: torch.Tensor   # int32 [T, M]; -1 marks a leaf
    thresh: torch.Tensor       # f32   [T, M]; go RIGHT iff x >= thresh
    left: torch.Tensor         # int32 [T, M]; left-child slot
    na_left: torch.Tensor      # bool  [T, M]; NaN feature goes left
    value: torch.Tensor        # f32   [T, M]; leaf value (0 on splits)


def flat_margin(flat: FlatTrees, X: torch.Tensor, enum_mask: torch.Tensor,
                levels: int, K: int) -> torch.Tensor:
    """[K, rows] per-class leaf-value sums over an interleaved [T*K]
    flat ensemble, scored on RAW float features (no binning).

    Every tree of a block descends at once (``levels`` gather steps);
    the leaf values are then added round by round into a zeroed
    accumulator — the same per-class f32 addition order as the JAX
    package's ordered scan, so the margins are bitwise-identical."""
    # negative enum codes are NA: canonicalize to NaN once so the
    # descent needs only isnan
    Xc = torch.where(enum_mask[None, :] & (X < 0),
                     torch.full_like(X, float("nan")), X)
    XT = Xc.T                                           # [F, rows]
    TK = flat.split_feat.shape[0]
    rows = X.shape[0]
    sf = flat.split_feat.long()
    lf = flat.left.long()
    total = torch.zeros((K, rows), dtype=torch.float32, device=X.device)
    per_block = max(1, _ROUND_BLOCK // K) * K
    for t0 in range(0, TK, per_block):
        t1 = min(TK, t0 + per_block)
        node = torch.zeros((t1 - t0, rows), dtype=torch.long,
                           device=X.device)
        bsf, blf = sf[t0:t1], lf[t0:t1]
        bth, bnl = flat.thresh[t0:t1], flat.na_left[t0:t1]
        for _ in range(levels):
            f = torch.take_along_dim(bsf, node, dim=1)
            x = torch.take_along_dim(XT, f.clamp(min=0), dim=0)
            go_r = torch.where(torch.isnan(x),
                               ~torch.take_along_dim(bnl, node, dim=1),
                               x >= torch.take_along_dim(bth, node, dim=1))
            node = torch.where(f >= 0,
                               torch.take_along_dim(blf, node, dim=1)
                               + go_r.long(), node)
        val = torch.take_along_dim(flat.value[t0:t1], node, dim=1)
        for r in range(0, t1 - t0, K):
            total = total + val[r:r + K]
    return total
