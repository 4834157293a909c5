"""The tree core: histogram tree growing, the GBM loops (every
distribution of the JAX package: bernoulli, gaussian, poisson, gamma,
tweedie, laplace, quantile, huber and multinomial) and the DRF loop,
leaf assignment, and flattened tree-ensemble scoring on raw features.

Growing (the JAX package's ``_grow_tree_shard``, on one device) grows
T trees at once against one binned matrix: per level every live row's
(g·w, h·w, w) is added, per tree, into a per-node, per-feature, per-bin
histogram (``ops/histogram.build_histogram``, one batched CUDA kernel
launch for all T trees on a card), and the best split per node is an
argmax over (feature, bin) among the node's allowed features (a
per-tree column sample and DRF's per-node ``mtries`` draw). Binomial
GBM grows T=1; multinomial GBM the K class trees of a round; DRF a
group of G forest trees. Every random draw is the JAX package's, from
the threefry twin (``runtime/prng.py``). Rows carry a relative node
id, -1 once dead; trees are dense heaps padded to ``max_depth`` (node
i has children 2i+1, 2i+2).
Split semantics: ``bin <= split_bin`` goes left; the NA bin is the last
bin and ``na_left`` records the learned NA direction. The binned matrix
is feature-major, [F, rows] uint8.

Exclusive Feature Bundling (``efb``, an ``efb.EFBLuts``): the binned
matrix is then the bundled one, [Fb, rows], and so are the histograms;
``_find_splits_efb`` scores every bundle slot as the original (feature,
bin) cut it encodes and returns the winner decoded, and
``row_orig_bins`` decodes a row's slot back to its original bin, so
trees never name a bundle. Column masks and ``mtries`` stay in the
original feature space.

GOSS (``BoostParams.goss_b > 0``): per round the rows are ranked by
|g| through layout-invariant global statistics (the max and an int32
count histogram) and a per-row threefry draw keyed by (round key, row
id); the selected rows, their weights amplified, are compacted into a
static [F, cap] buffer on the device (a cumsum-position scatter, no
host sync), the tree grows over that buffer, and every row re-descends
the tree for the margin update. The chunked out-of-core path
(``ooc.py``) picks the same rows.

The JAX package sums each level's histograms over its row shards
(``lax.psum``); the port sums on one device in another f32 order, so
trees agree bitwise only where every sum is exact (dyadic gradients and
weights; DRF's integer counts) and within f32 rounding elsewhere. Row
sampling folds the shard index into its key: the port draws as shard 0
of a one-shard mesh.

``FlatTrees`` are the compact serving arrays a MOJO-v2 artifact
carries (``flat_*``): per tree, the reachable nodes in BFS slot order,
root = slot 0, right child = left child + 1, with raw-feature
thresholds, so serving never re-bins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import hist_bytes_budget
from ...ops.histogram import build_histogram, expand_unit_hess
from ...runtime import prng
from ...runtime.quantile import nanquantile

__all__ = ["TreeParams", "Tree", "BoostParams", "grow_tree",
           "boost_trees", "boost_trees_multi", "boost_trees_drf",
           "draws_random", "drf_group_size", "level_hist_bytes", "descend_tree",
           "descend_trees", "stack_predict", "huber_delta",
           "predict_tree", "flatten_trees",
           "flatten_cover", "FlatTrees", "flat_margin", "row_orig_bins",
           "goss_round_keys", "goss_cap_rows", "goss_rank_stat",
           "goss_local_counts", "goss_threshold", "goss_row_factor",
           "goss_amplified_w", "goss_compact"]

# rounds descended together: bounds the [rounds·K, rows] int64 node
# cursor of one block on very large ensembles
_ROUND_BLOCK = 256


class TreeParams(NamedTuple):
    max_depth: int = 5
    n_bins: int = 256
    min_rows: float = 10.0          # min rows per leaf (weighted counts)
    reg_lambda: float = 0.0
    reg_alpha: float = 0.0
    gamma: float = 0.0              # min split gain improvement
    min_child_weight: float = 0.0   # min hessian mass per child
    unit_hess: bool = False         # h ≡ 1 loss: 2-channel histograms
    mtries: int = -1                # features drawn per node (DRF); <= 0 all


class Tree(NamedTuple):
    """Dense heap tree: node i has children 2i+1, 2i+2; [N] = 2^(d+1)-1
    (a leading [T] axis when stacked)."""

    split_feat: torch.Tensor   # int32, -1 for leaves
    split_bin: torch.Tensor    # int32
    na_left: torch.Tensor      # bool, NA direction
    is_split: torch.Tensor     # bool
    value: torch.Tensor        # f32 leaf value (valid where not split)
    gain: torch.Tensor         # f32 split gain (varimp)
    cover: torch.Tensor        # f32 training weight mass at the node


def _soft_thresh(g, alpha):
    # with alpha 0 the threshold is g + 0 bit for bit (sign(g)·|g|, with
    # -0 made +0): one elementwise pass over every candidate, not four
    if alpha == 0:
        return g + 0.0
    return torch.sign(g) * torch.clamp(torch.abs(g) - alpha, min=0.0)


def _leaf_value(G, H, p: TreeParams):
    return -_soft_thresh(G, p.reg_alpha) / (H + p.reg_lambda + 1e-10)


def _gain_term(G, H, p: TreeParams):
    s = _soft_thresh(G, p.reg_alpha)
    return s * s / (H + p.reg_lambda + 1e-10)


def _split_gains(left, tot4, p: TreeParams):
    """Split gain of every candidate's left stats [..., 3] against the
    node totals ``tot4`` [n, 1, 1, 3]; -inf where a side is too small."""
    right = tot4 - left
    parent = _gain_term(tot4[..., 0], tot4[..., 1], p)
    raw = _gain_term(left[..., 0], left[..., 1], p) \
        + _gain_term(right[..., 0], right[..., 1], p) - parent
    ok = (left[..., 2] >= p.min_rows) & (right[..., 2] >= p.min_rows)
    if p.min_child_weight > 0:
        ok &= (left[..., 1] >= p.min_child_weight) & \
            (right[..., 1] >= p.min_child_weight)
    return torch.where(ok, raw, float("-inf"))


def _find_splits(hist, p: TreeParams, feat_ok=None, efb=None):
    """Best split per node from a [n_nodes, F, B, 3] histogram (with
    ``efb``, a bundled [n_nodes, Fb, B, 3] one: ``_find_splits_efb``).

    Every (feature, threshold-bin) cut is scored with the NA bin (last)
    on each side in turn, over the features ``feat_ok`` ([n_nodes, F]
    bool, None = all) allows; the argmax runs over the feature-major,
    bin-minor flattening and the first maximum wins. Returns (feat, bin,
    na_left, can_split, node_value, best_gain, cover, left, right);
    left/right are the chosen split's side totals [n, 3], which are the
    children's node totals."""
    if efb is not None:
        return _find_splits_efb(hist, p, efb, feat_ok)
    nb = hist.shape[2]
    na = hist[:, :, nb - 1, :]                          # [n, F, 3]
    cum = torch.cumsum(hist[:, :, : nb - 1, :], dim=2)  # left, NA excluded
    totn = (cum[:, :, -1, :] + na)[:, 0:1, :]           # [n, 1, 3]
    tot4 = totn[:, :, None, :]                          # [n, 1, 1, 3]
    cum_na = cum + na[:, :, None, :]
    gain_na_r = _split_gains(cum, tot4, p)              # NA goes right
    gain_na_l = _split_gains(cum_na, tot4, p)           # NA goes left
    na_left_better = gain_na_l > gain_na_r
    gain = torch.maximum(gain_na_l, gain_na_r)          # [n, F, B-1]
    if feat_ok is not None:
        gain = torch.where(feat_ok[:, :, None], gain, float("-inf"))
    n_nodes, F = gain.shape[0], gain.shape[1]
    flat = gain.reshape(n_nodes, F * (nb - 1))
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    feat = (best // (nb - 1)).to(torch.int32)
    bin_ = (best % (nb - 1)).to(torch.int32)
    na_l = na_left_better.reshape(n_nodes, -1).gather(1, best[:, None])[:, 0]

    def pick(left4):                                    # -> [n, 3]
        return left4.reshape(n_nodes, F * (nb - 1), 3).gather(
            1, best[:, None, None].expand(-1, 1, 3))[:, 0]

    left = torch.where(na_l[:, None], pick(cum_na), pick(cum))
    right = totn[:, 0, :] - left
    G, H, C = totn[:, 0, 0], totn[:, 0, 1], totn[:, 0, 2]
    can_split = (best_gain > p.gamma) & (C >= 2 * p.min_rows) & \
        torch.isfinite(best_gain)
    return (feat, bin_, na_l, can_split, _leaf_value(G, H, p), best_gain,
            C, left, right)


def _find_splits_efb(hist, p: TreeParams, efb, feat_ok):
    """Split finding on a bundled [n_nodes, Fb, B, 3] histogram: every
    candidate slot is scored as the original (feature, threshold-bin)
    cut it encodes, and the winner comes back decoded. The candidates
    and their tie order (original feature-major, bin-minor, through
    ``efb.perm``) are ``_find_splits``'s; a passthrough column's gains
    are its unbundled ones; a bundled member's default-bin mass is the
    node total minus the member's own slots (exact under zero
    conflicts, so bitwise to the unbundled split where the sums are
    exact, within f32 rounding elsewhere). ``feat_ok`` is [n, F] in the
    original feature space."""
    nb = hist.shape[2]
    n, Fb = hist.shape[0], hist.shape[1]
    S = nb - 1
    sf = efb.slot_feat[:, :S].long()                     # [Fb, S]
    sb = efb.slot_bin[:, :S]
    body_mask = (efb.slot_feat >= 0) & (efb.slot_bin < nb - 1)  # [Fb, nb]
    bm = body_mask.to(hist.dtype)
    body = hist[:, :, :S, :] * bm[None, :, :S, None]
    cum = torch.cumsum(body, dim=2)                      # [n, Fb, S, 3]
    # node totals from column 0: its body cumsum tail plus its non-body
    # mass (the default slot and the members' NA slots; for a
    # passthrough column only its NA bin)
    nonbody0 = (~body_mask[0]).to(hist.dtype)
    totn = cum[:, 0, -1, :] + torch.sum(
        hist[:, 0, :, :] * nonbody0[None, :, None], dim=1)     # [n, 3]
    tot4 = totn[:, None, None, :]

    def take(a, idx):                                    # idx [Fb, S]
        return a.gather(2, idx.long()[None, :, :, None].expand(
            n, Fb, S, 3))
    na_c = take(hist, efb.na_slot[:, :S])                # [n, Fb, S, 3]
    mstart = efb.mstart[:, :S]
    pre = take(cum, torch.clamp(mstart - 1, min=0))
    started = (mstart > 0)[None, :, :, None]
    mleft = torch.where(started, cum - pre, cum)
    mtot = take(cum, efb.mend[:, :S])
    mtot = torch.where(started, mtot - pre, mtot)
    has_rem = efb.has_rem[:, :S]
    rem = torch.where(has_rem[None, :, :, None], tot4 - (mtot + na_c), 0.0)
    add_rem = has_rem & (sb >= efb.dbin[:, :S])
    left = mleft + torch.where(add_rem[None, :, :, None], rem, 0.0)

    gain_na_r = _split_gains(left, tot4, p)              # NA goes right
    gain_na_l = _split_gains(left + na_c, tot4, p)       # NA goes left
    na_left_better = gain_na_l > gain_na_r
    gain = torch.maximum(gain_na_l, gain_na_r)           # [n, Fb, S]
    ok = body_mask[None, :, :S].expand(n, Fb, S)
    if feat_ok is not None:
        ok = ok & feat_ok[:, sf.clamp(min=0).reshape(-1)].reshape(n, Fb, S)
    gain = torch.where(ok, gain, float("-inf"))
    perm = efb.perm.long()
    flat = gain.reshape(n, Fb * S)[:, perm]              # (feat, bin) order
    best_rank = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best_rank[:, None])[:, 0]
    best = perm[best_rank]                               # flat (col, slot)
    feat = sf.reshape(-1)[best].clamp(min=0).to(torch.int32)
    bin_ = sb.reshape(-1)[best].clamp(0, nb - 2).to(torch.int32)
    na_l = na_left_better.reshape(n, -1).gather(1, best[:, None])[:, 0]

    def pick(l4):                                        # -> [n, 3]
        return l4.reshape(n, Fb * S, 3).gather(
            1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    left_w = torch.where(na_l[:, None], pick(left + na_c), pick(left))
    right_w = totn - left_w
    G, H, C = totn[:, 0], totn[:, 1], totn[:, 2]
    can_split = (best_gain > p.gamma) & (C >= 2 * p.min_rows) & \
        torch.isfinite(best_gain)
    return (feat, bin_, na_l, can_split, _leaf_value(G, H, p), best_gain,
            C, left_w, right_w)


def row_orig_bins(binned, f, rows, efb=None):
    """Per-row original-space bin of per-row feature ``f`` (any shape
    broadcasting against ``rows``) from the [F, rows] matrix; with
    ``efb`` from the bundled [Fb, rows] one: the row's slot in f's
    bundle column, decoded (a slot of another member is f's default
    bin; a member's NA slot decodes to the NA bin)."""
    f = f.long()
    if efb is None:
        return binned[f, rows].to(torch.int32)
    col = efb.feat_col[f].long()
    s = binned[col, rows].long()
    sf = efb.slot_feat[col, s]
    sb = efb.slot_bin[col, s]
    return torch.where(sf == f, sb, efb.feat_default[f]).to(torch.int32)


def _hist(binned, rel, g, h, w, n_nodes, n_bins, p: TreeParams):
    hist = build_histogram(binned, rel, g, h, w, n_nodes, n_bins,
                           unit_hess=p.unit_hess)
    return expand_unit_hess(hist) if p.unit_hess else hist


def _feat_ok(col_mask, keys, d: int, n_nodes: int, F: int,
             p: TreeParams):
    """[T, n_nodes, F] allowed features of a level, or None for all:
    the per-tree column mask, then (DRF) exactly ``mtries`` features per
    node — the ``mtries`` smallest of ``uniform(fold_in(key_t, d),
    (n_nodes, F))`` among the allowed ones."""
    if col_mask is None and not 0 < p.mtries < F:
        return None
    T = keys.shape[0] if keys is not None else col_mask.shape[0]
    dev = keys.device if keys is not None else col_mask.device
    ok = torch.ones((T, n_nodes, F), dtype=torch.bool, device=dev)
    if col_mask is not None:
        ok = ok & col_mask[:, None, :]
    if 0 < p.mtries < F:
        r = prng.uniform(prng.fold_in(keys, d), (n_nodes, F))
        r = torch.where(ok, r, float("inf"))
        kth = torch.sort(r, dim=2).values[..., p.mtries - 1: p.mtries]
        ok = ok & (r <= kth)
    return ok


def _grow_trees(binned, g, h, w, p: TreeParams, keys=None, col_mask=None,
                efb=None):
    """T trees at once over all rows -> (Tree [T, N], leaf [T, rows]):
    ``leaf`` is each row's final heap index per tree, so the boosting
    loop reads ``tree.value[leaf]`` instead of re-descending.

    g, h, w: [T, rows], or [rows] shared by every tree (broadcast).
    keys: [T, 2] per-tree threefry keys, needed when ``p.mtries`` is in
    (0, F); col_mask: [T, F] bool per-tree column sample, or None.
    efb: bundle LUTs when ``binned`` is the bundled [Fb, rows] matrix
    (histograms at width Fb, masks and splits in the original F).

    Each level builds ONE batched histogram for all T trees (kernel B3
    on a card). Per level after the root, only LEFT children are
    histogrammed and right = parent - left per tree (sibling
    subtraction; children of unsplit parents are zeroed). The final
    level's leaves take their totals from the parent split's side
    stats, with no histogram pass, except for a depth-0 stump, which
    needs one single-bin pass."""
    Fh, rows = binned.shape
    F = Fh if efb is None else efb.feat_col.shape[0]
    dev = binned.device
    T = torch.broadcast_shapes(g.shape, h.shape, w.shape, (1, rows))[0]
    N = 2 ** (p.max_depth + 1) - 1
    split_feat = torch.full((T, N), -1, dtype=torch.int32, device=dev)
    split_bin = torch.zeros((T, N), dtype=torch.int32, device=dev)
    na_left = torch.zeros((T, N), dtype=torch.bool, device=dev)
    is_split = torch.zeros((T, N), dtype=torch.bool, device=dev)
    value = torch.zeros((T, N), dtype=torch.float32, device=dev)
    gain = torch.zeros((T, N), dtype=torch.float32, device=dev)
    cover = torch.zeros((T, N), dtype=torch.float32, device=dev)
    rel = torch.zeros((T, rows), dtype=torch.int32, device=dev)
    abs_node = torch.zeros((T, rows), dtype=torch.int64, device=dev)
    ar = torch.arange(rows, device=dev)
    for d in range(p.max_depth + 1):
        n_nodes = 2 ** d
        idx = slice(n_nodes - 1, 2 * n_nodes - 1)
        if d == p.max_depth:
            if d == 0:
                zero_bin = torch.zeros((1, rows), dtype=torch.uint8,
                                       device=dev)
                tot = _hist(zero_bin, rel, g, h, w, 1, 1, p)[:, :, 0, 0]
            else:
                tot = torch.where(can_prev[..., None, None],
                                  torch.stack([left_prev, right_prev], 2),
                                  0.0).reshape(T, n_nodes, 3)
            value[:, idx] = _leaf_value(tot[..., 0], tot[..., 1], p)
            cover[:, idx] = tot[..., 2]
            break
        if d == 0:
            hist = _hist(binned, rel, g, h, w, 1, p.n_bins, p)
        else:
            left_rel = torch.where((rel >= 0) & (rel % 2 == 0), rel // 2,
                                   -1)
            hist_l = _hist(binned, left_rel, g, h, w, n_nodes // 2,
                           p.n_bins, p)
            keep = can_prev[..., None, None, None]
            hist_l = torch.where(keep, hist_l, 0.0)
            hist_r = torch.where(keep, hist_prev, 0.0) - hist_l
            hist = torch.stack([hist_l, hist_r], dim=2).reshape(
                T, n_nodes, Fh, p.n_bins, 3)
        ok = _feat_ok(col_mask, keys, d, n_nodes, F, p)
        out = _find_splits(hist.reshape(T * n_nodes, Fh, p.n_bins, 3), p,
                           None if ok is None else ok.reshape(-1, F), efb)
        (feat, bin_, na_l, can, val, g_best, cov, left_prev,
         right_prev) = (a.reshape((T, n_nodes) + a.shape[1:])
                        for a in out)
        split_feat[:, idx] = torch.where(can, feat, -1)
        split_bin[:, idx] = bin_
        na_left[:, idx] = na_l
        is_split[:, idx] = can
        value[:, idx] = val
        gain[:, idx] = torch.where(can, g_best, 0.0)
        cover[:, idx] = cov
        hist_prev, can_prev = hist, can
        rel, abs_node = descend_level(binned, rel, abs_node,
                                      (feat, bin_, na_l, can), d, p.n_bins,
                                      efb, ar)
    return Tree(split_feat, split_bin, na_left, is_split, value, gain,
                cover), abs_node


def descend_level(binned, rel, abs_node, split, d: int, n_bins: int,
                  efb=None, ar=None):
    """Move every row from level d to d+1 through level d's splits
    ``split`` = (feat, bin, na_left, can_split), each [T, 2^d]: rel and
    abs_node are [T, rows] (the relative node, -1 once dead, and the
    heap node). Dead rows stay dead; rows of unsplit nodes die."""
    if ar is None:
        ar = torch.arange(binned.shape[1], device=binned.device)
    feat, bin_, na_l, can = split
    live = rel >= 0
    safe = torch.where(live, rel, 0).long()
    rowbin = row_orig_bins(binned, feat.gather(1, safe), ar, efb)
    go_right = torch.where(rowbin == n_bins - 1, ~na_l.gather(1, safe),
                           rowbin > bin_.gather(1, safe))
    child = 2 * rel + go_right.to(torch.int32)
    moved = live & can.gather(1, safe)
    rel = torch.where(moved, child, -1).to(torch.int32)
    abs_node = torch.where(moved, (2 ** (d + 1) - 1) + child.long(),
                           abs_node)
    return rel, abs_node


def _grow_tree(binned, g, h, w, p: TreeParams, efb=None):
    """One tree: the T=1 case of ``_grow_trees`` -> (Tree [N],
    leaf [rows])."""
    tree, leaf = _grow_trees(binned, g, h, w, p, efb=efb)
    return Tree(*(a[0] for a in tree)), leaf[0]


def grow_tree(binned, g, h, w, p: TreeParams, efb=None) -> Tree:
    """Build one tree from [F, rows] codes (or bundled [Fb, rows] ones
    with ``efb``) and per-row g/h/w on their device."""
    return _grow_tree(binned, g, h, w, p, efb)[0]


def _grad_hess(distribution: str, margin, y):
    """Gradient/hessian of the boosting loss at the current margin (the
    JAX package's DistributionFamily analogs; tweedie's variance power
    is fixed at 1.5, H2O's default)."""
    if distribution == "gaussian":
        return margin - y, torch.ones_like(margin)
    if distribution == "bernoulli":
        pr = torch.sigmoid(margin)
        return pr - y, pr * (1.0 - pr)
    if distribution == "poisson":
        mu = torch.exp(margin)
        return mu - y, mu
    if distribution == "gamma":
        ye = y * torch.exp(-margin)
        return 1.0 - ye, torch.clamp(ye, min=1e-10)
    if distribution == "tweedie":
        pw = 1.5
        a = y * torch.exp((1.0 - pw) * margin)
        b = torch.exp((2.0 - pw) * margin)
        return b - a, torch.clamp((2.0 - pw) * b - (1.0 - pw) * a,
                                  min=1e-10)
    if distribution == "laplace":
        return torch.sign(margin - y), torch.ones_like(margin)
    raise ValueError(distribution)


class BoostParams(NamedTuple):
    """Config of the boosting loop."""

    distribution: str = "gaussian"
    learn_rate: float = 0.1
    sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    drf_mode: bool = False
    quantile_alpha: float = 0.5     # quantile distribution's τ
    huber_alpha: float = 0.9        # huber δ = this quantile of |resid|
    # GOSS: goss_b > 0 turns it on (models/gbm.goss_params reads the
    # knobs); keep the top goss_a of the rows by |g| and a seeded goss_b
    # of the rest, amplified by (1 - a) / b
    goss_a: float = 0.0
    goss_b: float = 0.0


def huber_delta(r, w, alpha: float):
    """The ``alpha`` quantile of |r| over the rows with w > 0, as the
    JAX package's ``jnp.nanquantile(|r| NaN where w = 0, alpha)``
    computes it, on ``r``'s device with no host sync: dead rows NaN,
    then ``runtime.quantile.nanquantile`` with XLA's contraction of this
    program, ``fma(hi, hw, lo * lw)``, rounded once. A 0-dim float32
    tensor; NaN when no row is live."""
    absr = torch.where(w > 0, torch.abs(r), float("nan"))
    q = torch.tensor([np.float32(alpha)], device=r.device)
    return nanquantile(absr, q, fused="hi")[0]


def _boost_grad_hess(bp: BoostParams, margin, y, w):
    """Per-round (g, h), with the distributions whose gradients need
    BoostParams state: quantile's τ and huber's per-round δ (the
    ``huber_alpha`` quantile of the current |residuals| over the rows
    with weight, unsampled — the JAX package's on one row shard).
    The others delegate to ``_grad_hess``."""
    if bp.distribution == "quantile":
        a = bp.quantile_alpha
        g = torch.where(margin < y, -a, 1.0 - a)
        return g, torch.ones_like(y)
    if bp.distribution == "huber":
        r = y - margin
        delta = huber_delta(r, w, bp.huber_alpha)
        g = torch.where(torch.abs(r) <= delta, -r, -delta * torch.sign(r))
        return g, torch.ones_like(y)
    return _grad_hess(bp.distribution, margin, y)


def draws_random(p: TreeParams, bp: BoostParams, F: int) -> bool:
    """Whether a round draws random numbers: a row sample, a column
    sample, or a per-node feature draw. Without any, no keys are made."""
    return (bp.sample_rate < 1.0 or bp.col_sample_rate_per_tree < 1.0
            or 0 < p.mtries < F)


def _round_subkeys(keys, n: int):
    """[n, 2] round keys (or None) -> per round (row, column, tree) keys,
    each [n, 1, 2] (or Nones): one batched split for every round."""
    if keys is None:
        return [None] * n, [None] * n, [None] * n
    sub = prng.split(keys, 3)                                 # [n, 3, 2]
    return sub[:, 0:1], sub[:, 1:2], sub[:, 2:3]


def _round_sampling(bp: BoostParams, w, F: int, k_row, k_col):
    """Row and column sampling of a round, per key: [T, 2] keys ->
    (w_t [T, rows] or w itself, col_mask [T, F] or None). The JAX
    package folds its row-shard index into the row key; the port is one
    shard, index 0."""
    w_t = w
    if bp.sample_rate < 1.0:
        keep = prng.uniform(prng.fold_in(k_row, 0), w.shape) \
            < bp.sample_rate
        w_t = w * keep
    col_mask = None
    if bp.col_sample_rate_per_tree < 1.0:
        col_mask = prng.uniform(k_col, (F,)) < bp.col_sample_rate_per_tree
    return w_t, col_mask


# |g| ranking histogram resolution, compaction slack over the expected
# a+b rows, and the fold_in tag of the GOSS key stream (the JAX
# package's constants)
_GOSS_BINS = 2048
_GOSS_SLACK = 1.25
_GOSS_KEY_TAG = 0x9055


def goss_round_keys(key, n_trees: int):
    """[n_trees, 2] per-round GOSS keys from the estimator's seed key,
    outside the per-dispatch round-key schedule: the in-memory and the
    chunked paths index it by global round, so both draw the same
    per-row patterns at one seed."""
    return prng.split(prng.fold_in(key, _GOSS_KEY_TAG), n_trees)


def goss_cap_rows(rows: int, a: float, b: float) -> int:
    """Static capacity of the compacted row buffer: 1.25 times the
    expected a+b selected rows plus 64, rounded up to 8, at most
    ``rows``. Past it the last selected rows are dropped and counted
    (``goss_compact``)."""
    cap = int(rows * (a + b) * _GOSS_SLACK) + 64
    cap = -(-cap // 8) * 8
    return min(rows, cap)


def goss_rank_stat(g, w):
    """Per-row ranking statistic |g| (multi-output [K, rows]
    gradients: the class L1 norm), 0 on rows without weight."""
    absg = torch.abs(g) if g.dim() == 1 else torch.sum(torch.abs(g), dim=0)
    return torch.where(w > 0, absg, 0.0)


def _goss_bin_ids(absg, m):
    scale = _GOSS_BINS / torch.clamp(m, min=1e-30)
    return torch.clamp((absg * scale).to(torch.int32), 0, _GOSS_BINS - 1)


def goss_local_counts(absg, live, m):
    """(int32 [_GOSS_BINS] counts of the live rows per |g| bin, int32
    live count): integer sums, the same over any split of the rows."""
    bins = _goss_bin_ids(absg, m).long()
    counts = torch.zeros(_GOSS_BINS, dtype=torch.int32, device=absg.device
                         ).index_add_(0, bins, live.to(torch.int32))
    return counts, torch.sum(live.to(torch.int32)).to(torch.int32)


def goss_threshold(counts, total, a: float):
    """(T, frac_T) from the global count histogram: rows in bins above
    T are kept outright, a row in bin T when its draw is under frac_T —
    the top ``a`` of the rows in expectation, whatever the ties. XLA
    contracts the JAX package's ``a * total - above`` into one fused
    multiply-add, ``fma(a, total, -above)``, rounded once
    (``prng._fma``)."""
    suffix = torch.cumsum(counts.flip(0), 0).flip(0).to(torch.float32)
    a32 = torch.tensor(np.float32(a), device=counts.device)
    total = total.to(torch.float32)
    T = torch.clamp(torch.sum((suffix >= a32 * total).to(torch.int32)) - 1,
                    0, _GOSS_BINS - 1)
    cnt_T = counts[T.long()].to(torch.float32)
    above = suffix[T.long()] - cnt_T
    num = prng._fma(a32, total, -above)
    frac = torch.clamp(num / torch.clamp(cnt_T, min=1.0), 0.0, 1.0)
    return T, frac


def goss_row_factor(absg, live, m, T, frac_T, kg, row_ids, a: float,
                    b: float):
    """float32 per-row factor in {0, 1, (1-a)/b}: kept outright, kept
    amplified, or dropped. The two uniforms per row are threefry draws
    of (kg, global row id), so the rule does not depend on how the rows
    are laid out."""
    dev = absg.device
    q = torch.tensor(np.float32(b / (1.0 - a)), device=dev)
    amp = torch.tensor(np.float32((1.0 - a) / b), device=dev)
    u = prng.uniform(prng.fold_in(kg, row_ids), (2,))          # [rows, 2]
    bins = _goss_bin_ids(absg, m)
    top = (bins > T) | ((bins == T) & (u[:, 0] < frac_T))
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    factor = torch.where(top, one, torch.where(u[:, 1] < q, amp, zero))
    return torch.where(live, factor, 0.0)


def goss_amplified_w(g, w, kg, bp: BoostParams):
    """Per-row amplified weight w·factor of one round over all rows
    (one row shard): the global max |g|, the count histogram, the
    threshold, then each row's factor by its row id."""
    absg = goss_rank_stat(g, w)
    live = w > 0
    m = torch.max(absg)
    counts, total = goss_local_counts(absg, live, m)
    T, frac = goss_threshold(counts, total, bp.goss_a)
    row_ids = torch.arange(w.shape[-1], dtype=torch.int32, device=w.device)
    return w * goss_row_factor(absg, live, m, T, frac, kg, row_ids,
                               bp.goss_a, bp.goss_b)


def goss_compact(binned, g, h, w_amp, cap: int, row0: int = 0):
    """The selected rows (w_amp > 0), in row order, gathered into static
    buffers: binned [F, cap], g/h [cap] (or [K, cap]), w [cap]; slots
    past the selected count hold row 0 with weight 0 (dead), as
    ``nonzero(size=cap, fill_value=0)`` gives. Positions come from a
    cumsum and a scatter on the device, with no host sync. Returns
    (binned, g, h, w, dropped): ``dropped`` the device count of
    selected rows past ``cap``."""
    sel = w_amp > 0
    rows = sel.shape[0]
    pos = torch.cumsum(sel.to(torch.int32), 0) - 1
    nsel = pos[-1] + 1
    dev = sel.device
    target = torch.where(sel & (pos < cap), pos, cap).long()
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=dev).scatter_(
        0, target, torch.arange(rows, dtype=torch.int64, device=dev))[:cap]
    valid = torch.arange(cap, device=dev) < nsel
    wC = torch.where(valid, w_amp[idx], 0.0)
    if g.dim() == 1:
        gC, hC = g[idx], h[idx]
    else:
        gC, hC = g[:, idx], h[:, idx]
    dropped = torch.clamp(nsel - cap, min=0)
    return binned.index_select(1, idx), gC, hC, wC, dropped


def boost_trees(binned, y, w, margin, n_trees: int, p: TreeParams,
                bp: BoostParams, keys=None, efb=None, goss_keys=None):
    """``n_trees`` boosting rounds, one tree each: sampling -> grad/hess
    -> grow -> margin update, with the margin kept on its device.
    ``keys``: the [n_trees, 2] round keys when ``draws_random``; ``efb``
    the bundle LUTs when ``binned`` is bundled; ``goss_keys`` the
    [n_trees, 2] GOSS keys when ``bp.goss_b > 0``: each round then grows
    over its compacted selected rows and every row re-descends the tree.
    Returns (margin, trees stacked [T, N], the GOSS rows dropped past
    the buffer as a device scalar, or None)."""
    F = binned.shape[0] if efb is None else efb.feat_col.shape[0]
    k_row, k_col, k_tree = _round_subkeys(keys, n_trees)
    goss = bp.goss_b > 0.0
    cap = goss_cap_rows(binned.shape[1], bp.goss_a, bp.goss_b)
    trees, dropped = [], None
    for r in range(n_trees):
        w_t, col_mask = _round_sampling(bp, w, F, k_row[r], k_col[r])
        g, h = _boost_grad_hess(bp, margin, y, w)
        if goss:
            w_amp = goss_amplified_w(g, w_t, goss_keys[r], bp)
            bC, gC, hC, wC, dr = goss_compact(binned, g, h, w_amp, cap)
            dropped = dr if dropped is None else dropped + dr
            tree, _ = _grow_trees(bC, gC, hC, wC, p, k_tree[r], col_mask,
                                  efb)
            tree = tree._replace(value=bp.learn_rate * tree.value)
            leaf = descend_trees(tree, binned, p.max_depth, p.n_bins, efb)
        else:
            tree, leaf = _grow_trees(binned, g, h, w_t, p, k_tree[r],
                                     col_mask, efb)
            tree = tree._replace(value=bp.learn_rate * tree.value)
        margin = margin + tree.value[0][leaf[0]]
        trees.append(tree)
    return margin, Tree(*(torch.cat(a) for a in zip(*trees))), dropped


def boost_trees_multi(binned, y, w, margin, n_trees: int, K: int,
                      p: TreeParams, bp: BoostParams, G: int, keys=None,
                      efb=None, goss_keys=None):
    """Multinomial rounds: K class trees per round from one row sample
    and one column mask, grown G at a time through the batched
    histogram, softmax gradients (DRF: g = -onehot(y), h = 1, margin
    untouched). ``margin`` is [rows, K]; ``keys``, ``efb`` and
    ``goss_keys`` as in ``boost_trees`` (one GOSS draw per round, rows
    ranked by the class L1 norm of g, shared by the K trees). Returns
    (margin, trees interleaved class-fastest [n_trees·K, N], GOSS rows
    dropped or None)."""
    F = binned.shape[0] if efb is None else efb.feat_col.shape[0]
    cls = torch.arange(K, dtype=y.dtype, device=y.device)
    yk = (y[None, :] == cls[:, None]).to(torch.float32)      # [K, rows]
    k_row, k_col, k_tree = _round_subkeys(keys, n_trees)
    goss = bp.goss_b > 0.0
    cap = goss_cap_rows(binned.shape[1], bp.goss_a, bp.goss_b)
    trees, dropped = [], None
    for r in range(n_trees):
        w_t, col_mask = _round_sampling(bp, w, F, k_row[r], k_col[r])
        if bp.drf_mode:
            g, h = -yk, torch.ones_like(yk)
        else:
            probs = torch.softmax(margin, dim=1).T             # [K, rows]
            g, h = probs - yk, probs * (1.0 - probs)
        bG, wG = binned, w_t
        if goss:
            w_amp = goss_amplified_w(g, w_t, goss_keys[r], bp)
            bG, g, h, wG, dr = goss_compact(binned, g, h, w_amp, cap)
            dropped = dr if dropped is None else dropped + dr
        keys_k = None if keys is None else prng.split(k_tree[r][0], K)
        parts = []
        for k0 in range(0, K, G):
            k1 = min(K, k0 + G)
            cm = None if col_mask is None else col_mask.expand(k1 - k0, F)
            parts.append(_grow_trees(
                bG, g[k0:k1], h[k0:k1], wG, p,
                None if keys_k is None else keys_k[k0:k1], cm, efb))
        tree = Tree(*(torch.cat(a) for a in zip(*(t for t, _ in parts))))
        tree = tree._replace(value=bp.learn_rate * tree.value)
        if not bp.drf_mode:
            if goss:                       # the grow saw the sample only
                leaf = descend_trees(tree, binned, p.max_depth, p.n_bins,
                                     efb)
            else:
                leaf = torch.cat([lf for _, lf in parts])      # [K, rows]
            margin = margin + tree.value.gather(1, leaf).T
        trees.append(tree)
    return margin, Tree(*(torch.cat(a) for a in zip(*trees))), dropped


def drf_group_size(n_trees: int, p: TreeParams, F: int) -> tuple[int, int]:
    """(G, rounds): trees grown at once, G ≤ 16, so that G trees' live
    level histograms fit min(2^30, ``H2O_TPU_HIST_BYTES_BUDGET``) bytes
    (the JAX package's rule for its vmapped groups), then rebalanced to
    ceil(n_trees / rounds) for the least padding."""
    budget = min(2 ** 30, int(hist_bytes_budget()))
    G = int(max(1, min(n_trees, 16, budget // level_hist_bytes(p, F))))
    rounds = -(-n_trees // G)
    return -(-n_trees // rounds), rounds


def boost_trees_drf(binned, y, w, n_trees: int, p: TreeParams,
                    bp: BoostParams, keys=None, efb=None) -> Tree:
    """A forest of ``n_trees`` independent trees, G at a time
    (``drf_group_size``): per tree a bootstrap row sample and a column
    mask from its own [2] key of ``keys`` (as in ``boost_trees``),
    g = -y, h = 1. The trees cannot depend on G: each tree's draws come
    from its own key, and the threefry draws are prefix-stable. G is
    sized at the histogram width (the bundled one with ``efb``)."""
    F = binned.shape[0] if efb is None else efb.feat_col.shape[0]
    G, _ = drf_group_size(n_trees, p, binned.shape[0])
    g, h = -y, torch.ones_like(y)
    trees = []
    for t0 in range(0, n_trees, G):
        k_row = k_col = k_tree = None
        if keys is not None:
            k_row, k_col, k_tree = prng.split(keys[t0:t0 + G], 3).unbind(1)
        w_t, col_mask = _round_sampling(bp, w, F, k_row, k_col)
        if w_t.dim() == 1:                 # no row sample: G copies of w
            w_t = w_t.expand(min(G, n_trees - t0), -1)
        trees.append(_grow_trees(binned, g, h, w_t, p, k_tree,
                                 col_mask, efb)[0])
    return Tree(*(torch.cat(a) for a in zip(*trees)))


def level_hist_bytes(p: TreeParams, F: int) -> int:
    """Peak live histogram bytes of one tree's deepest level (parent,
    left, right and the stacked level), the budget check's measure."""
    C = 2 if p.unit_hess else 3
    return 5 * (2 ** max(p.max_depth - 1, 0)) * F * p.n_bins * C * 4


def descend_tree(tree: Tree, binned, max_depth: int, n_bins: int,
                 efb=None):
    """Per-row resting heap node of one tree over [F, rows] codes (or
    bundled ones with ``efb``)."""
    rows = binned.shape[1]
    ar = torch.arange(rows, device=binned.device)
    node = torch.zeros(rows, dtype=torch.int64, device=binned.device)
    for _ in range(max_depth):
        f = tree.split_feat[node]
        rowbin = row_orig_bins(binned, f.clamp(min=0), ar, efb)
        go_right = torch.where(rowbin == n_bins - 1, ~tree.na_left[node],
                               rowbin > tree.split_bin[node])
        node = torch.where(tree.is_split[node], 2 * node + 1 + go_right.long(),
                           node)
    return node


def predict_tree(tree: Tree, binned, max_depth: int, n_bins: int,
                 efb=None):
    """Per-row leaf value (descend + gather)."""
    return tree.value[descend_tree(tree, binned, max_depth, n_bins, efb)]


def descend_trees(trees: Tree, binned, max_depth: int, n_bins: int,
                  efb=None):
    """[T, rows] resting heap node of every tree of a stacked [T, N]
    Tree over [F, rows] codes (or bundled ones with ``efb``; the leaf
    assignment, the JAX package's ``_stack_leaf_nodes``),
    ``_ROUND_BLOCK`` trees at a time."""
    T, rows = trees.split_feat.shape[0], binned.shape[1]
    ar = torch.arange(rows, device=binned.device)
    out = []
    for t0 in range(0, T, _ROUND_BLOCK):
        sl = slice(t0, min(T, t0 + _ROUND_BLOCK))
        sf, sb = trees.split_feat[sl].long(), trees.split_bin[sl]
        nl, sp = trees.na_left[sl], trees.is_split[sl]
        node = torch.zeros((sf.shape[0], rows), dtype=torch.int64,
                           device=binned.device)
        for _ in range(max_depth):
            f = sf.gather(1, node)
            rowbin = row_orig_bins(binned, f.clamp(min=0), ar, efb)
            go_right = torch.where(rowbin == n_bins - 1,
                                   ~nl.gather(1, node),
                                   rowbin > sb.gather(1, node))
            node = torch.where(sp.gather(1, node),
                               2 * node + 1 + go_right.long(), node)
        out.append(node)
    return torch.cat(out)


def stack_predict(trees: Tree, binned, max_depth: int, n_bins: int):
    """[rows] sum of leaf values over a stacked [T, N] Tree, added tree
    by tree into a zeroed float32 accumulator (the JAX package's
    ``_stack_predict`` scan order)."""
    nodes = descend_trees(trees, binned, max_depth, n_bins)
    total = torch.zeros(binned.shape[1], dtype=torch.float32,
                        device=binned.device)
    for t in range(nodes.shape[0]):
        total = total + trees.value[t][nodes[t]]
    return total


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


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _reach_slots(isp: np.ndarray, max_depth: int
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """(reach [T, N] bool, slot [T, N] int, M): the reachable-node set
    and its BFS slot assignment, shared by ``flatten_trees`` and
    ``flatten_cover`` so every per-node array lands on the same slots."""
    T, N = isp.shape
    reach = np.zeros((T, N), dtype=bool)
    reach[:, 0] = True
    for d in range(max_depth):
        lo, hi = 2 ** d - 1, 2 ** (d + 1) - 1
        if hi > N:
            break
        par = reach[:, lo:hi] & isp[:, lo:hi]
        idx = np.arange(lo, hi)
        reach[:, 2 * idx + 1] |= par
        reach[:, 2 * idx + 2] |= par
    # BFS slot order == heap-index order among reachable nodes
    slot = reach.cumsum(axis=1) - 1
    M = int(reach.sum(axis=1).max())
    return reach, slot, M


def flatten_cover(trees: Tree, max_depth: int) -> np.ndarray:
    """[T, M] per-flat-node training weight mass (TreeSHAP's r_j),
    slot-aligned with ``flatten_trees`` (the ``flat_cover`` part)."""
    isp = _np(trees.is_split).astype(bool)
    cov = _np(trees.cover).astype(np.float32)
    reach, slot, M = _reach_slots(isp, max_depth)
    out = np.zeros((isp.shape[0], M), dtype=np.float32)
    tt, hh = np.nonzero(reach)
    out[tt, slot[tt, hh]] = cov[tt, hh]
    return out


def flatten_trees(trees: Tree, edges_matrix, enum_mask, max_depth: int
                  ) -> FlatTrees:
    """Host (numpy) flattening of a stacked [T, N] heap Tree.

    Thresholds reproduce the binned descent bitwise: a numeric split
    at bin b < n_edges has thresh = edges[f, b] (``x >= thresh`` goes
    right); b == n_edges (past the last body bin) has thresh = NaN, so
    every non-NA row goes left; an enum split has thresh = b + 1. NA
    routing stays explicit via na_left."""
    sf = _np(trees.split_feat)
    sb = _np(trees.split_bin)
    nl = _np(trees.na_left).astype(bool)
    isp = _np(trees.is_split).astype(bool)
    val = _np(trees.value).astype(np.float32)
    edges_matrix = _np(edges_matrix)
    enum_mask = _np(enum_mask).astype(bool)
    T, N = sf.shape
    reach, slot, M = _reach_slots(isp, max_depth)
    out_feat = np.full((T, M), -1, dtype=np.int32)
    out_thresh = np.zeros((T, M), dtype=np.float32)
    out_left = np.zeros((T, M), dtype=np.int32)
    out_nal = np.zeros((T, M), dtype=bool)
    out_val = np.zeros((T, M), dtype=np.float32)
    tt, hh = np.nonzero(reach)
    ss = slot[tt, hh]
    sm = isp[tt, hh]                                      # split mask
    f = np.where(sm, sf[tt, hh], 0)
    b = sb[tt, hh]
    width = edges_matrix.shape[1]
    b_safe = np.minimum(b, width - 1)
    with np.errstate(invalid="ignore"):
        th = np.where(
            enum_mask[f], (b + 1).astype(np.float32),
            np.where(b < width, edges_matrix[f, b_safe].astype(np.float32),
                     np.float32(np.nan)))
    lh = np.minimum(2 * hh + 1, N - 1)                    # guarded gather
    out_feat[tt, ss] = np.where(sm, sf[tt, hh], -1)
    out_thresh[tt, ss] = np.where(sm, th, 0.0)
    out_left[tt, ss] = np.where(sm, slot[tt, lh], 0)
    out_nal[tt, ss] = nl[tt, hh] & sm
    out_val[tt, ss] = np.where(sm, 0.0, val[tt, hh])
    return FlatTrees(out_feat, out_thresh, out_left, out_nal, out_val)
