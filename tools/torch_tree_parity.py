"""Float64 oracles for holding a trained port GBM against another
model of the same data (the JAX package's in the parity tests, the
card's against the CPU's in ``chip_smoke.py``): where two decisions
differ at a node, are they a near-tie? Imports torch and the port,
never jax.

- ``round_stats``: per boosting round of a port model, the float64
  gradients and hessians times the round's weights (after row
  sampling), at the margin the model's own earlier trees give;
- ``walk``: walk every tree of two models from the root while their
  decisions agree; where they differ, the two decisions' float64 gains
  on the node's rows must be within 1e-6 of the node's G²/H (f32 cannot
  order them finer), and the node's subtree is not compared (or, with
  ``until_tie``, no tree after the first one that holds a tie);
- ``routed_apart``: the rows whose leaf differs between two models in
  some tree.
"""

import numpy as np
import torch

from h2o_kubernetes_tpu_torch.models.gbm import _round_keys
from h2o_kubernetes_tpu_torch.models.tree import core as tcore

FIELDS = ("is_split", "split_feat", "split_bin", "na_left")


def _np(a) -> np.ndarray:
    """A torch tensor (any device) or an array-like as numpy."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def grad_hess64(dist, margin, y, w):
    """float64 (g, h) of a round at ``margin`` (numpy), as the boosting
    loop forms them: huber's δ over the rows with weight."""
    if dist == "gaussian":
        return margin - y, np.ones_like(y)
    if dist == "bernoulli":
        p = 1.0 / (1.0 + np.exp(-margin))
        return p - y, p * (1.0 - p)
    if dist == "poisson":
        mu = np.exp(margin)
        return mu - y, mu
    if dist == "gamma":
        ye = y * np.exp(-margin)
        return 1.0 - ye, np.maximum(ye, 1e-10)
    if dist == "tweedie":
        a, b = y * np.exp(-0.5 * margin), np.exp(0.5 * margin)
        return b - a, np.maximum(0.5 * b + 0.5 * a, 1e-10)
    if dist == "laplace":
        return np.sign(margin - y), np.ones_like(y)
    if dist == "quantile":
        return np.where(margin < y, -0.5, 0.5), np.ones_like(y)
    if dist == "huber":
        r = y - margin
        delta = np.quantile(np.abs(r[w > 0]), 0.9)
        return (np.where(np.abs(r) <= delta, -r, -delta * np.sign(r)),
                np.ones_like(y))
    raise ValueError(dist)


def _gain64(bf, g, h, split, na_left, b, n_bins, lam=0.0, alpha=0.0):
    """(float64 gain of a node decision on its rows, the node's G²/H)."""
    def term(m):
        G = g[m].sum()
        s = np.sign(G) * max(abs(G) - alpha, 0.0)
        return s * s / (h[m].sum() + lam + 1e-10)
    whole = np.ones(bf.shape, dtype=bool)
    if not split:
        return 0.0, term(whole)
    left = np.where(bf == n_bins - 1, na_left, bf <= b)
    return term(left) + term(~left) - term(whole), term(whole)


def round_stats(tm, tf, y, kw, n_old=0, goss=None):
    """Per new tree of the port model ``tm`` trained on ``tf`` with the
    ``train`` keywords ``kw``: float64 (g·w, h·w) at the round's margin
    (the model's own trees before it) under the round's weights after
    sampling; with the [F, rows] codes, on the host. The first ``n_old``
    trees came from a checkpoint. ``goss=(a, b)``: the model trained
    under GOSS; each round's weights are then its amplified ones, drawn
    as training drew them (at the float32 margin, on the CPU)."""
    from h2o_kubernetes_tpu_torch.models.base import resolve_xy

    p = tm.params
    dist = tm.distribution
    data = resolve_xy(tf, y, None, kw.get("ignored_columns"),
                      kw.get("weights_column"), dist,
                      kw.get("offset_column"))
    binned = tf.binned(tm.bin_spec).cpu()
    yv = data.y.double().cpu().numpy()
    w = data.w.double().cpu().numpy()
    off = np.zeros_like(yv) if data.offset is None else \
        data.offset.double().cpu().numpy()
    init = float(np.asarray(tm.init_score).ravel()[0])
    scale = float(tm.margin_scale)
    if dist == "laplace":
        yv = (yv - init) / scale
        margin = np.zeros_like(yv)
    else:
        margin = init + off
    F = binned.shape[0]
    tp = tcore.TreeParams(max_depth=p.max_depth, n_bins=p.nbins,
                          mtries=p.mtries)
    bp = tcore.BoostParams(distribution=dist, sample_rate=p.sample_rate,
                           col_sample_rate_per_tree=(
                               p.col_sample_rate_per_tree))
    T = tm.trees.value.shape[0]
    if goss is not None:
        from h2o_kubernetes_tpu_torch.runtime import prng

        bp = bp._replace(goss_a=goss[0], goss_b=goss[1])
        gkeys = tcore.goss_round_keys(prng.key(p.seed), p.ntrees)
        y32 = torch.as_tensor(yv, dtype=torch.float32)
        w32 = data.w.cpu()
        m32 = torch.tensor(np.float32(init)) + (
            torch.zeros_like(w32) if data.offset is None
            else data.offset.cpu())
    keys = None
    if tcore.draws_random(tp, bp, F):
        keys = _round_keys(p, binned.shape[1], F, 1, "cpu", n_old)
    out = []
    for t in range(T):
        tree = tcore.Tree(*(a[t].cpu() for a in tm.trees))
        if t >= n_old:
            wt = w
            if keys is not None:
                kr, kc, _ = tcore._round_subkeys(keys[t - n_old: t - n_old
                                                      + 1], 1)
                wt = tcore._round_sampling(bp, data.w.cpu(), F, kr[0],
                                           kc[0])[0][0].double().numpy()
            if goss is not None:
                g32 = tcore._boost_grad_hess(bp, m32, y32, w32)[0]
                wt = tcore.goss_amplified_w(g32, w32, gkeys[t],
                                            bp).double().numpy()
            g, h = grad_hess64(dist, margin, yv, w)
            out.append((g * wt, h * wt))
        step = tcore.predict_tree(tree, binned, p.max_depth, p.nbins)
        margin = margin + step.double().numpy()
        if goss is not None:
            m32 = m32 + step
    return out, binned.numpy()


def walk(tm, jm, stats, binned, n_old=0, lam=0.0, alpha=0.0, rel=1e-6,
         until_tie=False):
    """Walk every new tree from the root while the two packages'
    decisions agree. A node where they differ must be a float64
    near-tie: the two decisions' float64 gains on the node's rows differ
    by at most ``rel`` (1e-6) of the node's G²/H (f32 cannot order them
    finer); its subtree is not compared. ``until_tie``: stop after the
    first tree that holds a tie (the later trees grow from margins the
    tie moved, so their decisions are not the same problem). Returns
    (nodes compared, ties, compared leaf gaps over the tree's largest
    |leaf|, per tree)."""
    B = tm.params.nbins
    tt = {f: _np(getattr(tm.trees, f)) for f in FIELDS + ("value",)}
    jt = {f: _np(getattr(jm.trees, f)) for f in FIELDS + ("value",)}
    compared, ties, gaps = 0, [], []
    for t in range(n_old, tt["value"].shape[0]):
        g, h = stats[t - n_old]
        scale = max(np.abs(jt["value"][t]).max(), 1e-30)
        rows_at = {0: np.ones(binned.shape[1], dtype=bool)}
        for node in range(tt["is_split"].shape[1]):
            if node not in rows_at:
                continue
            rows = rows_at.pop(node)
            dec_t = tuple(tt[f][t, node] for f in FIELDS)
            dec_j = tuple(jt[f][t, node] for f in FIELDS)
            if not dec_t[0] and not dec_j[0]:
                compared += 1
                want = jt["value"][t, node]
                gaps.append(abs(tt["value"][t, node] - want)
                            / (abs(want) + scale))
                continue
            if dec_t != dec_j:
                gains = [_gain64(binned[max(d[1], 0)][rows], g[rows],
                                 h[rows], d[0], d[3], d[2], B, lam, alpha)
                         for d in (dec_t, dec_j)]
                gap = abs(gains[0][0] - gains[1][0])
                assert gap <= rel * gains[0][1], (t, node, dec_t, dec_j,
                                                  gains)
                ties.append((t, node))
                continue
            compared += 1
            bf = binned[dec_t[1]]
            left = rows & np.where(bf == B - 1, dec_t[3], bf <= dec_t[2])
            rows_at[2 * node + 1] = left
            rows_at[2 * node + 2] = rows & ~left
        if until_tie and ties:
            break
    return compared, ties, np.asarray(gaps)


def routed_apart(tm, jm, frame):
    """[rows] bool: rows of ``frame`` whose leaf differs between the
    two models in some tree (the rows a tied threshold routes
    differently); ``frame`` is on the device of ``tm``."""
    binned = tm._binned_design(frame)
    dev = binned.device
    nodes_t = tcore.descend_trees(tm.trees, binned, tm.params.max_depth,
                                  tm.params.nbins)
    other = tcore.Tree(*(torch.as_tensor(_np(getattr(jm.trees, f)),
                                         device=dev)
                         for f in tcore.Tree._fields))
    nodes_j = tcore.descend_trees(other, binned, tm.params.max_depth,
                                  tm.params.nbins)
    return (nodes_t != nodes_j).any(dim=0).cpu().numpy()
