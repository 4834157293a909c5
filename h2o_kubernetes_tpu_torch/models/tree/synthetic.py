"""Seeded tree ensembles as MOJO-v2 artifacts, for smoke runs and tests.

A scorer replica's model comes from training; where no trainer is at
hand (the GPU smoke run, the port's own tests) the trees come from a
seed, the way random weights do for a network. Trees are grown against
a seeded sample so that they look trained: each node draws its split
feature, its threshold is a quantile of the sample rows that reach it,
``na_left`` is random, leaf values are small normals, and
``flat_cover`` counts the sample rows routed through each node — so
the covers are consistent with the splits, as TreeSHAP requires.
"""

from __future__ import annotations

import io
import json
import zipfile
from collections import deque

import numpy as np

from ...mojo import MOJO_FORMAT

__all__ = ["random_rows", "random_tree_artifact"]


def random_rows(seed: int, n: int, n_features: int,
                nan_frac: float = 0.01, enum_features=(),
                nlevels: int = 4) -> np.ndarray:
    """[n, F] float32 standard normals with ``nan_frac`` NaNs; enum
    features hold integer codes in [-1, nlevels), -1 being NA."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n_features), dtype=np.float32)
    X[rng.random((n, n_features)) < nan_frac] = np.nan
    for f in enum_features:
        codes = rng.integers(-1, nlevels, n).astype(np.float32)
        codes[rng.random(n) < nan_frac] = np.nan
        X[:, f] = codes
    return X


def _grow(rng, Xs, max_depth, enum_mask, nlevels, leaf_scale, p_leaf):
    """One tree in BFS slot order (root = 0, right = left + 1) as
    per-node lists, plus the sample-row count through each node."""
    feat, thresh, left, na_left, value, cover = [], [], [], [], [], []
    queue = deque([(np.arange(Xs.shape[0]), 0)])
    n_alloc = 1
    while queue:
        idx, depth = queue.popleft()
        cover.append(float(idx.size))
        if depth == max_depth or idx.size < 2 or \
                (depth >= 2 and rng.random() < p_leaf):
            feat.append(-1)
            thresh.append(0.0)
            left.append(0)
            na_left.append(False)
            value.append(float(rng.normal(scale=leaf_scale)))
            continue
        f = int(rng.integers(Xs.shape[1]))
        x = Xs[idx, f]
        if enum_mask[f]:
            x = np.where(x < 0, np.nan, x)
            th = float(rng.integers(1, nlevels))
        else:
            fin = x[~np.isnan(x)]
            th = float(np.float32(np.quantile(fin, rng.uniform(0.2, 0.8)))) \
                if fin.size else float("nan")
        nl = bool(rng.random() < 0.5)
        with np.errstate(invalid="ignore"):
            go_r = np.where(np.isnan(x), not nl, x >= th)
        feat.append(f)
        thresh.append(th)
        left.append(n_alloc)
        na_left.append(nl)
        value.append(0.0)
        queue.append((idx[~go_r], depth + 1))
        queue.append((idx[go_r], depth + 1))
        n_alloc += 2
    return feat, thresh, left, na_left, value, cover


def random_tree_artifact(seed: int, n_features: int = 28,
                         ntrees: int = 20, max_depth: int = 5,
                         nclasses: int = 2,
                         distribution: str = "bernoulli",
                         drf_mode: bool = False, enum_features=(),
                         nlevels: int = 4, leaf_scale: float = 0.1,
                         p_leaf: float = 0.15,
                         sample_rows: int = 4096) -> bytes:
    """MOJO-v2 tree artifact bytes for a seeded ensemble: ``ntrees``
    boosting rounds (times K class trees, interleaved, when
    ``nclasses > 2``) of depth at most ``max_depth``."""
    rng = np.random.default_rng(seed)
    enum_mask = np.zeros(n_features, dtype=bool)
    enum_mask[list(enum_features)] = True
    Xs = random_rows(seed + 1, sample_rows, n_features,
                     enum_features=enum_features, nlevels=nlevels)
    K = nclasses if nclasses > 2 else 1
    trees = [_grow(rng, Xs, max_depth, enum_mask, nlevels, leaf_scale,
                   p_leaf) for _ in range(ntrees * K)]
    M = max(len(t[0]) for t in trees)
    T = len(trees)
    parts = {"split_feat": (np.int32, -1), "thresh": (np.float32, 0.0),
             "left": (np.int32, 0), "na_left": (bool, False),
             "value": (np.float32, 0.0), "cover": (np.float32, 0.0)}
    arrays = {}
    for i, (name, (dt, fill)) in enumerate(parts.items()):
        a = np.full((T, M), fill, dtype=dt)
        for t, tree in enumerate(trees):
            a[t, : len(tree[i])] = tree[i]
        arrays[f"flat_{name}"] = a
    arrays["init_score"] = rng.normal(scale=0.1, size=K).astype(np.float32)
    arrays["enum_mask"] = enum_mask
    meta = {
        "format": MOJO_FORMAT, "algo": "drf" if drf_mode else "gbm",
        "feature_names": [f"x{i}" for i in range(n_features)],
        "feature_domains": {f"x{i}": [f"L{j}" for j in range(nlevels)]
                            for i in enum_features},
        "nclasses": nclasses,
        "response_domain": ([str(k) for k in range(nclasses)]
                            if nclasses > 1 else None),
        "distribution": distribution, "offset_column": None,
        "max_depth": max_depth, "nbins": 256, "drf_mode": drf_mode,
        "ntrees": T, "na_bin": 256, "margin_scale": 1.0,
    }
    npz = io.BytesIO()
    np.savez_compressed(npz, **arrays)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.json", json.dumps(meta))
        z.writestr("arrays.npz", npz.getvalue())
    return buf.getvalue()
