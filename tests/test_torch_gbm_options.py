"""PyTorch port, the GBM options no other test trains with, against the
JAX package on the CPU, on a one-row-shard mesh (the port's layout, and
the one where the JAX package's row sampling draws what the port's
does): a weights column with an offset column; ``reg_lambda``,
``reg_alpha``, ``min_child_weight`` and ``min_rows``; ``sample_rate``
with ``col_sample_rate_per_tree``.

The contract (``PERF.md`` §2, "training correct"): split bins may
differ only at a float64 near-tie. A right child's histogram is its
parent's minus the left's, in both packages, so its sample-empty bins
carry f32 residue and the first-max tie-break between two thresholds
with no sampled row between them lands on rounding noise (the sampled
case below, at tree 2, node 14 on x4: bins 47 and 62, whose gains are
equal in float64 on the node's rows). Held here:
- the split structure equal from the root down, where it differs a
  float64 near-tie (the two decisions' gains, at the round's sampled
  weights and regularization, within 1e-6 of the node's G²/H;
  ``tools/torch_tree_parity.walk``), and compared leaves within 1e-5;
- holdout probabilities within 1e-5 on every row that does not fall
  between two tied thresholds (its leaf is the same in both packages'
  trees), and such rows at most 1%;
- train AUC and logloss within 1e-5 where no training row falls
  between tied thresholds; where some do (the sampled case: rows the
  round did not sample still take the tree's leaves), the training
  rows' probabilities off the ties within 1e-5 instead.
"""

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import GBM, Frame
from tools.torch_tree_parity import round_stats, routed_apart, walk
from test_torch_gbm import bench_cols

TOL = 1e-5
_BASE = dict(ntrees=3, max_depth=4, learn_rate=0.2)
CONFIGS = {
    "weights_offset": (dict(_BASE, seed=1),
                       {"weights_column": "w", "offset_column": "off"}),
    "regularized": (dict(_BASE, seed=1, reg_lambda=1.0, reg_alpha=0.5,
                         min_child_weight=5.0, min_rows=20.0), {}),
    # the configuration of the tie recorded in ROADMAP (Queue 3, C2)
    "sampled": (dict(_BASE, seed=3, sample_rate=0.7,
                     col_sample_rate_per_tree=0.6), {}),
}


def option_cols(rows, seed=0):
    cols = bench_cols(rows, seed=seed)
    rng = np.random.default_rng(seed + 100)
    cols["w"] = rng.uniform(0.2, 2.0, rows).astype(np.float32)
    cols["w"][::13] = 0.0
    cols["off"] = (0.2 * rng.normal(size=rows)).astype(np.float32)
    return cols


@pytest.fixture(scope="module")
def trained():
    cols, hold = option_cols(4096), option_cols(500, seed=9)
    out = {}
    with use_mesh(make_mesh(n_rows=1)):
        jf, jh = h2o.Frame.from_arrays(cols), h2o.Frame.from_arrays(hold)
        tf = Frame.from_arrays(cols, device="cpu")
        th = Frame.from_arrays(hold, device="cpu")
        for name, (est, kw) in CONFIGS.items():
            kw = dict(kw, ignored_columns=[c for c in ("w", "off")
                                           if c not in kw.values()])
            jm = JGBM(**est).train(y="y", training_frame=jf, **kw)
            tm = GBM(**est).train(y="y", training_frame=tf, **kw)
            stats, binned = round_stats(tm, tf, "y", kw)
            res = walk(tm, jm, stats, binned, lam=est.get("reg_lambda", 0.0),
                       alpha=est.get("reg_alpha", 0.0))
            X = np.asarray(jm._design_matrix(jh))[: jh.nrows]
            off = hold["off"] if "offset_column" in kw else None
            Xt = np.asarray(jm._design_matrix(jf))[: jf.nrows]
            out[name] = dict(jm=jm, tm=tm, walk=res, X=X, off=off,
                             jp=np.asarray(jm.predict_raw(jh))[: jh.nrows],
                             apart=routed_apart(tm, jm, th), Xt=Xt,
                             jpt=np.asarray(jm.predict_raw(jf))[: jf.nrows],
                             offt=cols["off"] if off is not None else None,
                             apart_t=routed_apart(tm, jm, tf))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_structure_equal_up_to_near_ties(trained, name):
    compared, ties, gaps = trained[name]["walk"]
    assert len(ties) <= 2 and compared >= 30, (ties, compared)
    assert gaps.max() <= TOL, gaps.max()
    if name == "sampled":
        # the recorded tie is found, and held to the near-tie rule
        assert (2, 14) in ties, ties


@pytest.mark.parametrize("name", list(CONFIGS))
def test_holdout_probabilities_off_ties(trained, name):
    c = trained[name]
    apart = c["apart"]
    assert apart.mean() <= 0.01, apart.sum()
    got = c["tm"].score_numpy(c["X"], offset=c["off"])
    np.testing.assert_allclose(got[~apart], c["jp"][~apart], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_metrics_close(trained, name):
    c = trained[name]
    apart = c["apart_t"]
    if apart.any():
        assert name == "sampled" and apart.mean() <= 0.01, apart.sum()
        got = c["tm"].score_numpy(c["Xt"], offset=c["offt"])
        np.testing.assert_allclose(got[~apart], c["jpt"][~apart], rtol=0,
                                   atol=TOL)
        return
    jh = c["jm"].scoring_history[-1]
    th = c["tm"].scoring_history[-1]
    for k in ("train_auc", "train_logloss"):
        assert abs(th[k] - jh[k]) <= TOL, (k, th[k], jh[k])
