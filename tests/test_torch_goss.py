"""PyTorch port, GOSS (gradient-based one-side sampling) against the JAX
package on the CPU, its reference on a one-row-shard mesh (the port's
layout: one row shard, so its row ids and compaction buffer are the
port's).

Held here:
- the GOSS key stream and the per-row factor bitwise at the same
  (round key, row ids, |g|), the threshold and the count histogram
  equal, and the compaction equal to ``nonzero(size=cap)``, its
  overflow count included;
- ``H2O_TPU_GOSS=0`` trains bitwise as no GOSS, and a + b = 1 (every
  row kept at amplification 1) bitwise as no GOSS;
- a GOSS GBM (bernoulli), a pointwise XGBoost and a multinomial GBM
  against the JAX package's: the split structure equal up to float64
  near-ties (``tools/torch_tree_parity.walk`` at the rounds' amplified
  weights), compared leaves and predictions within 1e-5; one gaussian
  round on a dyadic response, with dyadic amplification, bitwise;
- DRF and ``rank:ndcg`` untouched by the knob, the knob and
  ``sample_rate`` errors the reference's, and the overflow warning on a
  frame sorted by |g| (out-of-core chunks, where one chunk holds every
  high-|g| row).
"""

import contextlib
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models import XGBoost as JXGB
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import DRF, GBM, XGBoost, Frame
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.runtime import prng
from tools.torch_tree_parity import round_stats, walk

TOL = 1e-5
_KNOBS = ("H2O_TPU_GOSS", "H2O_TPU_GOSS_TOP_A", "H2O_TPU_GOSS_RAND_B")


@contextlib.contextmanager
def goss_env(on=True, a="0.2", b="0.3", **extra):
    """GOSS knobs (and ``extra`` env vars) set for the block."""
    new = dict(extra)
    if on:
        new.update(H2O_TPU_GOSS="1", H2O_TPU_GOSS_TOP_A=a,
                   H2O_TPU_GOSS_RAND_B=b)
    keys = set(_KNOBS) | set(new)
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(new)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bern_cols(n=4096, seed=0, F=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[::29, 2] = np.nan
    y = np.where(X[:, 0] + 0.5 * X[:, 1]
                 + rng.normal(scale=0.5, size=n) > 0, "p", "n")
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["y"] = y
    return cols


def exact_cols(n=4096, seed=11, F=5):
    """y in {0, 1}, exactly half ones: the gaussian prior is 0.5 and the
    first round's gradients ±0.5, so with a dyadic amplification every
    histogram sum is exact."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = np.zeros(n, dtype=np.float32)
    y[rng.permutation(n)[: n // 2]] = 1.0
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["y"] = y
    return cols


def three_class_cols(n=2048, seed=2):
    """Three noisy classes: no node of a shallow tree is pure (a pure
    node's split gains are all rounding noise)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    s = x + 0.5 * x2 + rng.normal(scale=0.8, size=n)
    return {"x": x, "x2": x2,
            "y": np.where(s > 0.5, "a", np.where(s < -0.5, "b", "c"))}


def _same_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.trees, b.trees))


CONFIGS = {
    # name: (estimator pair, kwargs, columns, (a, b))
    "gbm_bernoulli": ((GBM, JGBM), dict(ntrees=3, max_depth=3, seed=3),
                      bern_cols, ("0.2", "0.3")),
    "xgboost_logistic": ((XGBoost, JXGB),
                         dict(ntrees=3, max_depth=3, seed=1),
                         lambda: bern_cols(seed=3), ("0.2", "0.3")),
    "gbm_multinomial": ((GBM, JGBM), dict(ntrees=3, max_depth=3, seed=0),
                        three_class_cols, ("0.2", "0.3")),
    "gaussian_exact": ((GBM, JGBM),
                       dict(ntrees=1, max_depth=2, distribution="gaussian",
                            seed=6, min_rows=4.0),
                       exact_cols, ("0.5", "0.25")),
}


@pytest.fixture(scope="module")
def trained():
    out = {}
    with use_mesh(make_mesh(n_rows=1)):
        for name, ((T, J), kw, make, (a, b)) in CONFIGS.items():
            cols = make()
            jf = h2o.Frame.from_arrays(cols)
            tf = Frame.from_arrays(cols, device="cpu")
            with goss_env(a=a, b=b):
                jm = J(**kw).train(y="y", training_frame=jf)
                tm = T(**kw).train(y="y", training_frame=tf)
            X = np.asarray(jm._design_matrix(jf))[: jf.nrows]
            out[name] = dict(jm=jm, tm=tm, tf=tf, X=X, ab=(float(a),
                                                           float(b)))
    return out


def test_round_keys_bitwise():
    got = tcore.goss_round_keys(prng.key(7), 5).numpy().astype(np.uint32)
    want = np.asarray(jax.random.key_data(
        jcore.goss_round_keys(jax.random.key(7), 5)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("multi", [False, True])
def test_threshold_and_factor_bitwise(multi):
    """The count histogram, the threshold and the per-row factor at
    the same (kg, row ids, |g|), with massive ties (two |g| values over
    most rows, as a first bernoulli round has) and dead rows; the
    reference jitted, as its training runs it (XLA fuses the
    threshold's multiply-add)."""
    rng = np.random.default_rng(5)
    n = 3000
    g = np.where(rng.random(n) < 0.7, 0.25, -0.75).astype(np.float32)
    g[::7] = rng.normal(size=len(g[::7])).astype(np.float32)
    if multi:
        g = np.stack([g, -0.5 * g, rng.normal(size=n).astype(np.float32)])
    w = (rng.random(n) > 0.1).astype(np.float32)
    row_ids = np.arange(n, dtype=np.int32) + 5000
    a, b = 0.2, 0.3
    kg = jcore.goss_round_keys(jax.random.key(3), 2)[1]
    tkg = tcore.goss_round_keys(prng.key(3), 2)[1]

    @jax.jit
    def reference(g, w, kg, row_ids):
        absg = jcore.goss_rank_stat(g, w)
        m = jnp.max(absg)
        counts, total = jcore.goss_local_counts(absg, w > 0, m)
        T, frac = jcore.goss_threshold(counts, total, a)
        return absg, counts, total, T, frac, jcore.goss_row_factor(
            absg, w > 0, m, T, frac, kg, row_ids, a, b)
    absg, counts, total, T, frac, fac = reference(
        jnp.asarray(g), jnp.asarray(w), kg, jnp.asarray(row_ids))

    tg, tw = torch.as_tensor(g), torch.as_tensor(w)
    tabs = tcore.goss_rank_stat(tg, tw)
    tm_ = torch.max(tabs)
    tcounts, ttotal = tcore.goss_local_counts(tabs, tw > 0, tm_)
    tT, tfrac = tcore.goss_threshold(tcounts, ttotal, a)
    tfac = tcore.goss_row_factor(tabs, tw > 0, tm_, tT, tfrac, tkg,
                                 torch.as_tensor(row_ids), a, b)
    np.testing.assert_array_equal(tabs.numpy(), np.asarray(absg))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    assert int(ttotal) == int(total)
    assert int(tT) == int(T) and float(tfrac) == float(frac)
    np.testing.assert_array_equal(tfac.numpy(), np.asarray(fac))
    assert set(np.unique(tfac.numpy())) <= {0.0, 1.0, np.float32(
        (1 - a) / b)}


@pytest.mark.parametrize("cap", [64, 400, 1000])
def test_compact_equals_nonzero(cap):
    """``goss_compact``'s cumsum-position scatter against the
    reference's ``nonzero(size=cap, fill_value=0)``: the gathered codes,
    g, h and weights, and the overflow count (cap 64 overflows)."""
    rng = np.random.default_rng(1)
    n, F = 1000, 3
    binned = rng.integers(0, 255, size=(n, F)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    w_amp = np.where(rng.random(n) < 0.3, 2.0, 0.0).astype(np.float32)
    want = jcore.goss_compact(jnp.asarray(binned), jnp.asarray(g),
                              jnp.asarray(h), jnp.asarray(w_amp), cap)
    got = tcore.goss_compact(torch.as_tensor(binned.T.copy()),
                             torch.as_tensor(g), torch.as_tensor(h),
                             torch.as_tensor(w_amp), cap)
    np.testing.assert_array_equal(got[0].numpy().T, np.asarray(want[0]))
    for x, y in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(got[4]) == int(want[4])
    assert (int(got[4]) > 0) == (cap == 64)


def test_kill_switch_and_identity():
    """``H2O_TPU_GOSS=0`` trains bitwise as no GOSS; a = b = 0.5 keeps
    every row at amplification 1, so masking, compaction and the
    re-descent are neutral: bitwise as no GOSS too; other knobs change
    the trees."""
    tf = Frame.from_arrays(bern_cols(2048, seed=5), device="cpu")
    kw = dict(ntrees=3, max_depth=3, seed=2)
    with goss_env(on=False):
        base = GBM(**kw).train(y="y", training_frame=tf)
    with goss_env(on=False, H2O_TPU_GOSS="0"):
        off = GBM(**kw).train(y="y", training_frame=tf)
    with goss_env(a="0.5", b="0.5"):
        ident = GBM(**kw).train(y="y", training_frame=tf)
    with goss_env(a="0.2", b="0.2"):
        on = GBM(**kw).train(y="y", training_frame=tf)
    assert _same_trees(base, off) and _same_trees(base, ident)
    assert not _same_trees(base, on)


@pytest.mark.parametrize("name", ["gbm_bernoulli", "xgboost_logistic"])
def test_structure_and_predictions_vs_reference(trained, name):
    c = trained[name]
    tm, jm = c["tm"], c["jm"]
    stats, binned = round_stats(tm, c["tf"], "y", {}, goss=c["ab"])
    lam = tm.params.reg_lambda
    compared, ties, gaps = walk(tm, jm, stats, binned, lam=lam)
    assert compared >= 20 and len(ties) <= 2, (compared, ties)
    assert gaps.max() <= TOL, gaps.max()
    if not ties:
        np.testing.assert_allclose(tm.score_numpy(c["X"]),
                                   np.asarray(jm.score_numpy(c["X"])),
                                   rtol=0, atol=TOL)


def test_multinomial_vs_reference(trained):
    """One GOSS draw per round for the K class trees, rows ranked by the
    class L1 norm of g: the class trees' structure equal, leaves and
    probabilities within 1e-5."""
    c = trained["gbm_multinomial"]
    tm, jm = c["tm"], c["jm"]
    assert tm.trees.value.shape[0] == 9
    for f in ("is_split", "split_feat", "split_bin", "na_left"):
        isp = np.asarray(jm.trees.is_split)
        np.testing.assert_array_equal(
            np.where(isp, getattr(tm.trees, f).numpy(), -9),
            np.where(isp, np.asarray(getattr(jm.trees, f)), -9), err_msg=f)
    np.testing.assert_allclose(tm.trees.value.numpy(),
                               np.asarray(jm.trees.value), rtol=0,
                               atol=TOL)
    got = tm.score_numpy(c["X"])
    want = np.asarray(jm.score_numpy(c["X"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_exact_round_bitwise(trained):
    """Dyadic gradients (±0.5) and a dyadic amplification ((1-a)/b =
    2): every sum exact, so the GOSS tree is the reference's to the
    last bit."""
    c = trained["gaussian_exact"]
    for f in tcore.Tree._fields:
        np.testing.assert_array_equal(
            getattr(c["tm"].trees, f).numpy(),
            np.asarray(getattr(c["jm"].trees, f)), err_msg=f)


def test_drf_and_rank_untouched():
    tf = Frame.from_arrays(bern_cols(1024, seed=8), device="cpu")
    kw = dict(ntrees=3, max_depth=3, seed=2)
    with goss_env(a="0.1", b="0.1"):
        d_on = DRF(**kw).train(y="y", training_frame=tf)
    with goss_env(on=False):
        d_off = DRF(**kw).train(y="y", training_frame=tf)
    assert _same_trees(d_on, d_off)
    rng = np.random.default_rng(4)
    rcols = {f"f{i}": rng.normal(size=600).astype(np.float32)
             for i in range(4)}
    rcols["rel"] = rng.integers(0, 3, 600).astype(np.float32)
    rcols["qid"] = np.repeat(np.arange(30), 20).astype(np.float32)
    rf = Frame.from_arrays(rcols, device="cpu")
    rk = dict(ntrees=2, max_depth=3, seed=1, distribution="rank:ndcg")
    with goss_env(a="0.1", b="0.1"):
        r_on = XGBoost(**rk).train(y="rel", training_frame=rf,
                                   group_column="qid")
    with goss_env(on=False):
        r_off = XGBoost(**rk).train(y="rel", training_frame=rf,
                                    group_column="qid")
    assert _same_trees(r_on, r_off)


@pytest.mark.parametrize("knobs, kw", [
    (("0.9", "0.5"), {}),              # a + b > 1
    (("0.1", "0"), {}),                # b must be > 0
    (("0.1", "0.1"), {"sample_rate": 0.8}),
])
def test_errors_match_reference(knobs, kw):
    cols = bern_cols(512, seed=4)
    errs = []
    with use_mesh(make_mesh(n_rows=1)), goss_env(a=knobs[0], b=knobs[1]):
        for est, fr in ((JGBM, h2o.Frame.from_arrays(cols)),
                        (GBM, Frame.from_arrays(cols, device="cpu"))):
            with pytest.raises(ValueError) as e:
                est(ntrees=1, max_depth=2, seed=0, **kw).train(
                    y="y", training_frame=fr)
            errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert ("sample_rate" if kw else "GOSS") in errs[1]


def test_overflow_warns(caplog):
    """Every high-|g| row in the last out-of-core chunk: that chunk
    selects past its buffer and the drop is logged; the same rows
    shuffled do not overflow."""
    n = 4096
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.zeros(n, dtype=np.float32)
    y[3584:] = 10.0
    kw = dict(ntrees=1, max_depth=3, distribution="gaussian", seed=1)
    logger = "h2o_kubernetes_tpu_torch"
    for order, warns in ((np.arange(n), True), (rng.permutation(n), False)):
        cols = {f"f{i}": X[order, i] for i in range(4)}
        cols["y"] = y[order]
        tf = Frame.from_arrays(cols, device="cpu")
        caplog.clear()
        with goss_env(a="0.1", b="0.05", H2O_TPU_OOC="1",
                      H2O_TPU_OOC_CHUNK_ROWS="512"), \
                caplog.at_level(logging.WARNING, logger=logger):
            m = GBM(**kw).train(y="y", training_frame=tf)
        assert m.trees.value.shape[0] == 1 and m.ooc_stats is not None
        assert any("GOSS compaction overflow" in r.message
                   for r in caplog.records) == warns
