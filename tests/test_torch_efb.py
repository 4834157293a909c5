"""PyTorch port, Exclusive Feature Bundling against the JAX package on
the CPU, its reference on a one-row-shard mesh.

Held here:
- the plan equals the reference's: its columns, members, slot maps,
  conflicts and demotions, the ``EFBLuts`` bitwise, and the bundled
  matrix bitwise to the reference's transposed (the port's is
  feature-major);
- the conflict budget and the gate (``H2O_TPU_EFB``, ``_MIN_F``,
  ``_MIN_SHRINK``) decide as the reference's do, for the planner and
  for ``auto`` on a 70-feature frame;
- ``_find_splits_efb`` on a seeded bundled histogram gives the
  reference's (feature, bin, NA side) exactly and its gains within
  1e-6 relative;
- a DRF forest on a 0/1 response and one gaussian GBM round on a dyadic
  one, bundled, bitwise to the JAX package's bundled train (every sum
  exact); a 3-round bernoulli with equal structure up to float64
  near-ties and leaves within 1e-5;
- multinomial: the port's bundled train equal to its own unbundled
  train in structure, leaves within 1e-3 of the tree's largest |leaf|
  and probabilities within 1e-4 (a small child's default-side sums are
  a large parent total minus the member's; the reference's own bundled
  multinomial parity test fails, so it is not the yardstick);
- a bundled model's artifact loads in the JAX package with bitwise
  margins: serving never sees a bundle.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.operator import registry as jreg
from h2o_kubernetes_tpu.models import DRF as JDRF
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.models.tree import efb as JE
from h2o_kubernetes_tpu.models.tree.binning import fit_bins as jfit_bins
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import DRF, GBM, Frame, export_mojo
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.models.tree import efb as TE
from h2o_kubernetes_tpu_torch.models.tree.binning import fit_bins
from tools.torch_tree_parity import round_stats, walk

TOL = 1e-5
_EFB_KNOBS = ("H2O_TPU_EFB", "H2O_TPU_EFB_CONFLICT", "H2O_TPU_EFB_MIN_F",
              "H2O_TPU_EFB_MIN_SHRINK")
STRUCT = ("is_split", "split_feat", "split_bin", "na_left")


@contextlib.contextmanager
def efb_env(**kv):
    """Every EFB knob unset, then ``kv`` set, for the block."""
    old = {k: os.environ.get(k) for k in set(_EFB_KNOBS) | set(kv)}
    for k in old:
        os.environ.pop(k, None)
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wide_cols(n=4096, n_groups=6, card=8, seed=0, dyadic_y=True):
    """One-hot groups (exclusive within a group), two dense numerics, a
    sparse enum and NAs in one one-hot column and the enum."""
    rng = np.random.default_rng(seed)
    cols, cats = {}, []
    for g in range(n_groups):
        cat = rng.integers(0, card, size=n)
        cats.append(cat)
        for k in range(card):
            v = (cat == k).astype(np.float32)
            if g == 0 and k == 0:
                v[::37] = np.nan
            cols[f"g{g}_{k}"] = v
    cols["d0"] = rng.normal(size=n).astype(np.float32)
    cols["d1"] = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    e = rng.integers(0, 3, size=n).astype(np.float32)
    e[rng.random(n) > 0.06] = 0.0
    e[1::53] = np.nan
    cols["e0"] = e
    if dyadic_y:
        y = (cats[0] == 1) | ((cols["d0"] > 0) & (cats[1] == 2))
        cols["y"] = y.astype(np.float32)
    else:
        cols["y"] = (cols["d0"] + (cats[0] == 1) - (cats[1] == 2)
                     + rng.normal(scale=0.5, size=n) > 0.3
                     ).astype(np.float32)
    return cols


def conflict_cols(n=2048):
    rng = np.random.default_rng(1)
    a = (rng.random(n) < 0.05).astype(np.float32)
    b = (rng.random(n) < 0.05).astype(np.float32)
    return {"a": a, "b": b, "c": (rng.random(n) < 0.04).astype(np.float32),
            "y": (a + rng.normal(size=n)).astype(np.float32)}


_DOMAINS = {"e0": ["a", "b", "c"]}


def frames(cols):
    domains = {k: v for k, v in _DOMAINS.items() if k in cols}
    return (h2o.Frame.from_arrays(cols, domains=domains),
            Frame.from_arrays(cols, domains=domains, device="cpu"))


def _member(m):
    return (m.feat, m.default_bin, m.slot_of_code.tolist(), list(m.body),
            m.na_slot)


def _cols_of(plan):
    return [(k, p if k == "pass" else [_member(m) for m in p])
            for k, p in plan.cols]


@pytest.mark.parametrize("case", ["wide", "conflict0", "conflict_half"])
def test_plan_equals_reference(case):
    cols = conflict_cols() if case.startswith("conflict") \
        else wide_cols(n=2048)
    env = {"H2O_TPU_EFB": "1"}
    if case == "conflict_half":
        env["H2O_TPU_EFB_CONFLICT"] = "0.5"
    names = [c for c in cols if c != "y"]
    with use_mesh(make_mesh(n_rows=1)), efb_env(**env):
        jf, tf = frames(cols)
        jplan = JE.plan_bundles(jf, jfit_bins(jf, names))
        tplan = TE.plan_bundles(tf, fit_bins(tf, names))
    if jplan is None:
        assert tplan is None
        return
    assert _cols_of(tplan) == _cols_of(jplan)
    assert (tplan.conflicts, tplan.demoted) == (jplan.conflicts,
                                                jplan.demoted)
    np.testing.assert_array_equal(tplan.binned_host,
                                  jplan.binned_host[: tf.nrows].T)
    for f, a in zip(TE.EFBLuts._fields, tplan.device_luts()):
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(getattr(jplan.device_luts(), f)),
            err_msg=f)
    if case == "conflict_half":
        assert tplan.conflicts > 0


@pytest.mark.parametrize("env, F, fb", [
    ({}, 11, 5), ({}, 64, 40), ({}, 64, 60), ({"H2O_TPU_EFB": "0"}, 200, 10),
    ({"H2O_TPU_EFB": "1"}, 3, 2), ({"H2O_TPU_EFB": "1"}, 64, 63),
    ({"H2O_TPU_EFB_MIN_F": "10"}, 11, 8),
    ({"H2O_TPU_EFB_MIN_SHRINK": "0.5"}, 80, 45),
    ({"H2O_TPU_EFB": "auto", "H2O_TPU_EFB_CONFLICT": "x"}, 70, 52)])
def test_gate_matches_reference(env, F, fb):
    with efb_env(**env):
        assert TE.efb_mode() == JE.efb_mode()
        assert TE.conflict_budget_frac() == JE.conflict_budget_frac()
        for ck in (None, object()):
            assert TE.efb_eligible(F, ck) == JE.efb_eligible(F, ck)
        assert TE._keep_plan(F, fb) == JE._keep_plan(F, fb)


@pytest.mark.parametrize("shrink", ["0.75", "0.05"])
def test_auto_bundles_when_reference_does(shrink):
    """``auto`` on a 70-feature frame: the port trains bundled exactly
    when the JAX package plans a bundling (and not when the shrink gate
    refuses it)."""
    cols = wide_cols(n=1024, n_groups=8, card=8, seed=3)
    names = [c for c in cols if c != "y"]
    assert len(names) == 67
    with use_mesh(make_mesh(n_rows=1)), \
            efb_env(H2O_TPU_EFB_MIN_SHRINK=shrink):
        jf, tf = frames(cols)
        jplan = JE.fit_plan_cached(jf, names, 256)[1]
        m = GBM(ntrees=1, max_depth=2, seed=1).train(y="y", training_frame=tf)
        tplan = TE.fit_plan_cached(tf, names, 256)[1]
    assert (tplan is None) == (jplan is None)
    assert (tplan is not None) == (shrink == "0.75")
    assert m.trees.value.shape[0] == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_find_splits_efb_matches_reference(seed):
    cols = wide_cols(n=1024, seed=4)
    names = [c for c in cols if c != "y"]
    with use_mesh(make_mesh(n_rows=1)), efb_env(H2O_TPU_EFB="1"):
        jf, tf = frames(cols)
        jl = JE.plan_bundles(jf, jfit_bins(jf, names)).device_luts()
        tl = TE.plan_bundles(tf, fit_bins(tf, names)).device_luts()
    rng = np.random.default_rng(seed)
    n, Fb, B = 4, jl.slot_feat.shape[0], 256
    cnt = rng.poisson(3.0, size=(n, Fb, B)).astype(np.float32)
    hist = np.stack([rng.normal(size=(n, Fb, B)) * cnt, cnt * 0.25, cnt],
                    axis=-1).astype(np.float32)
    feat_ok = rng.random((n, len(names))) < (0.6 if seed else 1.0)
    jp = jcore.TreeParams(max_depth=3, n_bins=B, min_rows=2.0)
    tp = tcore.TreeParams(max_depth=3, n_bins=B, min_rows=2.0)
    want = jax.jit(jcore._find_splits, static_argnums=1)(
        jnp.asarray(hist), jp, jnp.asarray(feat_ok), jl)
    got = tcore._find_splits(torch.as_tensor(hist), tp,
                             torch.as_tensor(feat_ok), tl)
    for i in (0, 1, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    g_t, g_j = got[5].numpy(), np.asarray(want[5])
    assert np.all(np.abs(g_t - g_j) <= 1e-6 * np.maximum(np.abs(g_j), 1.0))
    for i in (4, 6, 7, 8):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6, atol=1e-6)


CONFIGS = {
    "drf": ((DRF, JDRF), dict(ntrees=3, max_depth=4, seed=3, mtries=10),
            wide_cols),
    "gaussian": ((GBM, JGBM), dict(ntrees=1, max_depth=3, seed=1,
                                   distribution="gaussian"), wide_cols),
    "bernoulli": ((GBM, JGBM), dict(ntrees=3, max_depth=3, seed=2),
                  lambda: wide_cols(seed=5, dyadic_y=False)),
}


@pytest.fixture(scope="module")
def trained():
    out = {}
    with use_mesh(make_mesh(n_rows=1)), efb_env(H2O_TPU_EFB="1"):
        for name, ((T, J), kw, make) in CONFIGS.items():
            cols = make()
            jf, tf = frames(cols)
            out[name] = dict(jm=J(**kw).train(y="y", training_frame=jf),
                             tm=T(**kw).train(y="y", training_frame=tf),
                             tf=tf, cols=cols)
    return out


@pytest.mark.parametrize("name", ["drf", "gaussian"])
def test_exact_trains_bitwise_vs_reference(trained, name):
    c = trained[name]
    for f in tcore.Tree._fields:
        np.testing.assert_array_equal(
            getattr(c["tm"].trees, f).numpy(),
            np.asarray(getattr(c["jm"].trees, f)), err_msg=f)


def test_bernoulli_near_ties_vs_reference(trained):
    c = trained["bernoulli"]
    stats, binned = round_stats(c["tm"], c["tf"], "y", {})
    compared, ties, gaps = walk(c["tm"], c["jm"], stats, binned)
    assert compared >= 20 and len(ties) <= 2, (compared, ties)
    assert gaps.max() <= TOL, gaps.max()


def test_multinomial_bundled_equals_unbundled():
    cols = wide_cols(seed=7)
    rng = np.random.default_rng(7)
    s = cols["d0"] + 1.5 * np.nan_to_num(cols["g0_1"]) \
        - 1.5 * cols["g1_2"] + rng.normal(scale=0.7, size=len(cols["d0"]))
    cols["y"] = np.where(s > 0.6, "a", np.where(s < -0.6, "b", "c"))
    tf = Frame.from_arrays(cols, domains=_DOMAINS, device="cpu")
    kw = dict(ntrees=2, max_depth=3, seed=4)
    with efb_env(H2O_TPU_EFB="1"):
        m_b = GBM(**kw).train(y="y", training_frame=tf)
    with efb_env(H2O_TPU_EFB="0"):
        m_u = GBM(**kw).train(y="y", training_frame=tf)
    isp = m_u.trees.is_split.numpy()
    for f in STRUCT:
        np.testing.assert_array_equal(
            np.where(isp, getattr(m_b.trees, f).numpy(), -9),
            np.where(isp, getattr(m_u.trees, f).numpy(), -9), err_msg=f)
    # a bundled member's default side is the parent's total minus the
    # member's slots, so a small child's sums carry the f32 rounding of
    # a total ~100x larger: leaves within 1e-3 of the tree's largest
    # |leaf|, probabilities within 1e-4
    vb, vu = m_b.trees.value.numpy(), m_u.trees.value.numpy()
    gap = (np.abs(vb - vu) * ~isp).max(axis=1) / np.abs(vu).max(axis=1)
    assert gap.max() <= 1e-3, gap
    X = m_u._design_matrix(tf).numpy()
    np.testing.assert_allclose(m_b.score_numpy(X), m_u.score_numpy(X),
                               rtol=0, atol=1e-4)


def test_artifact_loads_in_reference(trained):
    """The bundled gaussian model's artifact in the JAX package's
    scorer: margins bitwise the port's. Its trees name original
    features only."""
    m = trained["gaussian"]["tm"]
    assert int(m.trees.split_feat.max()) < len(m.feature_names)
    buf = io.BytesIO()
    export_mojo(m, buf)
    X = m._design_matrix(trained["gaussian"]["tf"]).numpy()
    js = jreg.load_artifact(buf.getvalue())
    ft, em = js._serving_prepare()
    want = np.asarray(jcore.flat_margin(ft, jnp.asarray(X), em,
                                        m.params.max_depth, 1))
    flat, enum_mask = m._serving_prepare()[:2]
    got = tcore.flat_margin(flat, torch.as_tensor(X), enum_mask,
                            m.params.max_depth, 1)
    np.testing.assert_array_equal(got.numpy(), want)
