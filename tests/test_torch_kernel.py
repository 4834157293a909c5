"""PyTorch port, the TreeSHAP kernel wrapper on its own (no JAX here,
so the card-only cases also run where the JAX package is absent).

On the CPU the wrapper is its plain version. On a CUDA card
(``-m cuda``) the kernel must agree with the plain version BITWISE —
both add the same f32 values to each phi entry in the same order — in
every launch variant and at every plan that fits a block, and a whole
``contrib_numpy`` on the card must equal the same call on the CPU
bitwise too.
"""

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch import load_artifact
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.ops import shap_kernel

_ENUMS = (3,)


@pytest.fixture(scope="module")
def case():
    blob = random_tree_artifact(31, n_features=9, ntrees=10, max_depth=5,
                                enum_features=_ENUMS)
    X = random_rows(32, 777, 9, nan_frac=0.03, enum_features=_ENUMS)
    return blob, X


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_cpu_wrapper_is_plain_and_launches_nothing(case):
    blob, X = case
    m = load_artifact(blob, device="cpu")
    groups, ctabs = m._contrib_prepare()
    assert len(groups) > 1 and all(c is not None for c in ctabs)
    em = m._contrib_enum_mask()
    Xt = torch.as_tensor(X)
    before = shap_kernel.flat_shap_tab_kernel.launches
    for g, ct in zip(groups, ctabs):
        got = shap_kernel.flat_shap_tab_kernel(g, ct, Xt, em)
        assert torch.equal(got,
                           shap_kernel.flat_shap_tab_plain(g, ct, Xt, em))
    assert shap_kernel.flat_shap_tab_kernel.launches == before


def test_contributions_additive_on_cpu(case):
    blob, X = case
    m = load_artifact(blob, device="cpu")
    phi = m.contrib_numpy(X)
    p1 = m.score_numpy(X)[:, 1].astype(np.float64)
    np.testing.assert_allclose(phi.sum(axis=1), np.log(p1 / (1 - p1)),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_bitwise_vs_plain_on_card(case):
    dev = _card()
    blob, X = case
    m = load_artifact(blob, device=dev)
    groups, ctabs = m._contrib_prepare()
    em = m._contrib_enum_mask()
    Xd = torch.as_tensor(X, device=dev)
    for g, ct in zip(groups, ctabs):
        before = shap_kernel.flat_shap_tab_kernel.launches
        got = shap_kernel.flat_shap_tab_kernel(g, ct, Xd, em)
        assert shap_kernel.flat_shap_tab_kernel.launches == before + 1
        assert torch.equal(got,
                           shap_kernel.flat_shap_tab_plain(g, ct, Xd, em))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    dev = _card()
    blob, X = case
    m = load_artifact(blob, device=dev)
    groups, ctabs = m._contrib_prepare()
    g, ct = groups[-1], ctabs[-1]
    em = m._contrib_enum_mask()
    Xd = torch.as_tensor(X, device=dev)
    with pytest.raises(TypeError):
        shap_kernel.flat_shap_tab_kernel(g, ct, Xd.double(), em)
    with pytest.raises(ValueError):
        shap_kernel.flat_shap_tab_kernel(g, ct.transpose(2, 3), Xd, em)
    with pytest.raises(ValueError):
        shap_kernel.flat_shap_tab_kernel(g, ct.cpu(), Xd, em)


@pytest.mark.cuda
def test_serving_on_card_equals_cpu(case):
    dev = _card()
    blob, X = case
    on_card = load_artifact(blob, device=dev)
    on_cpu = load_artifact(blob, device="cpu")
    before = shap_kernel.flat_shap_tab_kernel.launches
    phi = on_card.contrib_numpy(X)
    assert shap_kernel.flat_shap_tab_kernel.launches > before
    np.testing.assert_array_equal(phi, on_cpu.contrib_numpy(X))
    np.testing.assert_allclose(on_card.score_numpy(X),
                               on_cpu.score_numpy(X), atol=1e-6, rtol=0)


_VARIANT_ROWS = (1, 127, 128, 4096, 100_000)
_VARIANT_ENUMS = (3, 7)


def _forced_plans(F, T, L, D, rows):
    """Every (rows per block, stage buffers) that fits a block, and the
    device-memory variant: each launch the plan could pick."""
    LD = L * D
    buf = -(-(4 * LD + (LD << D)) // 4) * 4
    plans = []
    for R in (256, 128, 64, 32):
        for stages in (2, 1, 0):
            smem = 4 * (stages * buf + R * shap_kernel._row_floats(F))
            if smem <= shap_kernel.BLOCK_SMEM:
                plans.append(shap_kernel.ShapPlan(
                    "staged" if stages else "unstaged", R, stages,
                    buf if stages else 0, smem, -(-rows // R), 1))
    plans.append(shap_kernel.ShapPlan("global_phi", 128, 0, 0, 0,
                                      -(-rows // 128), 1))
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("F,depth,ntrees", [(28, 9, 4), (1000, 5, 6)],
                         ids=["F28", "wideF"])
def test_every_variant_bitwise_vs_plain_on_card(F, depth, ntrees):
    """The wrapper's own plan and every other plan that fits, at 1 / 127
    / 128 / 4,096 / 100,000 rows with NaNs and negative enum codes, equal
    the plain version bitwise. The depth-9 model's groups take both the
    staged and the unstaged variant; at 1,000 features phi and X of 32
    rows do not fit a block, and the wrapper keeps phi in device
    memory."""
    dev = _card()
    blob = random_tree_artifact(71, n_features=F, ntrees=ntrees,
                                max_depth=depth, p_leaf=0.05,
                                enum_features=_VARIANT_ENUMS)
    X = random_rows(72, max(_VARIANT_ROWS), F, nan_frac=0.02,
                    enum_features=_VARIANT_ENUMS)
    m = load_artifact(blob, device=dev)
    groups, ctabs = m._contrib_prepare()
    em = m._contrib_enum_mask()
    Xd = torch.as_tensor(X, device=dev)
    chosen = set()
    for g, ct, sl in zip(groups, ctabs, m._shap_slots):
        T, L, D = g.feat.shape
        for n in _VARIANT_ROWS:
            Xn = Xd[:n]
            want = shap_kernel.flat_shap_tab_plain(g, ct, Xn, em)
            before = dict(shap_kernel.LAUNCHES)
            got = shap_kernel.flat_shap_tab_kernel(g, ct, Xn, em, slots=sl)
            plan = shap_kernel.shap_plan(F, T, L, D, n)
            assert shap_kernel.LAUNCHES[plan.variant] \
                == before[plan.variant] + 1
            assert torch.equal(got, want), (plan, n)
            chosen.add(plan.variant)
            for p in _forced_plans(F, T, L, D, n):
                out = shap_kernel._launch(g, ct, Xn, em, sl, p)
                torch.cuda.synchronize()
                assert torch.equal(out, want), (p, n)
        # a table 4 bytes off 16-byte alignment takes the 4-byte copies
        off = torch.cat([ct.new_zeros(1), ct.reshape(-1)])[1:].view(ct.shape)
        assert off.data_ptr() % 16
        Xn = Xd[:4096]
        assert torch.equal(
            shap_kernel.flat_shap_tab_kernel(g, off, Xn, em, slots=sl),
            shap_kernel.flat_shap_tab_plain(g, ct, Xn, em))
    assert chosen == ({"staged", "unstaged"} if F == 28 else
                      {"global_phi"})
