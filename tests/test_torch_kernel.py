"""PyTorch port, the TreeSHAP kernel wrapper on its own (no JAX here,
so the card-only cases also run where the JAX package is absent).

On the CPU the wrapper is its plain version. On a CUDA card
(``-m cuda``) the kernel must agree with the plain version BITWISE —
both add the same f32 values in the same order — and a whole
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
