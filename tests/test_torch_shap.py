"""PyTorch port, TreeSHAP: the port's table builders and plain torch
evaluators against the JAX package, on a small GBM trained by the JAX
package on the CPU.

Tolerances: the builders are numpy code kept line for line, so their
arrays are compared bitwise. The evaluators sum f32 terms in a fixed
order that need not be XLA's scatter order (the JAX package's own two
implementations already differ in the last ulp), so they are held to
atol=1e-6, rtol=1e-5.
"""

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM
from h2o_kubernetes_tpu.models.tree import shap as jshap
from h2o_kubernetes_tpu_torch.models.tree import shap as tshap
from h2o_kubernetes_tpu_torch.ops import shap_kernel

ATOL, RTOL = 1e-6, 1e-5


def _frame(n=400, seed=7):
    """6 numeric features with NaNs + one enum column, weights, and a
    binary response."""
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.normal(size=n).astype(np.float32)
            for i in range(6)}
    cols["x0"][::17] = np.nan
    cols["x3"][::11] = np.nan
    c = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)]
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    y = np.where(np.nan_to_num(cols["x0"]) + 0.5 * cols["x1"]
                 + (c == "a") + rng.normal(scale=0.5, size=n) > 0,
                 "p", "n")
    return h2o.Frame.from_arrays({**cols, "c": c, "w": w, "y": y})


@pytest.fixture(scope="module", params=[1, 4], ids=["depth1", "depth4"])
def trained(request, mesh8):
    fr = _frame()
    m = GBM(ntrees=6, max_depth=request.param, nbins=64, seed=1).train(
        y="y", training_frame=fr, weights_column="w")
    flat, cover = m._shap_sources()
    X = np.asarray(m._design_matrix(fr))[: fr.nrows][:300].copy()
    em = np.asarray(m._enum_mask).astype(bool)
    ecol = int(np.flatnonzero(em)[0])
    X[::7, ecol] = -1.0          # negative enum codes are NA
    groups = jshap.build_shap_table_groups(flat, cover)
    return request.param, flat, cover, X, em, groups


def _ctabs(groups, module):
    remaining = module._PATTERN_TABLE_MAX_BYTES
    out = []
    for g in groups:
        c = module.pattern_table(g, budget=remaining)
        if c is not None:
            remaining -= c.nbytes
        out.append(c)
    return out


def _torch_tables(g):
    return tshap.ShapTables(*(torch.as_tensor(np.asarray(a)) for a in g))


def test_group_count(trained):
    depth, *_, groups = trained
    if depth == 1:
        assert len(groups) == 1
    else:
        assert len(groups) > 1


def test_table_builders_bitwise(trained):
    _, flat, cover, _, _, jgroups = trained
    tgroups = tshap.build_shap_table_groups(flat, cover)
    assert len(tgroups) == len(jgroups)
    for jg, tg in zip(jgroups, tgroups):
        for name, ja, ta in zip(jg._fields, jg, tg):
            ja, ta = np.asarray(ja), np.asarray(ta)
            assert ja.dtype == ta.dtype, name
            np.testing.assert_array_equal(ta, ja, err_msg=name)
    for jc, tc in zip(_ctabs(jgroups, jshap), _ctabs(tgroups, tshap)):
        assert (jc is None) == (tc is None)
        if jc is not None:
            assert jc.dtype == tc.dtype
            np.testing.assert_array_equal(tc, jc)


def test_flat_shap_tab_matches_jax(trained):
    _, _, _, X, em, groups = trained
    ctabs = _ctabs(groups, jshap)
    assert all(c is not None for c in ctabs)
    for g, ct in zip(groups, ctabs):
        want = np.asarray(jshap.flat_shap_tab(g, ct, X, em))
        got = tshap.flat_shap_tab(_torch_tables(g), torch.as_tensor(ct),
                                  torch.as_tensor(X), torch.as_tensor(em))
        assert got.shape == (X.shape[0], X.shape[1] + 1)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_flat_shap_dp_matches_jax(trained):
    _, _, _, X, em, groups = trained
    for g in groups:
        want = np.asarray(jshap.flat_shap(g, X, em))
        got = tshap.flat_shap(_torch_tables(g), torch.as_tensor(X),
                              torch.as_tensor(em))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_kernel_wrapper_on_cpu_is_the_plain_version(trained):
    """On CPU tensors the wrapper returns exactly the plain version's
    output and launches nothing."""
    _, _, _, X, em, groups = trained
    before = shap_kernel.flat_shap_tab_kernel.launches
    for g, ct in zip(groups, _ctabs(groups, jshap)):
        args = (_torch_tables(g), torch.as_tensor(ct), torch.as_tensor(X),
                torch.as_tensor(em))
        assert torch.equal(shap_kernel.flat_shap_tab_kernel(*args),
                           shap_kernel.flat_shap_tab_plain(*args))
    assert shap_kernel.flat_shap_tab_kernel.launches == before

