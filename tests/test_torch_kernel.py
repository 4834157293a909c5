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
    groups, ctabs, _ = m._contrib_prepare()
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
    groups, ctabs, _ = m._contrib_prepare()
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
    groups, ctabs, _ = m._contrib_prepare()
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
    groups, ctabs, _ = m._contrib_prepare()
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


@pytest.mark.cuda
def test_score_graphs_bitwise_and_evicted_with_the_model(case):
    """On the card ``score_numpy`` replays one CUDA graph of the descent
    per batch bucket: the same bits as the eager descent (and within
    the serving contract's 1e-6 of the CPU's probabilities: the card's
    sigmoid may differ by an ulp); an eviction drops the graphs and the
    promotion recaptures them."""
    from h2o_kubernetes_tpu_torch.models.base import (_batch_bucket,
                                                      evict_scorer_cache)

    dev = _card()
    blob, X = case
    m = load_artifact(blob, device=dev)
    cpu = load_artifact(blob, device="cpu")
    outs = {}
    for n in (1, 128, 129, 777):
        b = _batch_bucket(n)
        Xp = np.zeros((b, X.shape[1]), np.float32)
        Xp[:n] = X[:n]
        m._cached("score")
        eager = m._score_matrix(torch.as_tensor(Xp, device=dev),
                                None)[:n].cpu().numpy()
        outs[n] = m.score_numpy(X[:n])
        np.testing.assert_array_equal(outs[n], eager)
        np.testing.assert_allclose(outs[n], cpu.score_numpy(X[:n]),
                                   rtol=0, atol=1e-6)
    buckets = [(128, False), (256, False), (1024, False)]
    assert sorted(m._score_graphs) == buckets
    charge = m._serving_resident_bytes()
    assert charge > sum(e.nbytes for e in m._score_graphs.values()) > 0
    assert evict_scorer_cache(m) == 1
    assert "_score_graphs" not in m.__dict__
    np.testing.assert_array_equal(m.score_numpy(X[:129]), outs[129])
    assert sorted(m._score_graphs) == buckets
    for n, want in outs.items():
        np.testing.assert_array_equal(m.score_numpy(X[:n]), want)


@pytest.mark.cuda
def test_score_graphs_with_offset_bitwise(case):
    """A per-row offset is an input of its own graph: the replay equals
    the eager descent with the same offsets bitwise, and the graph
    without an offset stays as it was."""
    dev = _card()
    blob, X = case
    m = load_artifact(blob, device=dev)
    off = np.random.default_rng(3).normal(size=X.shape[0]).astype(np.float32)
    plain = m.score_numpy(X)
    for n in (1, 300, 777):
        b = 128
        while b < n:
            b *= 2
        Xp = np.zeros((b, X.shape[1]), np.float32)
        Xp[:n] = X[:n]
        op = np.zeros(b, np.float32)
        op[:n] = off[:n]
        eager = m._score_matrix(torch.as_tensor(Xp, device=dev),
                                torch.as_tensor(op, device=dev))
        got = m.score_numpy(X[:n], offset=off[:n])
        np.testing.assert_array_equal(got, eager[:n].cpu().numpy())
        assert (b, True) in m._score_graphs
    np.testing.assert_array_equal(m.score_numpy(X), plain)


@pytest.mark.cuda
def test_profile_names_the_kernel_and_device_memory_reads_the_card(
        case, tmp_path):
    """``diagnostics.profile`` on the card records the TreeSHAP kernel
    by name; ``device_memory`` and ``cluster_status`` read the card."""
    import json

    import h2o_kubernetes_tpu_torch as port
    from h2o_kubernetes_tpu_torch.diagnostics import device_memory, profile

    blob, X = case
    dev = _card()
    m = load_artifact(blob, device=dev)
    m.contrib_numpy(X)
    with profile(str(tmp_path)) as prof:
        m.contrib_numpy(X)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("shap_tab" in str(ev.get("name"))
               for ev in trace["traceEvents"])
    assert any("shap_tab" in a.key for a in prof.key_averages())
    mem = device_memory()
    assert mem[0]["bytes_in_use"] > 0
    assert 0 < mem[0]["bytes_free"] < mem[0]["bytes_limit"]
    st = port.cluster_status()
    assert st["cloud_size"] == 1 and \
        torch.cuda.get_device_name(0) in st["devices"][0]
