"""PyTorch port, the TreeSHAP kernel's launch plan (``shap_plan``), its
slot records (``pack_slots``) and the contributions dispatch rule
(``contrib_dispatch``) — plain Python; no JAX and no card here.

At every depth group of the serving model (28 features, 20 depth-5
trees: T/L/D = 1/22/3, 6/32/4, 14/32/5), at every pattern-table depth
at 32 leaves and at 28, 300 and 3,000 features, the plan must ask no
block for more than the 232,448 bytes of shared memory a block can opt
into. It stages each tree's table slice up to the first depth whose
slice no longer fits beside phi and X of 32 rows, and reads it through
the read-only path past that; phi goes to device memory only where
phi and X of 32 rows do not fit. The dispatch rule hands a CUDA device
whose groups all have pattern tables the whole batch, unpadded; on the
CPU, whole batch and 128-row chunks give the same bits.
"""

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch import load_artifact
from h2o_kubernetes_tpu_torch.models import base
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.ops import shap_kernel as S

_SERVING_GROUPS = ((1, 22, 3), (6, 32, 4), (14, 32, 5))
_ROWS = (1, 127, 128, 4096, 100_000)


def _row_floats(F):
    """X and phi of one row in shared memory, each row padded to odd."""
    return (F | 1) + ((F + 1) | 1)


def _slice_fits(F, L, D):
    """One tree's records and ctab slice beside phi and X of 32 rows."""
    LD = L * D
    return 4 * (4 * LD + (LD << D)) + 4 * 32 * _row_floats(F) \
        <= S.BLOCK_SMEM


def _check(p, F, T, L, D, rows):
    assert p.variant in S.VARIANTS
    assert 0 <= p.smem_bytes <= S.BLOCK_SMEM
    assert p.threads % 32 == 0 and 32 <= p.threads <= 256
    assert p.blocks == -(-rows // p.threads)
    assert p.blocks_per_sm >= 1
    if p.variant == "global_phi":
        assert p.smem_bytes == 0 and p.stages == 0
        return
    assert (p.stages > 0) == (p.variant == "staged")
    if p.stages:
        LD = L * D
        assert p.buf_floats % 4 == 0
        assert p.buf_floats >= 4 * LD + (LD << D)
    assert p.smem_bytes == 4 * (p.stages * p.buf_floats
                                + p.threads * _row_floats(F))


_CASES = ([(28, T, L, D, rows) for T, L, D in _SERVING_GROUPS
           for rows in _ROWS]
          + [(28, 10, 32, D, rows) for D in range(1, 15)
             for rows in (128, 100_000)]
          + [(F, 14, 32, 5, rows) for F in (28, 300, 3000)
             for rows in (1, 100_000)])


@pytest.mark.parametrize("case", _CASES,
                         ids=lambda c: "F{}T{}L{}D{}r{}".format(*c))
def test_plan_fits_the_card(case):
    F, T, L, D, rows = case
    _check(S.shap_plan(F, T, L, D, rows), F, T, L, D, rows)


@pytest.mark.parametrize("F", [28, 300])
def test_staged_up_to_the_first_depth_whose_slice_does_not_fit(F):
    variants = [S.shap_plan(F, 10, 32, D, 100_000).variant
                for D in range(1, 15)]
    first = next(D for D in range(1, 15) if not _slice_fits(F, 32, D))
    assert first == 8                     # the D=7 slice is 114,688 bytes
    assert variants == ["staged"] * (first - 1) \
        + ["unstaged"] * (15 - first)


def test_serving_groups_stage_and_fill_the_card():
    """At the 100,000-row batch every serving group is staged, double-
    buffered, and puts at least 8 warps on each of the 132 SMs."""
    for T, L, D in _SERVING_GROUPS:
        p = S.shap_plan(28, T, L, D, 100_000)
        assert p.variant == "staged" and p.stages == 2
        assert p.blocks >= 132
        assert p.blocks_per_sm * p.threads >= 256


def test_phi_leaves_the_chip_only_past_what_32_rows_take():
    assert S.shap_plan(3000, 14, 32, 5, 100_000).variant == "global_phi"
    assert S.shap_plan(300, 14, 32, 5, 100_000).variant == "staged"
    # phi and X of 32 rows fit, one tree's slice beside them does not
    assert S.shap_plan(850, 14, 32, 5, 100_000).variant == "unstaged"


@pytest.mark.parametrize("args", [(28, 1, 32, 0, 10), (28, 1, 32, 15, 10),
                                  (0, 1, 32, 5, 10), (28, 0, 32, 5, 10),
                                  (28, 1, 0, 5, 10), (28, 1, 32, 5, -1)])
def test_plan_raises_on_what_no_variant_takes(args):
    with pytest.raises(ValueError):
        S.shap_plan(*args)


def test_slot_records_pack_the_tables_bits():
    blob = random_tree_artifact(61, n_features=6, ntrees=6, max_depth=4,
                                enum_features=(2,))
    m = load_artifact(blob, device="cpu")
    groups, _ = m._contrib_prepare()
    assert any(bool((g.feat < 0).any()) for g in groups)
    for g, rec in zip(groups, m._shap_slots):
        assert rec.dtype == torch.int32 and rec.is_contiguous()
        assert rec.shape == g.feat.shape + (4,)
        pad = g.feat < 0
        assert torch.equal(rec[..., 0], torch.where(pad, 0, 4 * g.feat))
        assert torch.equal(rec[..., 1], g.lo.view(torch.int32))
        assert torch.equal(rec[..., 2], g.hi.view(torch.int32))
        assert torch.equal(rec[..., 3], torch.where(
            pad, -1, 4 * g.feat + g.na_ok.to(torch.int32)))
        assert bool(g.na_ok[pad].all())     # -1 keeps na_ok's bit


def test_slot_records_refuse_a_feature_twice_in_a_leaf():
    blob = random_tree_artifact(64, n_features=6, ntrees=2, max_depth=3)
    m = load_artifact(blob, device="cpu")
    g = m._contrib_prepare()[0][-1]
    feat = g.feat.clone()
    feat[0, 0, 1] = feat[0, 0, 0] = 2
    with pytest.raises(ValueError):
        S.pack_slots(g._replace(feat=feat))


_TABLED = [(22, 3, True), (32, 4, True), (32, 5, True)]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_dispatch_rule_is_a_function_of_device_groups_and_cap(device):
    rule = base.contrib_dispatch
    whole = base._CONTRIB_OUT_BYTES // (base._CONTRIB_OUT_COPIES * 4 * 29)
    if device == "cuda":
        assert rule(device, _TABLED, None, 28) == (whole, False)
        assert whole >= 100_000            # a REST request's row cap
        assert rule(device, _TABLED, 128, 28) == (128, False)
        assert rule(device, _TABLED, 1000, 28) == (512, False)
        assert rule(device, _TABLED, 10, 28) == (128, False)
    else:
        assert rule(device, _TABLED, None, 28) == (16384, True)
        assert rule(device, _TABLED, 128, 28) == (128, True)
        assert rule(device, _TABLED, 1000, 28) == (512, True)
    # a group on the DP path (no pattern table) takes the JAX rule on
    # either device: 16384 shrunk until rows x L x D <= 2^24
    dp = _TABLED + [(32, 64, False)]
    assert rule(device, dp, None, 28) == (8192, True)
    assert rule(device, dp, 256, 28) == (256, True)
    assert rule(device, [(32, 5, False)], None, 28) == (16384, True)


def test_whole_batch_equals_128_row_chunks_on_cpu(monkeypatch):
    """The CUDA dispatch (one call per group over the whole, unpadded
    batch) and the JAX rule at H2O_TPU_CONTRIB_CHUNK=128 (8 padded
    chunks at 1,000 rows) give the same bits; the wrapper is called once
    per group and chunk."""
    blob = random_tree_artifact(62, n_features=9, ntrees=6, max_depth=5,
                                enum_features=(3,))
    X = random_rows(63, 1000, 9, nan_frac=0.03, enum_features=(3,))
    m = load_artifact(blob, device="cpu")
    calls = []
    kernel = S.flat_shap_tab_kernel

    def counted(g, ct, Xc, em, slots=None):
        calls.append(Xc.shape[0])
        return kernel(g, ct, Xc, em, slots=slots)

    monkeypatch.setattr(S, "flat_shap_tab_kernel", counted)
    monkeypatch.setenv("H2O_TPU_CONTRIB_CHUNK", "128")
    chunked = m.contrib_numpy(X)
    n_groups = len(m._contrib_prepare()[0])
    assert n_groups > 1 and calls == [128] * 8 * n_groups
    calls.clear()
    monkeypatch.setattr(base, "contrib_dispatch",
                        lambda *a: (1 << 20, False))
    whole = m.contrib_numpy(X)
    assert calls == [1000] * n_groups
    assert whole.shape == (1000, 10) and whole.dtype == np.float32
    np.testing.assert_array_equal(whole, chunked)
