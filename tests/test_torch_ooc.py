"""PyTorch port, out-of-core (chunk-streamed) boosting against the JAX
package on the CPU, its reference on a one-row-shard mesh.

Held here:
- ``chunk_rows_for`` equal to the reference's, and the host chunks
  bitwise the reference's ``bin_frame_host_chunks`` (transposed: the
  port's chunks are feature-major [F, chunk_rows]);
- streamed chunks (copied through the staging buffers) train bitwise
  as resident ones (``H2O_TPU_OOC_RESIDENT=1``);
- the chunked train bitwise the in-memory one on exact sums (one
  gaussian round on a ±0.5 response), and on general data (3 bernoulli
  rounds) equal in structure up to float64 near-ties with leaves within
  1e-5; the chunked train against the JAX package's chunked train at
  the same forced chunk rows, bitwise on the exact round;
- EFB + out-of-core bitwise to bundled in-memory training, and GOSS +
  out-of-core selecting the rows in-memory GOSS selects (its trees
  bitwise on the exact round);
- the gate: multinomial, DRF, huber, checkpoints, score_every and
  row/column sampling and mtries stay in device memory, as at the JAX
  package's ``tests/test_chunked_path.py:286``.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models.tree import ooc as jooc
from h2o_kubernetes_tpu.models.tree.binning import (
    bin_frame_host_chunks as jchunks, fit_bins as jfit_bins)
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import GBM, Frame
from h2o_kubernetes_tpu_torch.models import gbm as tgbm
from h2o_kubernetes_tpu_torch.models.base import resolve_xy
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.models.tree import ooc as tooc
from h2o_kubernetes_tpu_torch.models.tree.binning import (
    bin_frame_host_chunks, fit_bins)
from tools.torch_tree_parity import round_stats, walk

TOL = 1e-5
_KNOBS = ("H2O_TPU_OOC", "H2O_TPU_OOC_CHUNK_ROWS", "H2O_TPU_OOC_RESIDENT",
          "H2O_TPU_EFB", "H2O_TPU_GOSS", "H2O_TPU_GOSS_TOP_A",
          "H2O_TPU_GOSS_RAND_B")


@contextlib.contextmanager
def env(**kv):
    """The out-of-core, EFB and GOSS knobs unset, then ``kv`` set."""
    old = {k: os.environ.get(k) for k in set(_KNOBS) | set(kv)}
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


def exact_cols(n=4096, seed=11, F=5):
    """y in {0, 1}, exactly half ones: one gaussian round's sums are
    exact."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[::31, 1] = np.nan
    y = np.zeros(n, dtype=np.float32)
    y[rng.permutation(n)[: n // 2]] = 1.0
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["y"] = y
    return cols


def bern_cols(n=3000, seed=1, F=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = np.where(X[:, 0] - 0.7 * X[:, 2]
                 + rng.normal(scale=0.4, size=n) > 0, "y", "n")
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["y"] = y
    return cols


def wide_cols(n=2048, seed=0):
    """One-hot groups plus a dense column, y in {0, 1} exactly half."""
    rng = np.random.default_rng(seed)
    cols = {}
    for g in range(4):
        cat = rng.integers(0, 8, size=n)
        for k in range(8):
            cols[f"g{g}_{k}"] = (cat == k).astype(np.float32)
    cols["d0"] = rng.normal(size=n).astype(np.float32)
    y = np.zeros(n, dtype=np.float32)
    y[rng.permutation(n)[: n // 2]] = 1.0
    cols["y"] = y
    return cols


_EXACT = dict(ntrees=1, max_depth=3, distribution="gaussian", seed=3,
              min_rows=4.0)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.trees, b.trees))


def _same_splits(a, b):
    """Bitwise equal trees, with split_feat/split_bin/na_left compared
    where a node splits (elsewhere the bundled argmax leaves another
    unused bin)."""
    isp = a.trees.is_split
    return torch.equal(isp, b.trees.is_split) and all(
        torch.equal(getattr(a.trees, f)[isp], getattr(b.trees, f)[isp])
        for f in ("split_feat", "split_bin", "na_left")) and all(
        torch.equal(getattr(a.trees, f), getattr(b.trees, f))
        for f in ("value", "gain", "cover"))


def _train(cols, kw, **knobs):
    with env(**knobs):
        m = GBM(**kw).train(y="y", training_frame=Frame.from_arrays(
            cols, device="cpu"))
    return m


@pytest.mark.parametrize("rows, F, budget, hist, forced", [
    (10_000_000, 28, 2 ** 30, 5 * 32 * 28 * 256 * 12, None),
    (1_000_000, 1005, 2 ** 30, 49_000_000, None),
    (4096, 5, 2 ** 30, 1000, "1024"), (3000, 6, 2 ** 20, 10 ** 6, None)])
def test_chunk_rows_for_matches_reference(rows, F, budget, hist, forced):
    with use_mesh(make_mesh(n_rows=1)) as _, env(
            **({} if forced is None else
               {"H2O_TPU_OOC_CHUNK_ROWS": forced})):
        want = jooc.chunk_rows_for(rows, F, budget, hist)
        got = tooc.chunk_rows_for(rows, F, budget, hist)
    assert got == want


def test_host_chunks_bitwise_reference():
    cols = exact_cols(n=2500)
    names = [c for c in cols if c != "y"]
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.Frame.from_arrays(cols)
        want = jchunks(jf, jfit_bins(jf, names), 1024)
    tf = Frame.from_arrays(cols, device="cpu")
    got = bin_frame_host_chunks(tf, fit_bins(tf, names), 1024)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (len(names), 1024) and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w.T)


def test_streamed_equals_resident():
    cols = bern_cols()
    kw = dict(ntrees=3, max_depth=3, seed=7)
    m_s = _train(cols, kw, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=512)
    m_r = _train(cols, kw, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=512,
                 H2O_TPU_OOC_RESIDENT=1)
    assert _same(m_s, m_r)
    st = m_s.ooc_stats
    assert st["streamed"] and st["chunks"] == 6 and st["passes"] == 3 * 4
    assert st["upload_bytes"] == 12 * 6 * 6 * 512
    assert not m_r.ooc_stats["streamed"]


def test_exact_round_bitwise_in_memory_and_reference():
    cols = exact_cols()
    m_hbm = _train(cols, _EXACT, H2O_TPU_OOC=0)
    m_ooc = _train(cols, _EXACT, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=1024)
    assert m_hbm.ooc_stats is None and m_ooc.ooc_stats["chunks"] == 4
    assert _same(m_hbm, m_ooc)
    assert m_hbm.scoring_history[-1]["train_rmse"] == \
        m_ooc.scoring_history[-1]["train_rmse"]
    # the reference at depth 2: each level is its own compiled program
    kw = dict(_EXACT, max_depth=2)
    with use_mesh(make_mesh(n_rows=1)), env(H2O_TPU_OOC=1,
                                            H2O_TPU_OOC_CHUNK_ROWS=1024):
        jm = JGBM(**kw).train(y="y",
                              training_frame=h2o.Frame.from_arrays(cols))
    m2 = _train(cols, kw, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=1024)
    for f in ("split_feat", "split_bin", "na_left", "is_split", "value",
              "gain", "cover"):
        np.testing.assert_array_equal(getattr(m2.trees, f).numpy(),
                                      np.asarray(getattr(jm.trees, f)),
                                      err_msg=f)


def test_general_data_near_ties_vs_in_memory():
    cols = bern_cols()
    kw = dict(ntrees=3, max_depth=4, seed=2)
    m_hbm = _train(cols, kw, H2O_TPU_OOC=0)
    m_ooc = _train(cols, kw, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=1024)
    tf = Frame.from_arrays(cols, device="cpu")
    stats, binned = round_stats(m_ooc, tf, "y", {})
    compared, ties, gaps = walk(m_ooc, m_hbm, stats, binned)
    assert compared >= 20 and len(ties) <= 2, (compared, ties)
    assert gaps.max() <= TOL, gaps.max()
    a = m_ooc.scoring_history[-1]["train_auc"]
    assert abs(a - m_hbm.scoring_history[-1]["train_auc"]) <= 1e-4


def test_efb_ooc_bitwise_bundled_in_memory():
    cols = wide_cols()
    kw = dict(_EXACT, max_depth=4)
    m_hbm = _train(cols, kw, H2O_TPU_EFB=1, H2O_TPU_OOC=0)
    m_ooc = _train(cols, kw, H2O_TPU_EFB=1, H2O_TPU_OOC=1,
                   H2O_TPU_OOC_CHUNK_ROWS=512)
    m_ref = _train(cols, kw, H2O_TPU_EFB=0, H2O_TPU_OOC=0)
    assert m_ooc.ooc_stats["chunks"] == 4
    assert _same(m_ooc, m_hbm) and _same_splits(m_ooc, m_ref)


def test_goss_ooc_selects_in_memory_rows(monkeypatch):
    """The chunk grid's row ids are the global ones, so the amplified
    weights the chunks compact are the in-memory path's, row for row,
    and the trees are bitwise on the exact round (dyadic
    amplification)."""
    cols = exact_cols(seed=13)
    goss = dict(H2O_TPU_GOSS=1, H2O_TPU_GOSS_TOP_A="0.5",
                H2O_TPU_GOSS_RAND_B="0.25")
    seen = {"hbm": [], "ooc": []}

    def spy(mod, key):
        real = mod.goss_compact

        def compact(binned, g, h, w_amp, cap):
            seen[key].append(w_amp.clone())
            return real(binned, g, h, w_amp, cap)
        monkeypatch.setattr(mod, "goss_compact", compact)

    spy(tooc, "ooc")
    spy(tcore, "hbm")
    m_hbm = _train(cols, _EXACT, H2O_TPU_OOC=0, **goss)
    m_ooc = _train(cols, _EXACT, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=1024,
                   **goss)
    assert _same(m_hbm, m_ooc)
    (want,), got = seen["hbm"], torch.cat(seen["ooc"])
    assert len(seen["ooc"]) == 4
    assert torch.equal(got[: want.shape[0]], want)
    assert 0.6 < float((want > 0).float().mean()) < 0.9


@pytest.mark.parametrize("case", ["multinomial", "drf", "huber",
                                  "checkpoint", "score_every",
                                  "sample_rate", "col_sample", "mtries"])
def test_gate_keeps_in_memory(case):
    """Each ineligible configuration gets no chunk rows under
    ``H2O_TPU_OOC=1``, and an eligible one does."""
    cols = exact_cols(n=1024)
    tf = Frame.from_arrays(cols, device="cpu")
    dist = {"multinomial": "multinomial", "huber": "huber"}.get(case,
                                                                "gaussian")
    data = resolve_xy(tf, "y", None, None, None, "gaussian", None)
    data.distribution = dist
    p = tgbm.GBMParams(
        _drf_mode=case == "drf", score_every=2 * (case == "score_every"),
        sample_rate=0.8 if case == "sample_rate" else 1.0,
        col_sample_rate_per_tree=0.6 if case == "col_sample" else 1.0,
        mtries=2 if case == "mtries" else -1)
    K = 3 if case == "multinomial" else 1
    ckpt = object() if case == "checkpoint" else None
    with env(H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=256):
        assert tgbm._ooc_chunk_rows(p, data, K, 5, 1000, 2 ** 30,
                                    ckpt) is None
        data.distribution = "gaussian"
        assert tgbm._ooc_chunk_rows(tgbm.GBMParams(), data, 1, 5, 1000,
                                    2 ** 30, None) == 256


def test_sampled_train_ignores_chunk_knob():
    """Row sampling stays in device memory under ``H2O_TPU_OOC=1``, so
    the chunk-size knob cannot change a sampled model."""
    cols = exact_cols(n=1024, seed=12)
    kw = dict(ntrees=3, max_depth=2, distribution="gaussian", seed=1,
              sample_rate=0.8)
    m1 = _train(cols, kw, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=256)
    m2 = _train(cols, kw, H2O_TPU_OOC=1, H2O_TPU_OOC_CHUNK_ROWS=128)
    assert m1.ooc_stats is None and _same(m1, m2)
