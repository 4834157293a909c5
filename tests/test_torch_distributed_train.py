"""PyTorch port on a row group of two CPU ranks (gloo, processes of
their own: ``tests/torch_rank_worker.py``) against the JAX package on a
two-row-shard mesh (``use_mesh(make_mesh(n_rows=2))``, its Frame built
inside it), with the same seeded numpy inputs. The group is spawned
once for the module and trains everything while the references train
here. Held:
- the two ranks' results BITWISE equal (trees, metrics, coefficients,
  averaged weights);
- the bin edges bitwise (3,001 rows: the ranks gather their columns);
- the rank-folded row draws (``_round_sampling``) bitwise per shard;
- binomial GBM with ``sample_rate=0.7``, gaussian and multinomial GBM:
  splits equal or a float64 near-tie (``tools/torch_tree_parity.walk``
  at each round's float64 gradients over the padded two-shard layout),
  leaves within 1e-5 of the tree's largest |leaf|, the train metrics
  within 1e-4;
- DRF with ``mtries`` (bootstrap folded per rank): structure and leaves
  bitwise (its 0/1 sums are exact);
- huber's gradient, and so its δ (the mean over ranks of each rank's
  quantile, the reference's ``pmean``), bitwise;
- binomial GLM IRLSM coefficients within 1e-4 (the reference given the
  port's float64 column statistics, ``tests/torch_f64_rollups.py``);
- DeepLearning: the init bitwise, and every layer within 1e-5 of its
  largest |w| after one averaged iteration (the JAX package's shards
  step on the gradient summed over the shards: shard_map's transpose
  of its replicated network; the port all-reduces each step's
  gradient to match);
- and the port at world size 2 against world size 1 on a dyadic
  fixture without row sampling (one GBM tree, a three-tree forest):
  trees and predictions bitwise, metrics within 1e-12.
"""

import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models import GLM as JGLM
from h2o_kubernetes_tpu.models import deeplearning as JDLM
from h2o_kubernetes_tpu.models.base import resolve_xy as jresolve
from h2o_kubernetes_tpu.models.drf import DRF as JDRF
from h2o_kubernetes_tpu.models.tree import core as jcore
from h2o_kubernetes_tpu.models.tree.binning import bin_frame as jbin_frame
from h2o_kubernetes_tpu.runtime.mesh import ROWS, make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import DRF, GBM, Frame
from h2o_kubernetes_tpu_torch.models.gbm import _round_keys
from h2o_kubernetes_tpu_torch.models.tree import core as tcore
from h2o_kubernetes_tpu_torch.runtime import mesh as tmesh
from h2o_kubernetes_tpu_torch.runtime import prng
from torch_f64_rollups import f64_rollups
from torch_rank_worker import (DL_KW, DRF_KW, DYADIC_DRF_KW, DYADIC_KW,
                               GBM_CASES,
                               GBM_RESP, collect, dl_cols, dyadic_cols,
                               gbm_cols, glm_cols, huber_inputs, spawn)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from torch_tree_parity import walk  # noqa: E402

_MESH2 = make_mesh(n_rows=2)
_LEAF_REL = 1e-5
_METRIC_ABS = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_ranks"))
    return spawn(2, "train", out), out


@pytest.fixture(scope="module")
def refs(ranks):
    """The JAX references, trained while the ranks train."""
    cols = gbm_cols()
    out = {}
    with use_mesh(_MESH2):
        jf = h2o.Frame.from_arrays(cols)
        for name, (y, kw) in GBM_CASES.items():
            ign = [r for r in GBM_RESP if r != y]
            jm = JGBM(**kw).train(y=y, training_frame=jf,
                                  ignored_columns=ign)
            data = jresolve(jf, y, None, ign, None, jm.distribution)
            out[name] = {
                "model": jm,
                "binned": np.asarray(jbin_frame(jf, jm.bin_spec)).T,
                "y": np.asarray(data.y, dtype=np.float64),
                "w": np.asarray(data.w, dtype=np.float32)}
        out["drf"] = JDRF(**DRF_KW).train(y="yb", training_frame=jf,
                                          ignored_columns=["yr", "y3"])
        m, y, w = (np.concatenate([a, np.zeros(1, np.float32)])
                   for a in huber_inputs())          # padded to 2 shards
        bp = jcore.BoostParams(distribution="huber", huber_alpha=0.9)
        fn = jax.shard_map(lambda a, b, c: jcore._boost_grad_hess(
            bp, a, b, c)[0], mesh=_MESH2, in_specs=P(ROWS),
            out_specs=P(ROWS))
        out["huber_g"] = np.asarray(jax.jit(fn)(m, y, w))
        with f64_rollups():
            out["glm"] = JGLM(family="binomial").train(
                y="yb", training_frame=h2o.Frame.from_arrays(glm_cols()))
            out["dl"] = JDLM.DeepLearning(**DL_KW).train(
                y="y", training_frame=h2o.Frame.from_arrays(dl_cols()))
    return out


@pytest.fixture(scope="module")
def port2(ranks, refs):
    rcs, outs, res = collect(*ranks)
    assert rcs == [0, 0], "\n".join(o[-4000:] for o in outs)
    return res


def _same(a, b, path=""):
    """Assert two pickled results equal bit for bit (NaN = NaN)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), path
    elif a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def test_ranks_agree_bitwise(port2):
    r0, r1 = (dict(r) for r in port2)
    for r in (r0, r1):
        r.pop("huber")                  # each rank's own rows
        r.pop("status")
    _same(r0, r1)
    st = port2[0]["status"]
    assert st["cloud_size"] == st["process_count"] == 2
    assert st["devices"] == ["rank 0: cpu", "rank 1: cpu"]


def test_bin_edges_bitwise(port2, refs):
    for name in GBM_CASES:
        want = np.asarray(refs[name]["model"].bin_spec.edges_matrix())
        np.testing.assert_array_equal(port2[0][name]["edges"], want)


def test_rank_folded_draws_bitwise():
    """Each rank's keep mask and the shared column mask equal the JAX
    package's ``_round_sampling`` on that row shard of a two-shard
    mesh, for three rounds' keys."""
    rows, F, half = 1002, 6, 501
    w = np.ones(rows, np.float32)
    w[-1] = 0.0                                     # a padding row
    jbp = jcore.BoostParams(sample_rate=0.6, col_sample_rate_per_tree=0.7)
    tbp = tcore.BoostParams(sample_rate=0.6, col_sample_rate_per_tree=0.7)
    jfn = jax.jit(jax.shard_map(
        lambda w, kr, kc: jcore._round_sampling(jbp, w, F, kr, kc),
        mesh=_MESH2, in_specs=(P(ROWS), P(), P()),
        out_specs=(P(ROWS), P())))
    jkeys = jax.random.split(jax.random.key(11), 3)
    tkeys = prng.split(prng.key(11), 3)
    for t in range(3):
        jr, jc, _ = jax.random.split(jkeys[t], 3)
        wj, cj = (np.asarray(a) for a in jfn(w, jr, jc))
        tr, tc, _ = prng.split(tkeys[t], 3)
        for r in range(2):
            with tmesh.use_mesh(tmesh.RowGroup(rank=r, world_size=2)):
                wt, ct = tcore._round_sampling(
                    tbp, torch.as_tensor(w[r * half: (r + 1) * half]), F,
                    tr[None], tc[None])
            np.testing.assert_array_equal(wt[0].numpy(),
                                          wj[r * half: (r + 1) * half])
            np.testing.assert_array_equal(ct[0].numpy(), cj)
        assert 0 < wj[:half].sum() < half
        assert not np.array_equal(wj[:half], wj[half:])


def _trees_ns(arrs: dict, nbins: int):
    return SimpleNamespace(params=SimpleNamespace(nbins=nbins),
                           trees=SimpleNamespace(**arrs))


def _round_stats2(name, res, ref):
    """Per tree of the port's two-rank model: float64 (g·w, h·w) over
    the padded two-shard layout at the margin its own earlier trees
    give, under the round's weights after each rank's row draw."""
    y_col, kw = GBM_CASES[name]
    jm = ref["model"]
    binned = ref["binned"]                            # [F, padded]
    F, n = binned.shape
    y, w = ref["y"], ref["w"]
    trees = res["trees"]
    T = trees["value"].shape[0]
    K = 3 if name == "multinomial" else 1
    init = np.asarray(res["init"], dtype=np.float64).reshape(-1)
    bt = torch.as_tensor(binned.copy())
    steps = [tcore.predict_tree(tcore.Tree(*(torch.as_tensor(trees[f][t])
                                             for f in tcore.Tree._fields)),
                                bt, kw["max_depth"], jm.params.nbins
                                ).double().numpy() for t in range(T)]
    bp = tcore.BoostParams(sample_rate=kw.get("sample_rate", 1.0))
    keys = None
    if bp.sample_rate < 1.0:
        p = SimpleNamespace(seed=kw["seed"], ntrees=kw["ntrees"],
                            max_depth=kw["max_depth"],
                            nbins=jm.params.nbins, score_every=0,
                            _drf_mode=False)
        keys = _round_keys(p, n, F, K, "cpu")
    stats = []
    margin = np.repeat(init[None, :], n, axis=0)
    for r in range(T // K):
        wt = w.astype(np.float64)
        if keys is not None:
            kr, kc, _ = tcore._round_subkeys(keys[r: r + 1], 1)
            parts = []
            for rk in range(2):
                with tmesh.use_mesh(tmesh.RowGroup(rank=rk, world_size=2)):
                    parts.append(tcore._round_sampling(
                        bp, torch.as_tensor(w[rk * n // 2:
                                              (rk + 1) * n // 2]),
                        F, kr[0], kc[0])[0][0].double().numpy())
            wt = np.concatenate(parts)
        if name == "multinomial":
            e = np.exp(margin - margin.max(axis=1, keepdims=True))
            pr = e / e.sum(axis=1, keepdims=True)
            for k in range(K):
                yk = (y == k).astype(np.float64)
                stats.append(((pr[:, k] - yk) * wt,
                              pr[:, k] * (1 - pr[:, k]) * wt))
        elif name == "gaussian":
            stats.append(((margin[:, 0] - y) * wt, wt.copy()))
        else:
            pr = 1.0 / (1.0 + np.exp(-margin[:, 0]))
            stats.append(((pr - y) * wt, pr * (1 - pr) * wt))
        for k in range(K):
            margin[:, k] += steps[r * K + k]
    return stats, binned


@pytest.mark.parametrize("name", list(GBM_CASES))
def test_gbm_matches_two_shard_reference(port2, refs, name):
    res, ref = port2[0][name], refs[name]
    jm = ref["model"]
    stats, binned = _round_stats2(name, res, ref)
    compared, ties, gaps = walk(_trees_ns(res["trees"], jm.params.nbins),
                                jm, stats, binned)
    assert compared > 0 and len(ties) <= 1, ties
    assert gaps.max() <= _LEAF_REL, gaps.max()
    np.testing.assert_allclose(res["init"], np.asarray(jm.init_score)
                               .reshape(res["init"].shape), rtol=0,
                               atol=1e-6)
    th, jh = res["history"][-1], jm.scoring_history[-1]
    assert th["ntrees"] == jh["ntrees"]
    for k in th:
        if k != "ntrees":
            assert abs(th[k] - jh[k]) <= _METRIC_ABS, (k, th[k], jh[k])
    if "confusion" in res:                 # counted once over the ranks
        assert res["confusion"].sum() == gbm_cols()["yb"].shape[0]
    perf = jm.model_performance(h2o.Frame.from_arrays(gbm_cols()),
                                GBM_CASES[name][0]) \
        if name != "multinomial" else None
    if perf is not None:
        for k in ("auc", "logloss", "rmse", "r2"):
            if k in perf and k in res["perf"]:
                assert abs(res["perf"][k] - perf[k]) <= _METRIC_ABS, k


def test_drf_mtries_bitwise(port2, refs):
    res, jm = port2[0]["drf"], refs["drf"]
    assert res["mtries"] == jm.params.mtries == 2
    for f in ("split_feat", "split_bin", "na_left", "is_split", "value"):
        np.testing.assert_array_equal(res["trees"][f],
                                      np.asarray(getattr(jm.trees, f)),
                                      err_msg=f)
    th, jh = res["history"][-1], jm.scoring_history[-1]
    for k in ("train_auc", "train_logloss"):
        assert abs(th[k] - jh[k]) <= _METRIC_ABS, k


def test_huber_delta_is_the_mean_of_the_ranks_quantiles(port2, refs):
    g = np.concatenate([port2[r]["huber"]["g"] for r in range(2)])
    np.testing.assert_array_equal(g, refs["huber_g"])
    m, y, w = huber_inputs()
    r = np.abs(np.concatenate([y - m, [0.0]]).astype(np.float32))
    wp = np.concatenate([w, [0.0]])
    qs = [np.nanquantile(np.where(wp[s] > 0, r[s], np.nan), 0.9)
          for s in (slice(0, 501), slice(501, 1002))]
    for rk in range(2):
        assert abs(port2[rk]["huber"]["delta"] - np.mean(qs)) <= \
            1e-6 * np.mean(qs)


def test_glm_irlsm_coefficients(port2, refs):
    got, want = port2[0]["glm"]["coef"], refs["glm"].coef()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_deeplearning_averaged_iteration(port2, refs):
    res, jm = port2[0]["dl"], refs["dl"]
    sizes = (res["init"][0]["w"].shape[0],) + DL_KW["hidden"] + (2,)
    jinit = JDLM._init_params(jax.random.split(
        jax.random.key(DL_KW["seed"]))[1], sizes)
    for got, want in zip(res["init"], jinit):
        np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))
    assert len(res["net"]) == len(jm.net)
    for got, want in zip(res["net"], jm.net):
        for k in ("w", "b"):
            a, b = got[k], np.asarray(want[k])
            scale = np.abs(b).max()
            assert np.abs(a - b).max() <= 1e-5 * scale, k
        # the iteration moved the weights
    assert np.abs(res["net"][0]["w"] - res["init"][0]["w"]).max() > 1e-4


@pytest.mark.parametrize("name", ["dyadic_gbm", "dyadic_drf"])
def test_world2_equals_world1_on_dyadic_rows(port2, name):
    """One gaussian GBM tree and a 3-tree forest without row sampling:
    the trees, the init and the predictions bitwise; the train metrics
    (float64 sums over the ranks) within 1e-12."""
    est, kw = (GBM, DYADIC_KW) if name == "dyadic_gbm" else \
        (DRF, DYADIC_DRF_KW)
    fr = Frame.from_arrays(dyadic_cols(), device="cpu")
    m = est(**kw).train(y="y", training_frame=fr)
    got = port2[0][name]
    for f in tcore.Tree._fields:
        np.testing.assert_array_equal(got["trees"][f],
                                      getattr(m.trees, f).numpy(),
                                      err_msg=f)
    assert got["trees"]["is_split"].sum() >= 7
    np.testing.assert_array_equal(got["init"], np.asarray(m.init_score))
    th, wh = got["history"][-1], m.scoring_history[-1]
    assert set(th) == set(wh)
    for k in th:
        assert abs(th[k] - wh[k]) <= 1e-12 * max(1.0, abs(wh[k])), k
    pred = m.predict_raw(fr)
    np.testing.assert_array_equal(got["pred"], pred)
    np.testing.assert_array_equal(got["pred_frame"], pred)
