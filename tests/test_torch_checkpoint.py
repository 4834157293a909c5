"""PyTorch port, checkpoint continuation (``GBM(ntrees=N,
checkpoint=model)``, N the total): bernoulli, gaussian, laplace and
multinomial GBM and a binomial DRF, on the CPU, on one seeded table.

The JAX package trains a 1-round checkpoint and continues it to 2 on a
one-row-shard mesh; the same checkpoint, carried across as numpy arrays
(``gbm_model_from_arrays``), seeds the port's continuation, so the two
continuations start from the same trees, bins and init. Held here:
- the continued model's first trees are the checkpoint's, bitwise, and
  its init, bins and laplace ``margin_scale`` are the checkpoint's;
- the new trees' split structure equals the JAX package's up to float64
  near-ties (``tools/torch_tree_parity.walk``; for multinomial
  ``test_torch_multinomial._walk``), leaves within 1e-5; the forest's
  structure and leaves bitwise (the JAX key schedule walked from the
  checkpoint's round);
- a port checkpoint continues in the port;
- a checkpoint of another feature set, distribution or response, and a
  total that does not exceed the checkpoint's, raise ValueError in both
  packages.
"""

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.models.drf import DRF as JDRF
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import DRF, GBM, Frame
from test_torch_distributions import carry, dist_cols
from tools.torch_tree_parity import round_stats, walk
from test_torch_multinomial import _walk

TOL = 1e-5
_RESP = ("y", "ycnt", "ypos", "yheavy", "w", "off", "ybin", "ybin2", "y4")


def ckpt_cols(rows=4096):
    """``dist_cols``'s table with two binary responses (other labels)
    and a 4-class one: every case bins the same 10 features."""
    cols = dist_cols(rows, seed=3)
    lin = cols["y"]
    cols["ybin"] = np.where(lin > 0.3, "late", "ontime")
    cols["ybin2"] = np.where(lin > 0.3, "p", "q")
    cols["y4"] = np.array(list("abcd"))[np.digitize(lin, [-0.3, 0.3, 0.9])]
    return cols


def _case(name):
    """(response, train kwargs, estimator kwargs, JAX and port
    estimator classes) of a continuation case."""
    kw, est = {}, dict(max_depth=2, learn_rate=0.2, seed=1)
    J, T = JGBM, GBM
    y = {"bernoulli": "ybin", "gaussian": "y", "laplace": "yheavy",
         "multinomial": "y4", "drf": "ybin"}[name]
    if name == "laplace":
        kw["weights_column"] = "w"
        est["distribution"] = "laplace"
    if name == "drf":
        J, T = JDRF, DRF
        est = dict(max_depth=2, seed=3, nbins=256)
    kw["ignored_columns"] = [c for c in _RESP
                             if c != y and c not in kw.values()]
    return y, kw, est, J, T


def _mn_grads(tm, tf, y, K=4):
    """float64 softmax (g, h) [K, rows] of each round of a multinomial
    model, at the margins of its own earlier rounds, and the codes."""
    from h2o_kubernetes_tpu_torch.models.base import resolve_xy
    from h2o_kubernetes_tpu_torch.models.tree import core as tcore

    binned = tf.binned(tm.bin_spec)
    yv = resolve_xy(tf, y).y.numpy()
    margin = torch.as_tensor(tm.init_score)[None, :].repeat(
        binned.shape[1], 1).double()
    out = []
    for r in range(tm.trees.value.shape[0] // K):
        pr = torch.softmax(margin, dim=1).numpy().T
        yk = (yv[None, :] == np.arange(K)[:, None]).astype(np.float64)
        out.append((pr - yk, pr * (1.0 - pr)))
        for k in range(K):
            tree = tcore.Tree(*(a[r * K + k] for a in tm.trees))
            margin[:, k] += tcore.predict_tree(
                tree, binned, tm.params.max_depth, 256).double()
    return out, binned.numpy()


CASES = ("bernoulli", "gaussian", "laplace", "multinomial", "drf")


@pytest.fixture(scope="module")
def continued():
    out = {}
    cols = ckpt_cols()
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.Frame.from_arrays(cols)
        tf = Frame.from_arrays(cols, device="cpu")
        out["frames"] = (jf, tf)
        for name in CASES:
            y, kw, ekw, J, T = _case(name)
            jck = J(ntrees=1, **ekw).train(y=y, training_frame=jf, **kw)
            jcont = J(ntrees=2, checkpoint=jck, **ekw).train(
                y=y, training_frame=jf, **kw)
            pck = carry(jck)
            pcont = T(ntrees=2, checkpoint=pck, **ekw).train(
                y=y, training_frame=tf, **kw)
            out[name] = (jck, jcont, pck, pcont, tf, y, kw)
    return out


@pytest.mark.parametrize("name", CASES)
def test_checkpoint_trees_kept_bitwise(continued, name):
    jck, jcont, pck, pcont, _, _, _ = continued[name]
    n_old = pck.trees.value.shape[0]
    assert pcont.trees.value.shape[0] == jcont.trees.value.shape[0] \
        == n_old * 2
    for a, b in zip(pck.trees, pcont.trees):
        assert torch.equal(a, b[:n_old])
    np.testing.assert_array_equal(pcont.init_score, pck.init_score)
    assert torch.equal(pcont.bin_spec.edges, pck.bin_spec.edges)
    assert pcont.margin_scale == pck.margin_scale == \
        float(getattr(jcont, "margin_scale", 1.0))


@pytest.mark.parametrize("name", CASES)
def test_new_trees_match_reference(continued, name):
    jck, jcont, pck, pcont, tf, y, kw = continued[name]
    n_old = pck.trees.value.shape[0]
    if name == "drf":
        for f in ("split_feat", "split_bin", "na_left", "is_split",
                  "value"):
            np.testing.assert_array_equal(
                getattr(pcont.trees, f).numpy(),
                np.asarray(getattr(jcont.trees, f)), err_msg=f)
        return
    if name == "multinomial":
        compared, ties, gaps, _ = _walk(pcont, jcont, *_mn_grads(pcont, tf,
                                                                  y))
        assert len(ties) <= 3 and gaps.max() <= TOL, (ties, gaps.max())
        return
    stats, binned = round_stats(pcont, tf, y, kw, n_old=n_old)
    compared, ties, gaps = walk(pcont, jcont, stats, binned, n_old=n_old)
    assert len(ties) <= 1 and compared >= 5, (ties, compared)
    assert gaps.max() <= TOL, gaps.max()


def test_port_checkpoint_continues_in_port(continued):
    tf = continued["frames"][1]
    y, kw, est, _, _ = _case("bernoulli")
    ck = GBM(ntrees=2, **est).train(y=y, training_frame=tf, **kw)
    cont = GBM(ntrees=4, checkpoint=ck, **est).train(y=y, training_frame=tf,
                                                     **kw)
    for a, b in zip(ck.trees, cont.trees):
        assert torch.equal(a, b[:2])
    assert cont.trees.value.shape[0] == 4
    h0, h1 = ck.scoring_history[-1], cont.scoring_history[-1]
    assert h1["ntrees"] == 4 and h1["train_logloss"] < h0["train_logloss"]


@pytest.mark.parametrize("change", ["features", "distribution", "response",
                                    "ntrees"])
def test_mismatched_checkpoint_raises(continued, change):
    y, kw, est, _, _ = _case("bernoulli")
    ign = kw["ignored_columns"]
    ntrees = 1 if change == "ntrees" else 2
    if change == "features":
        kw = {"ignored_columns": ign + ["x7"]}
    elif change == "distribution":
        est = dict(est, distribution="multinomial")
    elif change == "response":
        y = "ybin2"
        kw = {"ignored_columns": [c for c in _RESP if c != y]}
    jck, _, pck = continued["bernoulli"][:3]
    with use_mesh(make_mesh(n_rows=1)):
        for E, ck, fr in ((JGBM, jck, continued["frames"][0]),
                          (GBM, pck, continued["frames"][1])):
            with pytest.raises(ValueError):
                E(ntrees=ntrees, checkpoint=ck, **est).train(
                    y=y, training_frame=fr, **kw)
