"""PyTorch port, DeepLearning (``models/deeplearning.py``) against the
JAX package's on the CPU.

Reference trains run on a one-row-shard mesh (the JAX Frame built
inside it), so the reference's model average is over one shard, as the
port's. Held here:
- the He-normal init weights BITWISE (the twin's ``normal``), and one
  iteration's minibatch rows and dropout masks BITWISE to the
  reference's draws, through the chunked batch draw;
- one Adam step and one SGD-momentum step from carried weights on the
  same minibatch within 1e-6 of the largest weight (autograd and
  ``torch.optim`` against ``jax.grad`` and optax);
- whole trains (1,024 rows, hidden ≤ (8, 8), ≤ 3 epochs): binomial,
  gaussian with weights and an offset, multinomial, dropout with L1/L2,
  momentum SGD and tanh, an autoencoder, and a checkpoint continued from a
  carried JAX model: every layer's weights within 1e-5 of its largest
  |w| (measured: ≤ 3e-6), predictions within 1e-5 and the scoring
  history's auc/logloss/rmse (or r2/mae) within 1e-5;
- ``anomaly``, ``deepfeatures``, the ``reconstr_*`` frame, the
  scoring-history row, and the reference's errors;
- two trains of one configuration equal bitwise (card vs CPU is held
  on the card by comparing two trains);
- the design statistics: the port's means and standard deviations are
  the numpy float64 two-pass values rounded once (``x2`` is Year-like,
  mean 1997 and sigma 6.3), and every reference train here is given the
  same statistics (``tests/torch_f64_rollups.py``), so its ``DataInfo``
  equals the port's bitwise.
"""

import io

import jax
import numpy as np
import optax
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models import deeplearning as JDLM
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import DeepLearning, Frame
from h2o_kubernetes_tpu_torch.models import deeplearning as DLM
from h2o_kubernetes_tpu_torch.runtime import prng
from torch_f64_rollups import f64_rollups, two_pass

_MESH1 = make_mesh(n_rows=1)
_W_REL = 1e-5            # per-layer weights, relative to the largest |w|
_P_ABS = 1e-5            # predictions
_M_ABS = 1e-5            # metrics
_RESP = ("y", "yr", "ym", "w", "off")

CASES = {
    # name: (response, estimator kwargs, train kwargs)
    "binomial": ("y", dict(hidden=(8, 8), epochs=2, seed=1), {}),
    "gaussian_w_off": ("yr", dict(hidden=(8,), epochs=2, seed=3),
                       {"weights_column": "w", "offset_column": "off"}),
    "multinomial": ("ym", dict(hidden=(8, 8), epochs=2, seed=2), {}),
    # dropout on the input and both hidden layers, L1/L2, momentum SGD
    "dropout_l1l2_sgd": ("y", dict(hidden=(8, 8), epochs=3, seed=4,
                                   input_dropout_ratio=0.1,
                                   hidden_dropout_ratios=(0.2, 0.1),
                                   l1=1e-4, l2=1e-3, adaptive_rate=False,
                                   activation="tanh"), {}),
    "autoencoder": (None, dict(hidden=(4,), epochs=3, seed=6,
                               autoencoder=True), {}),
}


def dl_cols(rows, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    X["x2"] = (1997.0 + 6.3 * X["x2"]).astype(np.float32)   # Year-like
    X["x2"][::37] = np.nan                          # numeric NAs
    c = np.array(list("abc"), dtype=object)[rng.integers(0, 3, rows)]
    c[::53] = None                                  # an NA level
    X["c"] = c
    r2 = X["x0"] ** 2 + X["x1"] ** 2
    X["y"] = np.array(["out", "in"])[(r2 < 1.2).astype(int)]
    X["yr"] = (np.sin(2 * X["x0"]) + 0.3 * X["x1"]
               + rng.normal(scale=0.1, size=rows)).astype(np.float32)
    X["ym"] = np.array(list("pqr"))[(X["x0"] > 0).astype(int)
                                    + (X["x1"] > 0).astype(int)]
    X["w"] = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    X["off"] = (0.2 * rng.normal(size=rows)).astype(np.float32)
    return X


def _tkw(name):
    y, kw, tkw = CASES[name]
    used = {y} | set(tkw.values())
    return y, kw, dict(tkw, ignored_columns=[c for c in _RESP
                                             if c not in used])


def carry(jm, **params):
    """A port model holding a JAX DeepLearning model's weights and
    layout (as numpy)."""
    d = jm.dinfo
    kw = {k: getattr(jm.params, k) for k in (
        "hidden", "activation", "epochs", "autoencoder", "seed")}
    kw.update(params)
    m = DLM.deeplearning_model_from_arrays(
        [{"w": np.asarray(l["w"]), "b": np.asarray(l["b"])}
         for l in jm.net],
        d.coef_names, d.numeric_idx, d.enum_specs, d.means, d.stds,
        jm.feature_names, jm.loss_kind, jm.response_domain,
        jm.feature_domains, jm.nclasses, jm.distribution,
        getattr(jm, "offset_column", None), device="cpu", **kw)
    return m


@pytest.fixture(scope="module")
def trained():
    cols = dl_cols(1024)
    hold = dl_cols(300, seed=9)
    tf = Frame.from_arrays(cols, device="cpu")
    th = Frame.from_arrays(hold, device="cpu")
    out = {}
    with use_mesh(_MESH1), f64_rollups():
        jf, jh = h2o.Frame.from_arrays(cols), h2o.Frame.from_arrays(hold)
        for name in CASES:
            y, kw, tkw = _tkw(name)
            jm = JDLM.DeepLearning(**kw).train(y=y, training_frame=jf,
                                               **tkw)
            tm = DeepLearning(**kw).train(y=y, training_frame=tf, **tkw)
            out[name] = (jm, tm)
        # continue the JAX binomial model 2 -> 3 epochs in both packages
        jb = out["binomial"][0]
        y, kw, tkw = _tkw("binomial")
        jc = JDLM.DeepLearning(**dict(kw, epochs=3, checkpoint=jb)).train(
            y=y, training_frame=jf, **tkw)
        tc = DeepLearning(**dict(kw, epochs=3, checkpoint=carry(jb))).train(
            y=y, training_frame=tf, **tkw)
        out["checkpoint"] = (jc, tc)
        # the reference's predictions from its numpy MojoModel, which
        # compiles nothing
        X = np.asarray(out["binomial"][0]._design_matrix(jh))[: jh.nrows]
        ref = {"X": X}
        for name, (jm, _) in out.items():
            buf = io.BytesIO()
            jmojo.export_mojo(jm, buf)
            data = {n: X[:, j] for j, n in enumerate(jm.feature_names)}
            data["off"] = hold["off"]
            ref[name] = jmojo.MojoModel(io.BytesIO(buf.getvalue())
                                        ).predict(data)
        ae = out["autoencoder"][0]
        ref["anomaly"] = ae.anomaly(jh)
        # the first hidden layer's activations from the reference's
        # weights and its numpy design expansion
        buf = io.BytesIO()
        jmojo.export_mojo(ae, buf)
        Xe = jmojo.MojoModel(io.BytesIO(buf.getvalue()))._expand(X)[:, :-1]
        ref["deepfeatures"] = np.maximum(
            Xe @ np.asarray(ae.net[0]["w"]) + np.asarray(ae.net[0]["b"]), 0)
    return out, tf, th, ref, jf, cols


# -- draws ---------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(5, 8, 8, 2), (28, 64, 64, 2)])
def test_init_weights_bitwise(sizes):
    jk = jax.random.split(jax.random.key(7))[1]
    want = JDLM._init_params(jk, sizes)
    net = DLM._init_net(prng.split(prng.key(7))[1], sizes, "rectifier")
    for lyr, w in zip(net.layers, want):
        np.testing.assert_array_equal(
            lyr.weight.detach().t().numpy().view(np.int32),
            np.asarray(w["w"]).view(np.int32))
        assert not lyr.bias.detach().any()


@pytest.mark.parametrize("chunk", [7, 1000])
def test_iteration_draws_bitwise(chunk):
    """One iteration's minibatch rows and dropout masks, as the
    reference's ``local_round``/``_loss_fn``/``_forward`` draw them
    (fold_in(ki, 0), a key per step, split into kidx/kdrop, randint over
    the rows, split(kdrop, n_layers + 1), bernoulli(1 - ratio))."""
    steps, batch, rows = 23, 32, 1000
    sizes = (6, 8, 5, 2)
    plan = [0.1, 0.2, None]
    jki = jax.random.fold_in(jax.random.key(5), 3)
    keys = jax.random.split(jax.random.fold_in(jki, 0), steps)
    got = [(i, m) for i, m in DLM.iteration_draws(
        prng.fold_in(prng.key(5), 3), steps, batch, rows, sizes[:-1],
        plan, chunk)]
    idx = torch.cat([g[0] for g in got]).numpy()
    masks = [torch.cat([g[1][j] for g in got]).numpy() if r else None
             for j, r in enumerate(plan)]
    for s in range(steps):
        kidx, kdrop = jax.random.split(keys[s])
        np.testing.assert_array_equal(idx[s], np.asarray(
            jax.random.randint(kidx, (batch,), 0, rows)))
        dk = jax.random.split(kdrop, len(sizes))
        for j, r in enumerate(plan):
            if r is None:
                assert masks[j] is None
                continue
            np.testing.assert_array_equal(masks[j][s], np.asarray(
                jax.random.bernoulli(dk[j], 1 - r, (batch, sizes[j]))))


def test_train_key_schedule():
    """The train's first iteration key: key(seed) split for the init,
    then split once per iteration."""
    jkey, jinit = jax.random.split(jax.random.key(9))
    _, jki = jax.random.split(jkey)
    key, kinit = prng.split(prng.key(9))
    _, ki = prng.split(key)
    for a, b in ((jinit, kinit), (jki, ki)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(a)).astype(np.int64), b.numpy())


# -- one step --------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [True, False])
def test_one_step_from_carried_weights(adaptive):
    """One optimizer step on one minibatch from the same weights: optax
    adam(rate) / sgd(rate, momentum) over jax.grad against torch.optim
    over autograd, within 1e-6 of the largest weight (two steps, so
    SGD's momentum buffer and Adam's bias corrections both act)."""
    rng = np.random.default_rng(3)
    sizes = (7, 8, 8, 3)
    net = JDLM._init_params(jax.random.key(1), sizes)
    xb = rng.normal(size=(32, 7)).astype(np.float32)
    yb = rng.integers(0, 3, 32).astype(np.float32)
    wb = rng.uniform(0.5, 2, 32).astype(np.float32)
    p = DLM.DeepLearningParams(adaptive_rate=adaptive, rate=0.01,
                               l2=1e-3)
    opt = optax.adam(p.rate) if adaptive else \
        optax.sgd(p.rate, momentum=p.momentum_start)
    state = opt.init(net)
    tnet = DLM.carry_net([{k: np.asarray(v) for k, v in l.items()}
                          for l in net], "cpu")
    topt = DLM._optimizer(p, tnet)
    @jax.jit
    def step(n, st):
        g = jax.grad(JDLM._loss_fn)(n, xb, yb, wb, jax.nn.relu, "ce", 0.0,
                                    p.l2, None, 0.0, None)
        upd, st = opt.update(g, st, n)
        return optax.apply_updates(n, upd), st

    for _ in range(2):
        net, state = step(net, state)
        loss = DLM._loss(tnet(torch.as_tensor(xb)), torch.as_tensor(yb),
                         torch.as_tensor(wb), "ce", tnet, 0.0, p.l2)
        topt.zero_grad()
        loss.backward()
        topt.step()
    for lyr, w in zip(tnet.layers, net):
        want = np.asarray(w["w"])
        err = np.abs(lyr.weight.detach().t().numpy() - want).max()
        assert err <= 1e-6 * np.abs(want).max()
        np.testing.assert_allclose(lyr.bias.detach().numpy(),
                                   np.asarray(w["b"]), rtol=0, atol=1e-6)


# -- whole trains ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES) + ["checkpoint"])
def test_train_matches_reference(trained, name):
    (jm, tm), th, ref = trained[0][name], trained[2], trained[3]
    assert tm.loss_kind == jm.loss_kind and tm.algo == "deeplearning"
    assert tm.dinfo.coef_names == jm.dinfo.coef_names
    # the port's statistics are the float64 two-pass ones rounded once,
    # and the reference was given the same (``f64_rollups``)
    cols = trained[5]
    d = tm.dinfo
    want = [two_pass(cols[tm.feature_names[i]])[1:] for i in d.numeric_idx]
    assert d.means.tobytes() == np.float32([m for m, _ in want]).tobytes()
    if d.numeric_idx and np.any(d.stds != 1.0):
        assert d.stds.tobytes() == np.float32([s for _, s in want]).tobytes()
    assert d.means.tobytes() == np.asarray(jm.dinfo.means).tobytes()
    assert d.stds.tobytes() == np.asarray(jm.dinfo.stds).tobytes()
    for lyr, w in zip(tm.net_numpy(), jm.net):
        want = np.asarray(w["w"])
        assert lyr["w"].shape == want.shape
        assert np.abs(lyr["w"] - want).max() <= _W_REL * np.abs(want).max()
        np.testing.assert_allclose(lyr["b"], np.asarray(w["b"]), rtol=0,
                                   atol=_W_REL * np.abs(want).max())
    np.testing.assert_allclose(tm.predict_raw(th), ref[name], rtol=0,
                               atol=_P_ABS)
    if name == "autoencoder":
        assert tm.scoring_history == [] and tm.nclasses == 1
        return
    (jrow,), (trow,) = jm.scoring_history, tm.scoring_history
    assert trow["epochs"] == jrow["epochs"]
    keys = ("train_rmse", "train_mae", "train_r2") if tm.nclasses == 1 \
        else ("train_logloss", "train_auc")
    for k in keys:
        assert abs(trow[k] - jrow[k]) <= _M_ABS, (name, k)
    assert set(trow) == set(jrow)


def test_autoencoder_surface(trained):
    (jm, tm), th, ref = trained[0]["autoencoder"], trained[2], trained[3]
    np.testing.assert_allclose(tm.anomaly(th), ref["anomaly"], rtol=0,
                               atol=_P_ABS)
    feats = tm.deepfeatures(th, 0)
    assert feats.shape == (th.nrows, 4)
    np.testing.assert_allclose(feats, ref["deepfeatures"], rtol=0,
                               atol=_P_ABS)
    pf = tm.predict(th)
    assert pf.names == [f"reconstr_{n}" for n in jm.dinfo.coef_names[:-1]]
    assert pf.names[0] == "reconstr_x0" and pf.nrows == th.nrows
    assert abs(tm.model_performance(th)["mse"]
               - float(np.mean(ref["anomaly"]))) <= _M_ABS
    with pytest.raises(ValueError, match="autoencoder=True"):
        trained[0]["binomial"][1].anomaly(th)


def test_validation_metrics_and_predict_frame(trained):
    tf, th = trained[1], trained[2]
    y, kw, tkw = _tkw("binomial")
    m = DeepLearning(**kw).train(y=y, training_frame=tf,
                                 validation_frame=th, **tkw)
    assert m.validation_metrics == m.model_performance(th, "y")
    pf = m.predict(th)
    assert pf.names == ["predict", "pin", "pout"]
    ae = DeepLearning(**CASES["autoencoder"][1]).train(
        training_frame=tf, ignored_columns=list(_RESP),
        validation_frame=th)
    assert set(ae.validation_metrics) == {"mse"}


def test_train_repeats_bitwise(trained):
    """Two trains of one configuration on two frames of the same data
    give bitwise equal networks and scoring histories: the draws are
    made from the seed alone and the step loop holds no other state."""
    tf = trained[1]
    y, kw, tkw = _tkw("dropout_l1l2_sgd")
    kw = dict(kw, epochs=1, activation="rectifier")
    a = DeepLearning(**kw).train(y=y, training_frame=tf, **tkw)
    b = DeepLearning(**kw).train(
        y=y, training_frame=Frame(dict(tf._vecs)), **tkw)
    for la, lb in zip(a.net_numpy(), b.net_numpy()):
        np.testing.assert_array_equal(la["w"], lb["w"])
        np.testing.assert_array_equal(la["b"], lb["b"])
    assert a.scoring_history == b.scoring_history


def test_reference_errors(trained):
    """The reference's ValueErrors, raised by both packages with the
    same messages; cross-validation names its ROADMAP item."""
    tf, jf, jb = trained[1], trained[4], trained[0]["binomial"][0]
    tb = carry(jb)
    ign = ["yr", "ym", "w", "off"]
    cases = [
        (dict(autoencoder=True, hidden=(3,)), dict(offset_column="off"),
         "not supported for autoencoders"),
        (dict(hidden=(3,)), dict(offset_column="off"),
         "only supported for regression"),
        (dict(hidden=(8, 8), epochs=2, checkpoint="ck"), {},
         r"epochs \(2\) must exceed"),
        (dict(hidden=(8, 4), epochs=3, checkpoint="ck"), {},
         "checkpoint layer sizes"),
        (dict(hidden=(8, 8), epochs=3, checkpoint="ck"),
         dict(ignored_columns=ign + ["x0"]), "different features"),
    ]
    for kw, tkw, msg in cases:
        tkw = dict({"ignored_columns": ign}, **tkw)
        if "offset_column" in tkw:
            tkw["ignored_columns"] = ["yr", "ym", "w"]
        for mod, fr, ck in ((JDLM, jf, jb), (DLM, tf, tb)):
            k = dict(kw, checkpoint=ck) if "checkpoint" in kw else kw
            with pytest.raises(ValueError, match=msg), use_mesh(_MESH1):
                mod.DeepLearning(**k).train(y="y", training_frame=fr,
                                            **tkw)
    with pytest.raises(ValueError, match="checkpoint offset_column"):
        DeepLearning(hidden=(8, 8), epochs=3, checkpoint=tb).train(
            y="yr", training_frame=tf, offset_column="off",
            ignored_columns=["y", "ym", "w"])
    assert DeepLearning(nfolds=3).cv_args.nfolds == 3   # item 11: ported
    with pytest.raises(ValueError, match="not supported for autoencoders"):
        DeepLearning(nfolds=3, autoencoder=True)
