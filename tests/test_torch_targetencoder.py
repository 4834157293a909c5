"""PyTorch port, target encoding (``models/targetencoder.py``) against
the JAX package's on the CPU.

The same seeded columns (a 12-level categorical with NAs, a 5-level
one, a binary and a numeric response with NAs, a 5-fold column) go
through both packages. Held here, for the modes ``none``,
``k_fold`` and ``leave_one_out``, with and without blending, on both
responses:
- the prior, the per-level sums and counts and, for ``k_fold``, the
  per-fold ones within 1e-12 (float64 ``index_add_`` against the
  reference's ``np.bincount``);
- ``transform(as_training=True)`` (leakage handling plus numpy noise)
  and the scoring transform BITWISE (the noise is the same
  ``default_rng(seed)`` draw), on the training frame and on a frame
  with an unseen level;
- the artifact both ways: each package's ``MojoModel.transform``
  equals the other's model's scoring transform bitwise;
- the reference's errors, with its messages.
"""

import io

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import mojo as jmojo
from h2o_kubernetes_tpu.models.targetencoder import TargetEncoder as JTE
from h2o_kubernetes_tpu_torch import (Frame, MojoModel, TargetEncoder,
                                      export_mojo)

N = 2000
CASES = [(mode, blend, y) for mode in ("none", "k_fold", "leave_one_out")
         for blend in (False, True) for y in ("yb", "yn")]


def te_cols(rows, seed=0):
    rng = np.random.default_rng(seed)
    a = np.array([f"L{i}" for i in range(12)], dtype=object)[
        rng.zipf(1.6, rows) % 12]
    a[::31] = None
    b = np.array(list("vwxyz"), dtype=object)[rng.integers(0, 5, rows)]
    yn = (rng.normal(size=rows) + (a == "L1")).astype(np.float32)
    yn[::43] = np.nan
    yb = np.where(rng.uniform(size=rows) < 0.3 + 0.4 * (b == "v"), "y",
                  "n")
    return {"a": a, "b": b, "yn": yn, "yb": yb,
            "fold": (np.arange(rows) % 5).astype(np.float32)}


@pytest.fixture(scope="module")
def fitted():
    cols = te_cols(N)
    other = te_cols(300, seed=4)
    other["a"][:7] = "unseen"
    jf = h2o.Frame.from_arrays(cols)
    tf = Frame.from_arrays(cols, device="cpu")
    out = {}
    for mode, blend, y in CASES:
        kw = dict(data_leakage_handling=mode, blending=blend,
                  fold_column="fold", seed=7)
        out[(mode, blend, y)] = (
            JTE(**kw).train(y=y, training_frame=jf, x=["a", "b"]),
            TargetEncoder(**kw).train(y=y, training_frame=tf, x=["a", "b"]))
    return out, cols, other


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                              for c in CASES])
def test_tables_within_1e_12(fitted, case):
    jm, tm = fitted[0][case]
    assert tm.columns == jm.columns and tm.y == jm.y
    assert abs(tm.prior - jm.prior) <= 1e-12
    for c in jm.columns:
        jt, tt = jm.tables[c], tm.tables[c]
        assert tt["domain"] == jt["domain"]
        for k in ("sum", "cnt", "fold_sum", "fold_cnt"):
            if jt[k] is None:
                assert tt[k] is None
                continue
            np.testing.assert_allclose(tt[k], jt[k], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                              for c in CASES])
def test_transforms_bitwise(fitted, case):
    jm, tm = fitted[0][case]
    cols, other = fitted[1], fitted[2]
    for data in (cols, other):
        jf, tf = h2o.Frame.from_arrays(data), Frame.from_arrays(data,
                                                                device="cpu")
        for as_training in (True, False):
            if as_training and data is other and case[0] != "none":
                continue        # fold ids / responses of another frame
            jo = jm.transform(jf, as_training=as_training)
            to = tm.transform(tf, as_training=as_training)
            for c in jm.columns:
                a = np.asarray(jo[f"{c}_te"].to_numpy())[: len(data["a"])]
                b = to[f"{c}_te"].to_numpy()
                assert a.tobytes() == b.tobytes(), (c, as_training)


def test_artifacts_both_ways(fitted):
    jm, tm = fitted[0][("k_fold", True, "yb")]
    other = fitted[2]
    tf = Frame.from_arrays(other, device="cpu")
    want = tm.transform(tf)
    buf = io.BytesIO()
    export_mojo(tm, buf)
    jmm = jmojo.MojoModel(io.BytesIO(buf.getvalue()))
    got = jmm.transform(h2o.Frame.from_arrays(other))
    buf2 = io.BytesIO()
    jmojo.export_mojo(jm, buf2)
    got2 = MojoModel(io.BytesIO(buf2.getvalue())).transform(tf)
    for c in tm.columns:
        w = want[f"{c}_te"].to_numpy()
        assert got[f"{c}_te"].tobytes() == w.tobytes()
        assert got2[f"{c}_te"].tobytes() == w.tobytes()
    # string columns score too
    strs = {c: np.asarray(other[c]) for c in tm.columns}
    assert MojoModel(io.BytesIO(buf.getvalue())).transform(strs)["a_te"] \
        .tobytes() == want["a_te"].to_numpy().tobytes()


@pytest.mark.parametrize("kw, train, msg", [
    ({"data_leakage_handling": "bogus"}, {}, "unknown data_leakage"),
    ({"data_leakage_handling": "k_fold"}, {"y": "yb"}, "needs fold_column"),
    ({}, {"y": "yb", "x": ["yn"]}, "not categorical"),
])
def test_errors_match_reference(kw, train, msg):
    cols = te_cols(200)
    for cls, fr in ((JTE, h2o.Frame.from_arrays(cols)),
                    (TargetEncoder, Frame.from_arrays(cols, device="cpu"))):
        with pytest.raises(ValueError, match=msg):
            cls(**kw).train(training_frame=fr, **train)
