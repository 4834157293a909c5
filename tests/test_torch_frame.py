"""PyTorch port, the Frame remainder (``frame/frame.py``) against the JAX
package on the CPU: the same seeded numpy columns go through both.

Bitwise (NaN positions equal, every other value equal bit for bit, so
±0 and ±inf count): + - * / % // and negation, with the reflected
forms the reference has, the comparisons, the logical and NA operators on values with
NaN, ±0, ±inf, halves and integers, Vec ⊕ Vec and Vec ⊕ scalar in
both orders; abs, floor, ceil, sign and sqrt; ``select_rows``,
``split_frame``, ``sort``, ``rbind``, ``cbind``, filters, ``asfactor``
and ``asnumeric``; time columns (origin, ``as_float``, ``to_numpy``,
NaT). Within a stated tolerance: log, exp and ``**`` ≤ 1 ulp, log1p
≤ 2 ulp (XLA's CPU backend flushes denormal results to zero, so the
port's are compared flushed); rollups: min, max and counts equal,
mean and sigma the float64 two-pass values. The reference's
``select_rows`` runs its device gather (``H2O_TPU_DEVICE_GATHER_MIN=0``),
the port's only path.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import Frame
from h2o_kubernetes_tpu_torch.frame import frame as frame_mod
from torch_f64_rollups import two_pass

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_shard():
    """The reference on a one-row-shard mesh, its select_rows through
    the device gather (the port has no host path)."""
    old = os.environ.get("H2O_TPU_DEVICE_GATHER_MIN")
    os.environ["H2O_TPU_DEVICE_GATHER_MIN"] = "0"
    with use_mesh(make_mesh(n_rows=1)):
        yield
    if old is None:
        os.environ.pop("H2O_TPU_DEVICE_GATHER_MIN")
    else:
        os.environ["H2O_TPU_DEVICE_GATHER_MIN"] = old


def bitwise(a, b):
    """Equal NaN positions and equal bits everywhere else."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype.kind != "f":
        np.testing.assert_array_equal(a, b)
        return
    na, nb = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(na, nb)
    u = {4: np.uint32, 8: np.uint64}[a.itemsize]
    bad = np.flatnonzero(a[~na].view(u) != b[~nb].view(u))
    assert bad.size == 0, (bad[:5], a[~na][bad[:5]], b[~nb][bad[:5]])


def ref_data(jv) -> np.ndarray:
    return np.asarray(jv.data)[: jv.nrows]


def same_vec(tv, jv):
    assert tv.kind == jv.kind, (tv.kind, jv.kind)
    assert tv.nrows == jv.nrows
    assert tv.domain == jv.domain
    assert tv.device.type == "cpu"
    if tv.kind == "time":
        assert tv.origin == jv.origin or (np.isnan(tv.origin)
                                          and np.isnan(jv.origin))
    bitwise(tv.data.numpy(), ref_data(jv))
    bitwise(tv.to_numpy(), jv.to_numpy())


def same_frame(tf, jf):
    assert tf.names == jf.names, (tf.names, jf.names)
    assert tf.nrows == jf.nrows
    for n in tf.names:
        same_vec(tf[n], jf[n])


def special_values(n: int, seed: int) -> np.ndarray:
    """float32: normals at several scales, integers, halves, and NaN,
    ±0 and ±inf at fixed places."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * rng.choice([0.01, 1.0, 37.0, 1e6], n))
    x = x.astype(np.float32)
    k = rng.integers(0, 6, n)
    x = np.where(k == 0, np.round(x), x)
    x = np.where(k == 1, np.round(x * 2) / 2, x).astype(np.float32)
    specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
                         0.5, -0.5, 2.5, -2.5, 3.0], np.float32)
    x[: len(specials)] = specials
    x[len(specials):2 * len(specials)] = specials[::-1]
    return x


N = 600


def cols(n=N, seed=0) -> dict:
    rng = np.random.default_rng(seed + 1)
    c = {"a": special_values(n, seed), "b": special_values(n, seed + 7),
         "g": np.array(["u", "v", "w", ""])[rng.integers(0, 4, n)],
         "k": rng.integers(0, 5, n).astype(np.float32)}
    c["k"][::11] = np.nan
    t = (1_700_000_000_000 + rng.integers(0, 10 ** 9, n)).astype(
        "datetime64[ms]")
    t[::17] = np.datetime64("NaT")
    c["t"] = t
    return c


@pytest.fixture(scope="module")
def frames():
    c = cols()
    return Frame.from_arrays(c, device=DEV), h2o.Frame.from_arrays(c)


# -- construction and time columns -------------------------------------------

def test_from_arrays_and_time_columns(frames):
    tf, jf = frames
    same_frame(tf, jf)
    bitwise(tf["t"].as_float().numpy(), np.asarray(jf["t"].as_float())[:N])
    assert np.isnan(tf["t"].to_numpy()[::17]).all()
    # a float64 epoch-ms column asked to be time, and an all-NaT one
    for x in (np.array([1.6e12, np.nan, 1.6e12 + 0.25]),
              np.array(["NaT", "NaT"], dtype="datetime64[ms]")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN min
            tv = frame_mod.Vec.from_numpy(x, "t", kind="time", device=DEV)
            jv = h2o.frame.Vec.from_numpy(x, "t", kind="time")
        same_vec(tv, jv)
        bitwise(tv.as_float().numpy(), np.asarray(jv.as_float())[:len(x)])


@pytest.mark.parametrize("col", ["a", "k", "g", "t", "year"])
def test_rollups_close(frames, col):
    """min, max and the counts equal the reference's; mean and sigma are
    the numpy float64 two-pass values (``tests/torch_f64_rollups.py``),
    within 1e-12 relative and equal once rounded to float32. ``year``
    (2,000 rows, mean 1997, sigma 6.3) is where the reference's one
    float32 pass drifts."""
    tf, jf = frames
    if col == "year":
        x = (1997.0 + 6.3 * np.random.default_rng(3).normal(size=2000)
             ).astype(np.float32)
        tf = Frame.from_arrays({"year": x}, device=DEV)
        jf = h2o.Frame.from_arrays({"year": x})
    tr, jr = tf[col].rollups(), jf[col].rollups()
    for key in ("nacnt", "zeros", "rows"):
        assert tr[key] == jr[key], key
    for key in ("min", "max"):
        a, b = tr[key], jr[key]
        assert (np.isnan(a) and np.isnan(b)) or a == b, (key, a, b)
    v = tf[col]
    x = (v.data if v.kind == "time" else v.as_float()).numpy()
    _, mean, sigma = two_pass(x)
    mean += v.origin if v.kind == "time" else 0.0
    for key, want in (("mean", mean), ("sigma", sigma)):
        got = tr[key]
        if not np.isfinite(want):       # ±inf in the column
            assert (np.isnan(got) and np.isnan(want)) or got == want
            continue
        assert abs(got - want) <= 1e-12 * max(abs(want), 1.0), (key, got)
        assert np.float32(got) == np.float32(want), (key, got, want)


def test_rollups_of_an_empty_selection(frames):
    tf, jf = frames
    for f in (tf, jf):
        r = f.select_rows(np.zeros(f.nrows, dtype=bool))["a"].rollups()
        assert np.isnan(r["mean"]) and r["nacnt"] == 0 and r["rows"] == 0


# -- elementwise algebra -------------------------------------------------------

OPS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "truediv": lambda a, b: a / b,
    "mod": lambda a, b: a % b, "floordiv": lambda a, b: a // b,
}
REFLECTED = ("add", "sub", "mul", "truediv")   # the reference's __r*__
SCALARS = [2.5, -3.0, 0.0, -0.0, 0.5, 2, True, np.float32(0.1),
           float("inf"), float("nan")]


@pytest.mark.parametrize("op", list(OPS))
def test_arithmetic_bitwise(frames, op):
    tf, jf = frames
    fn = OPS[op]
    bitwise(fn(tf["a"], tf["b"]).data.numpy(),
            ref_data(fn(jf["a"], jf["b"])))
    bitwise(fn(tf["b"], tf["a"]).data.numpy(),
            ref_data(fn(jf["b"], jf["a"])))
    for s in SCALARS:
        bitwise(fn(tf["a"], s).data.numpy(), ref_data(fn(jf["a"], s)))
        if op in REFLECTED:
            bitwise(fn(s, tf["a"]).data.numpy(), ref_data(fn(s, jf["a"])))
        else:
            for v in (tf["a"], jf["a"]):
                with pytest.raises(TypeError):
                    fn(s, v)


def test_pow_within_one_ulp(frames):
    """The reference's CPU pow is the C library's ``powf`` (within 1 ulp
    of the correctly rounded value, which the port's float64 pow gives),
    with denormal results flushed to zero."""
    tf, jf = frames
    for x, y in (("a", "b"), ("b", "a")):
        assert _ulps(ftz((tf[x] ** tf[y]).data.numpy()),
                     ref_data(jf[x] ** jf[y])) <= 1, (x, y)
    for s in SCALARS:
        assert _ulps(ftz((tf["a"] ** s).data.numpy()),
                     ref_data(jf["a"] ** s)) <= 1, s


def test_negation_and_time_operand(frames):
    tf, jf = frames
    bitwise((-tf["a"]).data.numpy(), ref_data(-jf["a"]))
    # a time column computes on its absolute float32 epoch-ms
    bitwise((tf["t"] - 1.7e12).data.numpy(), ref_data(jf["t"] - 1.7e12))
    bitwise((tf["a"] + tf["t"]).data.numpy(), ref_data(jf["a"] + jf["t"]))


@pytest.mark.parametrize("fn", ["abs", "floor", "ceil", "sign", "sqrt"])
def test_math_bitwise(frames, fn):
    tf, jf = frames
    for c in ("a", "b"):
        bitwise(getattr(tf[c], fn)().data.numpy(),
                ref_data(getattr(jf[c], fn)()))


def ftz(x: np.ndarray) -> np.ndarray:
    """float32 with denormals flushed to ±0, as XLA's CPU backend writes
    them."""
    tiny = np.abs(x) < np.finfo(np.float32).tiny
    return np.where(tiny, np.copysign(np.float32(0), x), x).astype(x.dtype)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest ulp distance between two float32 arrays (NaN positions and
    infinities must agree)."""
    na, nb = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(na, nb)
    a, b = a[~na], b[~nb]
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if a.size else 0


@pytest.mark.parametrize("fn, ulps", [("log", 1), ("exp", 1), ("log1p", 2)])
def test_math_within_ulps(frames, fn, ulps):
    tf, jf = frames
    for c in ("a", "b"):
        got = ftz(getattr(tf[c], fn)().data.numpy())
        want = ref_data(getattr(jf[c], fn)())
        assert _ulps(got, want) <= ulps, (fn, c)


CMPS = {"lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
        "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
        "eq": lambda a, b: a == b, "ne": lambda a, b: a != b}


@pytest.mark.parametrize("op", list(CMPS))
def test_comparisons_bitwise(frames, op):
    tf, jf = frames
    fn = CMPS[op]
    bitwise(fn(tf["a"], tf["b"]).data.numpy(),
            ref_data(fn(jf["a"], jf["b"])))
    for s in (0.0, -0.0, 1.0, 0.5, float("inf"), float("nan")):
        bitwise(fn(tf["a"], s).data.numpy(), ref_data(fn(jf["a"], s)))
        bitwise(fn(s, tf["a"]).data.numpy(), ref_data(fn(s, jf["a"])))
    if op in ("eq", "ne"):
        for label in ("u", "w", "zz"):
            bitwise(fn(tf["g"], label).data.numpy(),
                    ref_data(fn(jf["g"], label)))


def test_logical_and_na_operators(frames):
    tf, jf = frames
    tx, jx = tf["a"] > 0, jf["a"] > 0
    ty, jy = tf["g"] == "v", jf["g"] == "v"
    bitwise((tx & ty).data.numpy(), ref_data(jx & jy))
    bitwise((tx | ty).data.numpy(), ref_data(jx | jy))
    bitwise((~tx).data.numpy(), ref_data(~jx))
    bitwise((~tf["b"]).data.numpy(), ref_data(~jf["b"]))
    for c in ("a", "g", "t", "k"):
        bitwise(tf[c].isna().data.numpy(), ref_data(jf[c].isna()))


def test_reference_errors(frames):
    tf, jf = frames
    for f in (tf, jf):
        with pytest.raises(TypeError, match="enum column"):
            f["g"] + 1.0
        with pytest.raises(TypeError, match="enum column"):
            f["a"] * f["g"]
        with pytest.raises(TypeError, match="enum column"):
            f["g"] < 1.0
        with pytest.raises(TypeError, match="needs an enum"):
            f["a"] == "u"
        with pytest.raises(TypeError, match="cannot combine"):
            f["a"] + "x"
        with pytest.raises(TypeError, match="needs two Vecs"):
            f["a"] & 1.0
        with pytest.raises(TypeError, match="math is not applicable"):
            f["g"].log()
        with pytest.raises(ValueError, match="length mismatch"):
            f["a"] + f.head(3)["a"]
        with pytest.raises(TypeError, match="unhashable"):
            {f["a"]: 1}
        with pytest.raises(IndexError, match="out of range"):
            f["a"].select_rows(np.array([0, f.nrows]))
        with pytest.raises(IndexError, match="integers or booleans"):
            f["a"].select_rows(np.array([0.0, 1.0]))
        with pytest.raises(ValueError, match="sum to < 1"):
            f.split_frame([0.5, 0.5])


# -- rows -----------------------------------------------------------------------

@pytest.mark.parametrize("idx", [
    np.arange(0, N, 7), np.array([-1, -N, 3, 3, 0]),
    np.zeros(0, np.int64), np.array([5], np.int32)], ids=[
        "stride", "negative", "empty", "int32"])
def test_select_rows_bitwise(frames, idx):
    tf, jf = frames
    same_frame(tf.select_rows(idx), jf.select_rows(idx))


def test_select_rows_mask_head_drop(frames):
    tf, jf = frames
    mask = np.random.default_rng(5).random(N) < 0.3
    same_frame(tf.select_rows(mask), jf.select_rows(mask))
    same_frame(tf.head(7), jf.head(7))
    same_frame(tf.drop(["g", "t"]), jf.drop(["g", "t"]))
    same_frame(tf[["t", "a"]], jf[["t", "a"]])
    assert tf.shape == jf.shape == (N, 5) and tf.ncols == 5


def test_filters_bitwise(frames):
    tf, jf = frames
    same_frame(tf[(tf["a"] > 0.5) & (tf["g"] == "u")],
               jf[(jf["a"] > 0.5) & (jf["g"] == "u")])
    same_frame(tf[tf["k"].isna() | (tf["b"] <= 0)],
               jf[jf["k"].isna() | (jf["b"] <= 0)])
    same_frame(tf[tf["a"] != tf["a"]], jf[jf["a"] != jf["a"]])


@pytest.mark.parametrize("ratios, seed", [([0.8], 42), ([0.6, 0.2], 7),
                                          ([0.25], 0)])
def test_split_frame_bitwise(frames, ratios, seed):
    tf, jf = frames
    tp, jp = tf.split_frame(ratios, seed=seed), jf.split_frame(ratios,
                                                               seed=seed)
    assert len(tp) == len(jp) == len(ratios) + 1
    for a, b in zip(tp, jp):
        same_frame(a, b)


@pytest.mark.parametrize("by, ascending", [
    ("a", True), ("a", False), ("g", True), ("g", False), ("t", True),
    (["k", "a"], True), (["g", "k", "t"], False), (["k", "g"], True)])
def test_sort_bitwise(frames, by, ascending):
    tf, jf = frames
    same_frame(tf.sort(by, ascending=ascending),
               jf.sort(by, ascending=ascending))


def test_rbind_and_cbind_bitwise(frames):
    tf, jf = frames
    c2 = cols(50, seed=3)
    c2["g"] = np.array(["v", "x", "a", ""])[np.arange(50) % 4]
    tb = Frame.from_arrays(c2, device=DEV)
    jb = h2o.Frame.from_arrays(c2)
    same_frame(tf.rbind(tb), jf.rbind(jb))
    same_frame(tf.rbind(tf), jf.rbind(jf))
    same_frame(tf.cbind(tf[["a", "t"]]), jf.cbind(jf[["a", "t"]]))
    for f, g in ((tf, tb), (jf, jb)):
        with pytest.raises(ValueError, match="names differ"):
            f.rbind(g.drop("a"))
        with pytest.raises(ValueError, match="nrows differ"):
            f.cbind(g)


# -- type changes ---------------------------------------------------------------

@pytest.mark.parametrize("col", ["a", "k", "t"])
def test_asfactor_bitwise(frames, col):
    tf, jf = frames
    same_vec(tf[col].asfactor(), jf[col].asfactor())
    assert tf["g"].asfactor() is tf["g"]


def test_asnumeric_bitwise(frames):
    tf, jf = frames
    same_vec(tf["k"].asfactor().asnumeric(), jf["k"].asfactor().asnumeric())
    same_vec(tf["g"].asnumeric(), jf["g"].asnumeric())    # labels -> codes
    empty = {"c": np.array([-1, -1], np.int32)}
    same_vec(Frame.from_arrays(empty, domains={"c": []}, device=DEV)["c"]
             .asnumeric(),
             h2o.Frame.from_arrays(empty, domains={"c": []})["c"]
             .asnumeric())
    assert tf["a"].asnumeric() is tf["a"]


def test_to_matrix_summary_pandas(frames):
    tf, jf = frames
    bitwise(tf.to_matrix(["a", "g", "t"]).numpy(),
            np.asarray(jf.to_matrix(["a", "g", "t"]))[:N])
    assert set(tf.summary()) == set(jf.summary())
    pd = pytest.importorskip("pandas")
    tp, jp = tf.to_pandas(), jf.to_pandas()
    pd.testing.assert_frame_equal(tp, jp)
    df = pd.DataFrame({"x": np.arange(5, dtype=np.float32),
                       "s": list("abcab")})
    same_frame(Frame.from_pandas(df, device=DEV), h2o.Frame.from_pandas(df))


# -- the device ------------------------------------------------------------------

def test_cpu_frame_never_reaches_for_the_card(frames, monkeypatch):
    """Every Vec an operation makes lives on its source's device: no
    operation of a CPU frame resolves the default device (the card)."""
    from h2o_kubernetes_tpu_torch.runtime import backend

    real = backend.resolve_device

    def strict(device=None):
        assert device is not None, "an operation reached for the card"
        return real(device)
    monkeypatch.setattr(frame_mod, "resolve_device", strict)
    tf, _ = frames
    outs = [tf.sort(["g", "a"]), tf.split_frame([0.5], seed=1)[0],
            tf.rbind(tf), tf[tf["a"] > 0], tf["k"].asfactor(),
            tf["g"].asnumeric(), tf["a"] // 2.0, tf["t"].unique(),
            tf.group_by("g").mean("a").count().get_frame(),
            tf.merge(tf.group_by("g").max("b").get_frame(), all_x=True),
            tf.table("g"), tf.quantile()]
    for o in outs:
        vecs = o.columns() if isinstance(o, Frame) else [o]
        assert all(v.device.type == "cpu" for v in vecs)
