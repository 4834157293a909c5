"""PyTorch port, the munging surface (``frame/munge.py``) against the
JAX package on the CPU: the same seeded numpy columns go through both.

Bitwise: GroupBy's keys (enum, numeric, NA groups), counts, min and
max; ``merge`` (inner and left, enum and numeric keys, NA matching NA,
a duplicate name's suffix, a time column on the right); ``impute``
(mean, median, mode, by a group; a time column stays time); ``table``
of one and two columns; ``quantile`` (``jax.jit(jnp.nanquantile)`` over
the whole column, the reference's own call); ``unique``. Within 1e-6 of
each group's Σ|x|: GroupBy's sums, means (Σ|x|/n) and sd; var within
1e-6 of Σx²/(n-1) (the port accumulates in float64, the reference in
float32).
"""

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu_torch import Frame
from test_torch_frame import (_one_shard, bitwise, cols, same_frame,  # noqa
                              same_vec)

DEV = "cpu"


@pytest.fixture(scope="module")
def frames():
    c = cols(900, seed=11)
    rng = np.random.default_rng(12)
    c["h"] = np.array(["p", "q", "r"])[rng.integers(0, 3, 900)]
    c["x"] = rng.normal(size=900).astype(np.float32) * 10
    c["x"][::13] = np.nan
    return Frame.from_arrays(c, device=DEV), h2o.Frame.from_arrays(c)


# -- group_by -------------------------------------------------------------------

def _group(f, by, aggs):
    g = f.group_by(by)
    for stat, col in aggs:
        g = g.count() if stat == "count" else getattr(g, stat)(col)
    return g.get_frame()


GROUPINGS = {
    "enum": ("g", [("sum", "x"), ("mean", "x"), ("min", "a"),
                   ("max", "a"), ("sd", "x"), ("var", "b"), ("count", "")]),
    "two enums": (["g", "h"], [("mean", "x"), ("min", "x"), ("max", "b"),
                               ("count", "")]),
    "numeric key": ("k", [("sum", "b"), ("sd", "x"), ("count", "")]),
    "enum and numeric": (["h", "k"], [("min", "t"), ("max", "t"),
                                      ("mean", "a"), ("count", "")]),
}


@pytest.mark.parametrize("name", list(GROUPINGS))
def test_group_by(frames, name):
    tf, jf = frames
    by, aggs = GROUPINGS[name]
    to, jo = _group(tf, by, aggs), _group(jf, by, aggs)
    assert to.names == jo.names
    keys = [by] if isinstance(by, str) else by
    for n in keys + ["nrow"] + [f"{s}_{c}" for s, c in aggs
                                if s in ("min", "max")]:
        same_vec(to[n], jo[n])
    # each group's Σ|x| over the source rows, in float64
    codes = np.zeros(tf.nrows, np.int64)
    for k in keys:
        v = tf[k].to_numpy()
        u, inv = np.unique(np.where(np.isnan(v.astype(np.float64)),
                                    np.inf, v), return_inverse=True)
        codes = codes * (len(u) + 1) + inv
    out_codes = np.zeros(to.nrows, np.int64)
    for k in keys:
        src, dst = tf[k].to_numpy(), to[k].to_numpy()
        key = lambda a: np.where(np.isnan(a.astype(np.float64)), np.inf, a)
        u = np.unique(key(src))
        out_codes = out_codes * (len(u) + 1) + np.searchsorted(u, key(dst))
    for stat, c in aggs:
        if stat in ("min", "max", "count"):
            continue
        x = tf[c].as_float().numpy().astype(np.float64)
        # the yardstick in the statistic's units: Σ|x| for sums, means
        # and sd, Σx² for var
        absx = np.where(np.isnan(x), 0.0, np.abs(x) ** (2 if stat == "var"
                                                        else 1))
        scale = np.array([absx[codes == g].sum() for g in out_codes])
        cnt = np.array([(~np.isnan(x[codes == g])).sum() for g in out_codes])
        if stat == "var":
            scale = scale / np.maximum(cnt - 1, 1)
        got, want = to[f"{stat}_{c}"].to_numpy(), jo[f"{stat}_{c}"].to_numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        inf = np.isinf(want)             # a group holding ±inf: exact
        np.testing.assert_array_equal(got[inf], want[inf])
        ok = ~np.isnan(want) & ~inf
        lim = 1e-6 * scale / (np.maximum(cnt, 1) if stat == "mean" else 1)
        gap = np.abs(got[ok].astype(np.float64) - want[ok])
        assert (gap <= lim[ok] + 1e-30).all(), (stat, c, gap.max())


def test_group_by_errors(frames):
    tf, jf = frames
    for f in (tf, jf):
        with pytest.raises(KeyError):
            f.group_by("nope")
        with pytest.raises(ValueError, match="enum column"):
            f.group_by("g").sum("h")
        with pytest.raises(ValueError, match="needs a column"):
            f.group_by("g").mean()


# -- merge ----------------------------------------------------------------------

def _right(rng_seed, keys):
    rng = np.random.default_rng(rng_seed)
    n = 40
    r = {"g": np.array(["u", "w", "z", ""])[rng.integers(0, 4, n)],
         "k": rng.integers(0, 7, n).astype(np.float32),
         "y": rng.normal(size=n).astype(np.float32),
         "a": rng.normal(size=n).astype(np.float32),     # a duplicate name
         "e": np.array(["m", "n"])[rng.integers(0, 2, n)],
         "t2": (1_600_000_000_000 + rng.integers(0, 10 ** 8, n)).astype(
             "datetime64[ms]")}
    r["k"][::9] = np.nan
    return {k: v for k, v in r.items()}


@pytest.mark.parametrize("by, all_x", [
    ("g", False), ("g", True), ("k", False), ("k", True),
    (["g", "k"], True)])
def test_merge_bitwise(frames, by, all_x):
    tf, jf = frames
    r = _right(3, by)
    keys = [by] if isinstance(by, str) else by
    drop = [c for c in ("g", "k") if c not in keys]
    tr = Frame.from_arrays(r, device=DEV).drop(drop)
    jr = h2o.Frame.from_arrays(r).drop(drop)
    same_frame(tf.merge(tr, by=by, all_x=all_x),
               jf.merge(jr, by=by, all_x=all_x))


def test_merge_errors(frames):
    tf, jf = frames
    r = {"zz": np.arange(3, dtype=np.float32)}
    for f, R in ((tf, Frame.from_arrays(r, device=DEV)),
                 (jf, h2o.Frame.from_arrays(r))):
        with pytest.raises(ValueError, match="no common key"):
            f.merge(R)
    bad = {"g": np.arange(3, dtype=np.float32)}
    for f, R in ((tf, Frame.from_arrays(bad, device=DEV)),
                 (jf, h2o.Frame.from_arrays(bad))):
        with pytest.raises(ValueError, match="enum vs numeric"):
            f.merge(R, by="g")


# -- impute / table / quantile / unique -----------------------------------------

@pytest.mark.parametrize("column, method, by", [
    ("x", "mean", None), ("x", "median", None), ("t", "mean", None),
    ("t", "median", None), ("g", "mode", None), ("x", "mean", "h"),
    ("t", "mean", "g")])
def test_impute_bitwise(column, method, by):
    c = cols(300, seed=21)
    c["h"] = np.array(["p", "q", ""])[np.arange(300) % 3]
    c["x"] = np.where(np.arange(300) % 4 == 0, np.nan,
                      np.random.default_rng(2).normal(size=300) * 3
                      ).astype(np.float32)
    tf, jf = Frame.from_arrays(c, device=DEV), h2o.Frame.from_arrays(c)
    tv = tf.impute(column, method=method, by=by)
    jv = jf.impute(column, method=method, by=by)
    assert tv == jv or (isinstance(tv, float) and np.isnan(tv)
                        and np.isnan(jv))
    same_frame(tf, jf)


def test_impute_errors(frames):
    tf, jf = frames
    for f in (tf, jf):
        with pytest.raises(ValueError, match="unknown impute"):
            f.impute("x", "max")
        with pytest.raises(ValueError, match="mode"):
            f.impute("g", "mean")
        with pytest.raises(ValueError, match="categorical"):
            f.impute("x", "mean", by="k")


@pytest.mark.parametrize("args", [("g",), ("h",), ("g", "h"), ("h", "g")])
def test_table_bitwise(frames, args):
    tf, jf = frames
    same_frame(tf.table(*args), jf.table(*args))


def test_table_errors(frames):
    tf, jf = frames
    for f in (tf, jf):
        with pytest.raises(ValueError, match="categorical"):
            f.table("x")


@pytest.mark.parametrize("prob", [None, [0.0, 0.5, 1.0],
                                  [0.3, 0.123, 0.999999]])
def test_quantile_bitwise(frames, prob):
    tf, jf = frames
    same_frame(tf.quantile(prob), jf.quantile(prob))


def test_quantile_over_signed_zeros_and_large_columns():
    rng = np.random.default_rng(4)
    for x in (np.array([0.0, -0.0, -0.0, 0.0, np.nan], np.float32),
              np.where(rng.random(70_001) < 0.05, np.nan,
                       rng.standard_t(3, 70_001)).astype(np.float32),
              np.full(5, np.nan, np.float32)):
        same_frame(Frame.from_arrays({"x": x}, device=DEV).quantile(),
                   h2o.Frame.from_arrays({"x": x}).quantile())
    f = {"g": np.array(["a", "b"])}
    for F in (Frame.from_arrays(f, device=DEV), h2o.Frame.from_arrays(f)):
        with pytest.raises(ValueError, match="no numeric"):
            F.quantile()
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            F.quantile([1.5])


@pytest.mark.parametrize("col", ["g", "k", "x", "t"])
def test_unique_bitwise(frames, col):
    tf, jf = frames
    same_frame(tf[col].unique(), jf[col].unique())
