"""PyTorch port, ingest (``frame/parse.py``, ``import_file``) against the
JAX package on the CPU: the same files, written in ``tmp_path``, parsed
by both. Names, kinds, domains, time origins and every value bitwise:
CSV on both host paths (pyarrow's streamed reader and the pure-Python
one), separators, headers, quotes, NA tokens, type overrides, skipped
and duplicate columns, gz/bz2/xz, globs and directories with repeated
headers, time inference; Parquet, ORC, Avro (null and deflate),
SVMLight and ARFF; ``parse_setup``'s dict; the reference's errors.

Then a GBM trained on an imported CSV with a time column and enums
(4,096 rows, 3 trees of depth 3) against the JAX package's on a
one-row-shard mesh: the split structure up to float64 near-ties
(``tools/torch_tree_parity.walk``), leaves within 1e-5.
"""

import bz2
import gzip
import lzma

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import GBM as JGBM
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import GBM, import_file, parse_setup
from test_parse import ARFF_DOC
from test_parse_avro_svmlight import _SCHEMA, _rows, _write_avro
from test_torch_frame import _one_shard, same_frame  # noqa: F401
from tools.torch_tree_parity import round_stats, walk

DEV = "cpu"

CSV = """id,age,income,city,signup,when
1,34,55000.5,austin,2021-03-04,2021-03-04 10:11:12
2,41,NA,boston,2021-05-12,2021-05-12 00:00:01
3,,72100,"austin",2022-01-30,
4,29,48000,chicago,2021-11-02,2021-11-02 23:59:59
5,50,91000,?,2020-07-19,2020-07-19 08:00:00
6,-0,1e3," new york ",2019-12-31,2019-12-31 12:00:00
"""


def both(path, **kw):
    return (import_file(path, device=DEV, **kw), h2o.import_file(path, **kw))


@pytest.fixture(params=["arrow", "python"])
def csv_path(request, monkeypatch):
    """Both CSV host paths: H2O_TPU_ARROW_CSV on (pyarrow's reader) and
    off (the pure-Python reader); both packages read the knob."""
    monkeypatch.setenv("H2O_TPU_ARROW_CSV",
                       "1" if request.param == "arrow" else "0")
    return request.param


def test_parse_setup_equal(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text(CSV)
    assert parse_setup(str(p)) == h2o.parse_setup(str(p))
    q = tmp_path / "d.tsv"
    q.write_text(CSV.replace(",", "\t"))
    assert parse_setup(str(q)) == h2o.parse_setup(str(q))


@pytest.mark.parametrize("kw", [
    {}, {"col_types": {"id": "enum", "age": "string"}},
    {"col_types": ["numeric", "numeric", "numeric", "enum", "enum",
                   "time"]},
    {"na_strings": ["austin"]}, {"skipped_columns": ["income", "when"]},
    {"header": 1}], ids=["plain", "types", "type-list", "na", "skip",
                         "header"])
def test_csv_bitwise(tmp_path, csv_path, kw):
    p = tmp_path / "d.csv"
    p.write_text(CSV)
    t, j = both(str(p), **kw)
    same_frame(t, j)
    assert t.csv_path == csv_path
    if not kw:                                 # both inferred as time
        assert t["when"].kind == "time" and t["signup"].kind == "time"


@pytest.mark.parametrize("text", [
    "a;b;c\n1;x;2\n3;y;4\n",                     # separator sniffed
    "1\t2\t3\n4\t5\t6\n",                          # headerless, tabs
    'n,s\n1,"he said ""hi"", ok"\n2,"x\ny"\n',     # quotes, a newline
    "a,a,b,a2\n1,2,x,3\n4,5,y,6\n",                # duplicate headers
    "A,B\nfoo,bar\nbaz,qux\n",                     # all-string header
    "\n\nx,y\n1,NaN\n2,-\n",                       # blank lines, NA tokens
], ids=["sniff", "headerless", "quotes", "dups", "strings", "blanks"])
def test_csv_shapes_bitwise(tmp_path, csv_path, text):
    p = tmp_path / "d.csv"
    p.write_text(text)
    same_frame(*both(str(p)))


@pytest.mark.parametrize("ext, opener", [(".gz", gzip.open),
                                         (".bz2", bz2.open),
                                         (".xz", lzma.open)])
def test_compressed_bitwise(tmp_path, csv_path, ext, opener):
    p = tmp_path / f"d.csv{ext}"
    with opener(p, "wt") as f:
        f.write(CSV)
    same_frame(*both(str(p)))


def test_globs_and_directories_bitwise(tmp_path, csv_path):
    d = tmp_path / "parts"
    d.mkdir()
    (d / "p1.csv").write_text("a,b,c\n1,x,2020-01-01\n2,y,2020-01-02\n")
    (d / "p2.csv").write_text("a,b,c\n3,z,2020-02-01\n")
    (d / "p3.csv").write_text("4,x,2021-01-01\n")       # headerless tail
    same_frame(*both(str(d)))
    same_frame(*both(str(d / "p*.csv")))
    same_frame(*both([str(d / "p2.csv"), str(d / "p1.csv")]))


def test_csv_errors(tmp_path, csv_path):
    p = tmp_path / "ragged.csv"
    p.write_text("a,b\n1,2\n3\n")
    for imp in (lambda: import_file(str(p), device=DEV),
                lambda: h2o.import_file(str(p))):
        with pytest.raises(ValueError, match="columns, expected"):
            imp()
    for imp in (lambda: import_file(str(tmp_path / "none*.csv"),
                                    device=DEV),
                lambda: h2o.import_file(str(tmp_path / "none*.csv"))):
        with pytest.raises(FileNotFoundError):
            imp()


def test_import_file_resolves_its_device(tmp_path, monkeypatch):
    p = tmp_path / "d.csv"
    p.write_text(CSV)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_file(str(p))
    assert import_file(str(p), device="cpu").device.type == "cpu"


def test_parquet_and_orc_bitwise(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.orc as orc
    import pyarrow.parquet as pq

    n = 300
    rng = np.random.default_rng(3)
    cats = np.array(["lo", "hi", "mid"])[rng.integers(0, 3, n)]
    xs = rng.normal(size=n).astype(np.float32)
    xs[::7] = np.nan
    table = pa.table({
        "x": pa.array(xs, type=pa.float32()),
        "g": pa.array([None if i % 11 == 0 else c
                       for i, c in enumerate(cats.tolist())]),
        "k": pa.array(rng.integers(0, 100, n), type=pa.int64()),
        "d": pa.array(cats.tolist()).dictionary_encode(),
        "ts": pa.array(np.arange(n) * 86_400_000 + 1_600_000_000_123,
                       type=pa.timestamp("ms")),
    })
    pq.write_table(table, tmp_path / "a.parquet")
    pq.write_table(table.slice(0, 50), tmp_path / "b.parquet")
    same_frame(*both(str(tmp_path / "a.parquet")))
    same_frame(*both(str(tmp_path / "*.parquet")))
    same_frame(*both(str(tmp_path / "a.parquet"),
                     col_types={"k": "enum", "d": "numeric"},
                     skipped_columns=["x"]))
    orc.write_table(table.drop_columns(["d"]), str(tmp_path / "t.orc"))
    same_frame(*both(str(tmp_path / "t.orc")))


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_bitwise(tmp_path, codec):
    _write_avro(tmp_path / "a1.avro", _SCHEMA, _rows(40, seed=1),
                codec=codec)
    _write_avro(tmp_path / "a2.avro", _SCHEMA, _rows(25, seed=2),
                codec=codec)
    same_frame(*both(str(tmp_path / "a1.avro")))
    same_frame(*both(str(tmp_path / "a*.avro"), skipped_columns=["s"]))


def test_svmlight_bitwise(tmp_path):
    p = tmp_path / "t.svm"
    p.write_text("1 1:0.5 3:2.0 # c\n0 2:1.5\n-1 1:-1.0 2:0.25 3:3.5\n\n")
    same_frame(*both(str(p)))
    q = tmp_path / "ranktrain"
    q.write_text("2 qid:1 1:1.0\n1 qid:1 2:2.0\n0 qid:2 1:0.5 2:0.5\n")
    same_frame(*both(str(q)))
    bad = tmp_path / "bad.svm"
    bad.write_text("1 3:1.0 2:0.5\n")
    for imp in (lambda: import_file(str(bad), device=DEV),
                lambda: h2o.import_file(str(bad))):
        with pytest.raises(ValueError, match="non-increasing"):
            imp()


def test_arff_bitwise(tmp_path):
    (tmp_path / "w.arff").write_text(ARFF_DOC)
    (tmp_path / "v.arff").write_text(ARFF_DOC)
    same_frame(*both(str(tmp_path / "w.arff")))
    same_frame(*both(str(tmp_path / "*.arff")))
    (tmp_path / "noext.dat").write_text(ARFF_DOC)
    same_frame(*both(str(tmp_path / "noext.dat")))


# -- a GBM on an imported CSV with a time column and enums -------------------

def _write_train_csv(path, rows, seed):
    rng = np.random.default_rng(seed)
    t = 1_500_000_000_000 + 1000 * rng.integers(0, 3 * 10 ** 7, rows)
    x = rng.normal(size=rows)
    g = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, rows)]
    logit = 1.5 * x + (t - 1.515e12) / 1e10 + (g == "b") - 0.5 * (g == "d")
    y = np.where(rng.random(rows) < 1 / (1 + np.exp(-logit)), "yes", "no")
    stamp = np.datetime_as_string(t.astype("datetime64[ms]"), unit="s")
    with open(path, "w") as f:
        f.write("when,x,g,z,y\n")
        for i in range(rows):
            xi = "" if i % 29 == 0 else f"{x[i]:.6g}"
            f.write(f"{stamp[i].replace('T', ' ')},{xi},{g[i]},"
                    f"{rng.normal():.4g},{y[i]}\n")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("gbm") / "train.csv")
    _write_train_csv(p, 4096, seed=8)
    est = dict(ntrees=3, max_depth=3, learn_rate=0.2, seed=1)
    with use_mesh(make_mesh(n_rows=1)):
        jf = h2o.import_file(p)
        tf = import_file(p, device=DEV)
        jm = JGBM(**est).train(y="y", training_frame=jf)
    tm = GBM(**est).train(y="y", training_frame=tf)
    stats, binned = round_stats(tm, tf, "y", {})
    return dict(tf=tf, jf=jf, tm=tm, jm=jm,
                walk=walk(tm, jm, stats, binned))


def test_gbm_on_an_imported_time_column(trained):
    tf, jf = trained["tf"], trained["jf"]
    same_frame(tf, jf)
    assert tf["when"].kind == "time"
    assert "when" in trained["tm"].feature_names
    compared, ties, gaps = trained["walk"]
    assert compared >= 15 and len(ties) <= 2, (compared, ties)
    assert gaps.max() <= 1e-5, gaps.max()
    th = trained["tm"].scoring_history[-1]
    jh = trained["jm"].scoring_history[-1]
    if not ties:
        for k in ("train_auc", "train_logloss"):
            assert abs(th[k] - jh[k]) <= 1e-5, (k, th[k], jh[k])
