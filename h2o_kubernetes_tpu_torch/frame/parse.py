"""Ingest: CSV (and friends) -> Frame.

The JAX package's parser, copied (it imports no JAX) and rewired to the
port's Frame. A host-side two-pass parse: a preview pass infers
per-column types as the reference's ParseSetup does, then a typed bulk
read materialises host columns, and ``import_file`` moves the finished
frame to its device in one copy per column. The vocab is built once on
the host and only int32 codes reach the device.

Supported: separator sniffing, header detection, NA-token handling,
gz/bz2/xz transparently, globs and directories (multi-file import is
concatenated in name order), and explicit per-column type overrides
(col_types) mirroring h2o.import_file. Formats: CSV, ARFF, Parquet/ORC
(pyarrow), Avro (stdlib container reader), SVMLight/LIBSVM.

CSV takes one of two host paths that give the same frame: pyarrow's
streamed reader where ``_arrow_csv_eligible`` allows it (main thread,
``H2O_TPU_ARROW_CSV`` not 0, pyarrow importable), else the pure-Python
reader, which defines the parse semantics; a file arrow rejects is
re-parsed there. A frame parsed from CSV names the path that ran in
``Frame.csv_path`` ("arrow" or "python").
"""

from __future__ import annotations

import bz2
import glob as globlib
import gzip
import io
import itertools
import lzma
import os
from typing import Mapping, Sequence

import numpy as np

from .. import config
from ..runtime.backend import resolve_device
from .frame import NA_ENUM, Frame, Vec, _factorize

# every column is built on the host; import_file moves the frame
_HOST = "cpu"

# the reference's default NA tokens (water/parser/ParseSetup) plus pandas'
_NA_TOKENS = {"", "na", "n/a", "nan", "null", "none", "-", "?",
              "#n/a", "#na", "1.#qnan", "-nan", "-1.#qnan"}

_SEPS = [",", "\t", ";", "|", " "]

_PREVIEW_ROWS = 1000


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8",
                                errors="replace")
    if path.endswith(".bz2"):
        return io.TextIOWrapper(bz2.open(path, "rb"), encoding="utf-8",
                                errors="replace")
    if path.endswith((".xz", ".lzma")):
        return io.TextIOWrapper(lzma.open(path, "rb"), encoding="utf-8",
                                errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace", newline="")


def _expand_paths(path: str | Sequence[str]) -> list[str]:
    if isinstance(path, (list, tuple)):
        out: list[str] = []
        for p in path:
            out.extend(_expand_paths(p))
        return out
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if not f.startswith("."))
    if any(c in path for c in "*?["):
        hits = sorted(globlib.glob(path))
        if not hits:
            raise FileNotFoundError(path)
        return hits
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return [path]


def _sniff_sep(lines: list[str]) -> str:
    """Pick the separator that yields the most consistent column count > 1
    (ParseSetup's separator guess)."""
    best, best_score = ",", -1
    for sep in _SEPS:
        counts = [len(_split_line(ln, sep)) for ln in lines if ln.strip()]
        if not counts:
            continue
        mode = max(set(counts), key=counts.count)
        if mode < 2:
            continue
        score = counts.count(mode) * mode
        if score > best_score:
            best, best_score = sep, score
    return best


def _read_records(f, limit: int | None = None):
    """Yield logical CSV records, joining physical lines while inside an
    unterminated double-quoted field (multi-line cells)."""
    count = 0
    buf: list[str] = []
    for ln in f:
        buf.append(ln)
        joined = "".join(buf)
        if joined.count('"') % 2 == 1:
            continue  # quote still open → record spans to next line
        buf = []
        if not joined.strip():
            continue
        yield joined
        count += 1
        if limit is not None and count >= limit:
            return
    if buf and "".join(buf).strip():
        yield "".join(buf)


def _split_line(line: str, sep: str) -> list[str]:
    """Split one CSV record honoring double-quote quoting."""
    if '"' not in line:
        return line.rstrip("\r\n").split(sep)
    out, cur, inq = [], [], False
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if inq:
            if c == '"':
                if i + 1 < n and line[i + 1] == '"':
                    cur.append('"'); i += 1
                else:
                    inq = False
            else:
                cur.append(c)
        elif c == '"':
            inq = True
        elif c == sep:
            out.append("".join(cur)); cur = []
        elif c not in "\r\n":
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def _is_na(tok: str, na_strings: set[str]) -> bool:
    return tok.strip().lower() in na_strings


def _try_float(tok: str) -> float | None:
    try:
        return float(tok)
    except ValueError:
        return None


def _infer_col_type(vals: list[str], na_strings: set[str]) -> str:
    """ParseSetup-style vote over preview values: numeric if every non-NA
    token parses as a number; time if they parse as dates; else enum."""
    nnum = ntime = nother = 0
    for tok in vals:
        if _is_na(tok, na_strings):
            continue
        if _try_float(tok) is not None:
            nnum += 1
        elif _parse_time_ms(tok) is not None:
            ntime += 1
        else:
            nother += 1
    if nother == 0 and ntime > 0 and nnum == 0:
        return "time"
    if nother == 0 and ntime == 0 and nnum > 0:
        return "numeric"
    if nnum + ntime + nother == 0:
        return "numeric"  # all-NA column
    return "enum"


_TIME_FORMATS = ["%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d",
                 "%m/%d/%Y", "%d-%b-%y", "%Y%m%d"]


def _parse_time_ms(tok: str) -> float | None:
    tok = tok.strip()
    if not tok or tok[0] not in "0123456789":
        return None
    import datetime as dt
    for fmt in _TIME_FORMATS:
        try:
            d = dt.datetime.strptime(tok, fmt)
            return d.replace(tzinfo=dt.timezone.utc).timestamp() * 1000.0
        except ValueError:
            continue
    return None


def _header_vote(rows: list[list[str]], na_strings: set[str]) -> bool:
    """ParseSetup-style header heuristic: row 1 must be all non-numeric;
    then either the body has numbers (type break) or, for all-string data,
    row-1 labels are unique and never recur in their own columns."""
    first = rows[0]
    if any(_try_float(t) is not None for t in first):
        return False
    body = rows[1:]
    if not body:
        return True
    if any(_try_float(t) is not None for r in body for t in r
           if not _is_na(t, na_strings)):
        return True
    # all-string dataset: column labels are unique and don't repeat below
    if len(set(first)) != len(first):
        return False
    for c, label in enumerate(first):
        if any(c < len(r) and r[c] == label for r in body):
            return False
    return True


def parse_setup(path: str | Sequence[str], sep: str | None = None,
                header: int = -1,
                na_strings: Sequence[str] | None = None) -> dict:
    """Preview pass → {files, sep, header, names, types} (the /3/ParseSetup
    analog). `header`: -1 auto, 0 none, 1 forced."""
    files = _expand_paths(path)
    nas = set(_NA_TOKENS if na_strings is None
              else [s.lower() for s in na_strings])
    with _open_text(files[0]) as f:
        lines = list(_read_records(f, limit=_PREVIEW_ROWS))
    if not lines:
        raise ValueError(f"{files[0]}: empty file")
    if sep is None:
        sep = _sniff_sep(lines[:50])
    rows = [_split_line(ln, sep) for ln in lines]
    has_header = bool(header) if header >= 0 else _header_vote(rows, nas)
    if has_header:
        ncol = len(rows[0])
    else:  # modal column count over the preview (ParseSetup vote)
        counts = [len(r) for r in rows]
        ncol = max(set(counts), key=counts.count)
    names = (rows[0] if has_header else [f"C{i+1}" for i in range(ncol)])
    body = rows[1:] if has_header else rows
    types = []
    for c in range(ncol):
        vals = [r[c] for r in body if c < len(r)]
        types.append(_infer_col_type(vals, nas))
    return {"files": files, "sep": sep, "header": has_header,
            "names": names, "types": types, "na_strings": nas}


_PARQUET_MAGIC = b"PAR1"
_ORC_MAGIC = b"ORC"
_AVRO_MAGIC = b"Obj\x01"


def _binary_format(path: str) -> str | None:
    """Sniff columnar binary formats by magic bytes (the reference's
    parser provider detection, water/parser GuessParserSetup [U3])."""
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except (OSError, IsADirectoryError):
        return None
    if head == _PARQUET_MAGIC:
        return "parquet"
    if head[:3] == _ORC_MAGIC:
        return "orc"
    if head == _AVRO_MAGIC:
        return "avro"
    return None


def _import_arrow(files: list[str], fmt: str,
                  col_types: Mapping[str, str] | None,
                  skipped: set[str]) -> Frame:
    """Parquet/ORC ingest via pyarrow (h2o-parsers/h2o-parquet-parser
    analog): host-side columnar read → typed numpy → host columns
    columns. Arrow dictionary columns keep their vocab as the enum
    domain; timestamps become time Vecs (epoch ms)."""
    import pyarrow as pa

    if fmt == "parquet":
        import pyarrow.parquet as pq
        tables = [pq.read_table(f) for f in files]
    else:
        from pyarrow import orc
        tables = [orc.ORCFile(f).read() for f in files]
    table = tables[0] if len(tables) == 1 else pa.concat_tables(
        tables, promote_options="default")

    overrides = dict(col_types or {}) if isinstance(col_types, Mapping) \
        else {}
    cols: dict[str, Vec] = {}
    for name in table.column_names:
        if name in skipped:
            continue
        col = table.column(name).combine_chunks()
        t = col.type
        want = _norm_type(overrides[name]) if name in overrides else None
        if pa.types.is_dictionary(t):
            codes = col.indices.to_numpy(zero_copy_only=False).astype(
                np.float64)          # nulls → NaN before int cast
            null = np.asarray(col.is_null())
            codes = np.where(null, -1, np.nan_to_num(codes, nan=-1))
            dom = [str(v) for v in col.dictionary.to_pylist()]
            v = _host_vec(codes.astype(np.int32), name, domain=dom)
        elif pa.types.is_timestamp(t) or pa.types.is_date(t):
            ms = col.cast(pa.timestamp("ms")).to_numpy(
                zero_copy_only=False)
            v = _host_vec(ms, name)   # datetime64 → time kind
        elif pa.types.is_string(t) or pa.types.is_large_string(t) or \
                pa.types.is_binary(t):
            arr = np.asarray(col.to_pylist(), dtype=object)
            codes, dom = _factorize(arr)
            v = _host_vec(codes, name, domain=dom)
        else:
            a = col.to_numpy(zero_copy_only=False).astype(np.float64)
            v = _host_vec(a.astype(np.float32), name)
        if want == "enum" and not v.is_enum():
            v = v.asfactor()
        elif want == "numeric" and v.is_enum():
            v = v.asnumeric()
        cols[name] = v
    return Frame(cols)


# -- Avro (h2o-parsers/h2o-avro-parser analog [U3]) --------------------------
#
# Stdlib-only reader for the Avro Object Container File format: header
# (magic + metadata map carrying the writer schema JSON + codec), then
# sync-delimited blocks of binary-encoded records. Covers the tabular
# subset the reference's parser ingests: records of primitive fields
# (boolean/int/long/float/double/string/bytes), enums, and nullable
# unions [null, primitive]; codecs null and deflate; logicalType
# timestamp-millis -> time column.

class _AvroReader:
    def __init__(self, buf: bytes):
        self.b = buf
        self.i = 0

    def read(self, n: int) -> bytes:
        out = self.b[self.i:self.i + n]
        if len(out) < n:
            raise ValueError("truncated avro data")
        self.i += n
        return out

    def long(self) -> int:
        """Zig-zag varint (avro int and long share the encoding)."""
        shift, acc = 0, 0
        while True:
            if self.i >= len(self.b):
                raise ValueError("truncated avro data")
            byte = self.b[self.i]
            self.i += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8", errors="replace")

    def at_end(self) -> bool:
        return self.i >= len(self.b)


def _avro_decode(r: _AvroReader, schema):
    """Decode ONE value of `schema` (parsed JSON) from the stream."""
    if isinstance(schema, list):            # union: index then branch
        idx = r.long()
        if not 0 <= idx < len(schema):
            raise ValueError(f"avro union index {idx} out of range")
        return _avro_decode(r, schema[idx])
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: _avro_decode(r, f["type"])
                    for f in schema["fields"]}
        if t == "enum":
            idx = r.long()
            syms = schema["symbols"]
            if not 0 <= idx < len(syms):
                raise ValueError(f"avro enum index {idx} out of range")
            return syms[idx]
        if t in ("int", "long", "float", "double", "string", "bytes",
                 "boolean", "null"):
            return _avro_decode(r, t)
        if t == "array" or t == "map" or t == "fixed":
            raise ValueError(
                f"avro type '{t}' is not tabular; flatten it upstream")
        raise ValueError(f"unsupported avro type {t!r}")
    if schema == "null":
        return None
    if schema == "boolean":
        return r.read(1)[0] != 0
    if schema in ("int", "long"):
        return r.long()
    if schema == "float":
        import struct

        return struct.unpack("<f", r.read(4))[0]
    if schema == "double":
        import struct

        return struct.unpack("<d", r.read(8))[0]
    if schema == "bytes":
        return r.bytes_()
    if schema == "string":
        return r.string()
    raise ValueError(f"unsupported avro type {schema!r}")


def _avro_field_kind(ftype) -> str:
    """numeric | time | enum | bool for a field schema (unions unwrap)."""
    if isinstance(ftype, list):
        branches = [b for b in ftype if b != "null"]
        if len(branches) != 1:
            raise ValueError(f"unsupported avro union {ftype!r}")
        return _avro_field_kind(branches[0])
    if isinstance(ftype, dict):
        if ftype.get("logicalType") in ("timestamp-millis",
                                        "timestamp-micros"):
            return "time-" + ftype["logicalType"]
        if ftype["type"] == "enum":
            return "enum"
        return _avro_field_kind(ftype["type"])
    if ftype in ("int", "long", "float", "double"):
        return "numeric"
    if ftype == "boolean":
        return "bool"
    if ftype in ("string", "bytes"):
        return "str"
    raise ValueError(f"unsupported avro field type {ftype!r}")


def _import_avro(files: list[str], skipped: set[str]) -> Frame:
    import json as jsonlib
    import zlib

    names: list[str] = []
    schema = None
    cols: dict[str, list] = {}
    for fi, fp in enumerate(files):
        with open(fp, "rb") as f:
            r = _AvroReader(f.read())
        if r.read(4) != _AVRO_MAGIC:
            raise ValueError(f"{fp}: not an avro container file")
        meta: dict[str, bytes] = {}
        while True:                      # metadata map, possibly chunked
            n = r.long()
            if n == 0:
                break
            if n < 0:                    # negative count prefixes a size
                n = -n
                r.long()
            for _ in range(n):
                # two statements: Python evaluates an assignment's RHS
                # first, which would read the value bytes before the key
                key = r.string()
                meta[key] = r.bytes_()
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise ValueError(f"{fp}: unsupported avro codec '{codec}'")
        fschema = jsonlib.loads(meta["avro.schema"].decode())
        if not (isinstance(fschema, dict) and
                fschema.get("type") == "record"):
            raise ValueError(f"{fp}: top-level avro schema must be a "
                             "record")
        if fi == 0:
            schema = fschema
            names = [f["name"] for f in schema["fields"]]
            cols = {n: [] for n in names}
        elif fschema["fields"] != schema["fields"]:
            # FULL field equality (names + types + enum symbol order):
            # decoding a later file's blocks against a different writer
            # schema would read varints as doubles / remap enum codes
            # silently
            raise ValueError(f"{fp}: avro schema differs from {files[0]}")
        sync = r.read(16)
        while not r.at_end():
            count = r.long()
            blk = r.bytes_()
            if codec == "deflate":
                blk = zlib.decompress(blk, -15)
            br = _AvroReader(blk)
            for _ in range(count):
                rec = _avro_decode(br, schema)
                for n in names:
                    cols[n].append(rec[n])
            if r.read(16) != sync:
                raise ValueError(f"{fp}: avro sync marker mismatch")

    vecs: dict[str, Vec] = {}
    for fld in schema["fields"]:
        name = fld["name"]
        if name in skipped:
            continue
        kind = _avro_field_kind(fld["type"])
        vals = cols[name]
        if kind == "numeric" or kind == "bool":
            arr = np.array([np.nan if v is None else float(v)
                            for v in vals], dtype=np.float32)
            vecs[name] = _host_vec(arr, name)
        elif kind.startswith("time-"):
            scale = 1.0 if kind.endswith("millis") else 1e-3
            arr = np.array([np.nan if v is None else float(v) * scale
                            for v in vals], dtype=np.float64)
            vecs[name] = _host_vec(arr, name, kind="time")
        elif kind == "enum":
            dom = _avro_enum_symbols(fld["type"])
            pos = {s: i for i, s in enumerate(dom)}
            codes = np.array([NA_ENUM if v is None else pos[v]
                              for v in vals], dtype=np.int32)
            vecs[name] = _host_vec(codes, name, domain=dom)
        else:                                  # str/bytes -> interned enum
            # intern directly: None must become NA without hijacking a
            # genuine empty-string level (union [null, string] columns
            # routinely carry both)
            lut: dict[str, int] = {}
            codes = np.empty(len(vals), dtype=np.int32)
            for i, v in enumerate(vals):
                if v is None:
                    codes[i] = NA_ENUM
                    continue
                tok = (v.decode("utf-8", errors="replace")
                       if isinstance(v, bytes) else str(v))
                codes[i] = lut.setdefault(tok, len(lut))
            vecs[name] = _lut_to_vec(codes, lut, name)
    return Frame(vecs)


def _avro_enum_symbols(ftype) -> list[str]:
    if isinstance(ftype, list):
        ftype = [b for b in ftype if b != "null"][0]
    return list(ftype["symbols"])


# -- SVMLight (water/parser/SVMLightParser analog [U3]) ----------------------

def _svmlight_line_ok(s: str) -> int:
    """-1 if the line does not conform; else its idx:val pair count."""
    toks = s.split()
    if len(toks) < 2 or _try_float(toks[0]) is None:
        return -1
    pairs = toks[1:]
    if pairs and pairs[0].startswith("qid:"):
        pairs = pairs[1:]
    if not pairs:
        return -1
    last = 0
    for p in pairs:
        idx, _, val = p.partition(":")
        if not idx.isdigit() or _try_float(val) is None:
            return -1
        if int(idx) <= last:
            return -1
        last = int(idx)
    return len(pairs)


def _looks_svmlight(path: str) -> bool:
    """Content sniff for EXTENSIONLESS files: every previewed
    non-comment line must be `label [qid:q] i:v ...` with strictly
    increasing indices, AND at least one line must carry >= 2 pairs.
    The second condition keeps generic space-separated data whose rows
    happen to look like `3 08:30` (count + clock time) out of the
    svmlight parser — a real one-pair-per-row svmlight file is still
    importable via its .svm/.svmlight extension."""
    try:
        with _open_text(path) as f:
            seen = 0
            max_pairs = 0
            for ln in f:
                s = ln.split("#", 1)[0].strip()
                if not s:
                    continue
                n = _svmlight_line_ok(s)
                if n < 0:
                    return False
                max_pairs = max(max_pairs, n)
                seen += 1
                if seen >= 32:
                    break
            return seen > 0 and max_pairs >= 2
    except OSError:
        return False


def _import_svmlight(files: list[str], skipped: set[str]) -> Frame:
    """SVMLight/LIBSVM ingest: `label [qid:q] idx:val ... [# comment]`.

    1-based feature indices become columns C2..C{d+1} with the label in
    C1 (the reference's SVMLightParser layout); absent entries are 0
    (sparse semantics, NOT NA). An optional qid column is kept for
    ranking objectives (XGBoost group_column)."""
    labels: list[float] = []
    qids: list[float] = []
    entries: list[tuple[int, int, float]] = []   # (row, col0, val)
    has_qid = False
    max_idx = 0
    row = 0
    for fp in files:
        with _open_text(fp) as f:
            for lineno, ln in enumerate(f, start=1):
                s = ln.split("#", 1)[0].strip()
                if not s:
                    continue
                toks = s.split()
                lab = _try_float(toks[0])
                if lab is None:
                    raise ValueError(
                        f"{fp}:{lineno}: bad svmlight label "
                        f"'{toks[0]}'")
                labels.append(lab)
                pairs = toks[1:]
                qid = np.nan
                if pairs and pairs[0].startswith("qid:"):
                    q = _try_float(pairs[0][4:])
                    if q is None:
                        raise ValueError(
                            f"{fp}:{lineno}: bad qid "
                            f"'{pairs[0]}'")
                    qid = q
                    has_qid = True
                    pairs = pairs[1:]
                qids.append(qid)
                last = 0
                for p in pairs:
                    idx_s, _, val_s = p.partition(":")
                    v = _try_float(val_s)
                    if not idx_s.isdigit() or v is None:
                        raise ValueError(
                            f"{fp}:{lineno}: bad svmlight pair '{p}'")
                    idx = int(idx_s)
                    if idx <= last:
                        # out-of-order/duplicate indices would silently
                        # overwrite; the reference rejects them too
                        raise ValueError(
                            f"{fp}:{lineno}: non-increasing feature "
                            f"index {idx}")
                    last = idx
                    max_idx = max(max_idx, idx)
                    entries.append((row, idx - 1, v))
                row += 1
    # the Frame model is dense float32 columns, so an SVMLight import
    # materializes rows x max_index cells no matter how sparse the file
    # is — cap it so a 1M-feature text corpus raises a clear error
    # instead of a ~400GB allocation attempt
    budget = config.svmlight_dense_budget()
    if row * max_idx > budget:
        raise ValueError(
            f"svmlight file would densify to {row} rows x {max_idx} "
            f"features = {row * max_idx:,} cells (> budget {budget:,}); "
            "this frame store is dense — reduce the feature space or "
            "raise H2O_TPU_SVMLIGHT_DENSE_BUDGET if you really have "
            "the memory")
    X = np.zeros((row, max_idx), dtype=np.float32)
    if entries:
        e = np.array(entries)
        X[e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)] = e[:, 2]
    vecs: dict[str, Vec] = {}
    if "C1" not in skipped:
        vecs["C1"] = _host_vec(
            np.asarray(labels, dtype=np.float32), "C1")
    if has_qid and "qid" not in skipped:
        vecs["qid"] = _host_vec(
            np.asarray(qids, dtype=np.float32), "qid")
    for j in range(max_idx):
        name = f"C{j + 2}"
        if name in skipped:
            continue
        vecs[name] = _host_vec(X[:, j], name)
    return Frame(vecs)


def _looks_arff(path: str) -> bool:
    """Content sniff: first non-comment line starts with @relation."""
    try:
        with _open_text(path) as f:
            for ln in f:
                s = ln.strip()
                if not s or s.startswith("%"):
                    continue
                return s.lower().startswith("@relation")
    except OSError:
        return False
    return False


def _arff_split(line: str) -> list[str]:
    """Split an ARFF record on commas honoring ARFF quoting: values may
    be SINGLE- or double-quoted (ARFF convention is single quotes, which
    the CSV splitter ignores — a domain like {'a,b','c'} or a quoted
    data token containing a comma would mis-split), with backslash
    escapes inside quotes. Quotes are removed and bare tokens stripped."""
    out: list[str] = []
    cur: list[str] = []
    q: str | None = None
    close_at: int | None = None   # cur length when the quote closed
    i, n = 0, len(line)

    def flush():
        if close_at is None:
            out.append("".join(cur).strip())
        else:
            # quoted fields keep inner spaces verbatim; whitespace
            # AFTER the closing quote is separator padding, not content
            out.append("".join(cur[:close_at])
                       + "".join(cur[close_at:]).strip())

    while i < n:
        c = line[i]
        if q is not None:
            if c == "\\" and i + 1 < n:
                cur.append(line[i + 1])
                i += 2
                continue
            if c == q:
                q = None
                close_at = len(cur)
            else:
                cur.append(c)
        elif c in "'\"" and not "".join(cur).strip():
            # a quote only OPENS a field at its (whitespace-trimmed)
            # start; mid-token apostrophes (don't) stay literal
            cur = []                  # drop leading spaces before quote
            q = c
        elif c == ",":
            flush()
            cur = []
            close_at = None
        elif c not in "\r\n":
            cur.append(c)
        i += 1
    if q is not None:
        # silently closing would corrupt the token and swallow commas
        raise ValueError(f"unterminated {q} quote in ARFF record: "
                         f"{line[:80]!r}")
    flush()
    return out


def _import_arff(files: list[str], skipped: set[str]) -> Frame:
    """ARFF ingest (h2o-parsers ARFF parser analog [U3]): @attribute
    declarations give names AND types — numeric/real/integer,
    {nominal,...} with the DECLARED level order kept (unlike CSV enum
    inference, which sorts), string (interned like nominal), date
    (epoch-ms time column). '?' is NA. Dense rows only; the sparse
    `{i v, ...}` form is rejected loudly."""
    names: list[str] = []
    types: list[str | list[str]] = []
    raw: list[list[str]] = []
    for fi, fp in enumerate(files):
        in_data = False
        f_names: list[str] = []
        f_types: list[str | list[str]] = []
        with _open_text(fp) as f:
            for lineno, ln in enumerate(f, start=1):
                s = ln.strip()
                if not s or s.startswith("%"):
                    continue
                low = s.lower()
                if not in_data:
                    if low.startswith("@relation"):
                        continue
                    if low.startswith("@attribute"):
                        body = s[len("@attribute"):].strip()
                        if body.startswith(("'", '"')):
                            q = body[0]
                            end = body.find(q, 1)
                            if end < 0:
                                raise ValueError(
                                    f"{fp}:{lineno}: unterminated "
                                    f"quoted attribute name '{s}'")
                            aname = body[1:end]
                            atype = body[end + 1:].strip()
                        else:
                            parts = body.split(None, 1)
                            if len(parts) != 2:
                                raise ValueError(
                                    f"{fp}:{lineno}: malformed "
                                    f"@attribute '{s}'")
                            aname, atype = parts
                        if atype.startswith("{"):
                            try:
                                dom = _arff_split(atype.strip("{}"))
                            except ValueError as e:
                                raise ValueError(
                                    f"{fp}:{lineno}: {e}") from None
                            f_types.append(dom)
                        else:
                            t = atype.split()[0].lower()
                            if t in ("numeric", "real", "integer"):
                                f_types.append("numeric")
                            elif t == "string":
                                f_types.append("string")
                            elif t == "date":
                                f_types.append("time")
                            else:
                                raise ValueError(
                                    f"{fp}:{lineno}: unsupported ARFF "
                                    f"type '{atype}'")
                        f_names.append(aname)
                        continue
                    if low.startswith("@data"):
                        if fi == 0:
                            names, types = f_names, f_types
                            raw = [[] for _ in names]
                        elif f_names != names or f_types != types:
                            # a type mismatch silently materializing
                            # under the first file's types would turn
                            # nominal tokens into NaNs
                            raise ValueError(
                                f"{fp}: ARFF attributes differ from "
                                f"{files[0]}")
                        in_data = True
                        continue
                    raise ValueError(
                        f"{fp}:{lineno}: unexpected ARFF line '{s}'")
                else:
                    if s.startswith("{"):
                        raise ValueError(
                            f"{fp}:{lineno}: sparse ARFF rows are not "
                            "supported")
                    try:
                        toks = _arff_split(s)
                    except ValueError as e:
                        raise ValueError(f"{fp}:{lineno}: {e}") from None
                    if len(toks) != len(names):
                        raise ValueError(
                            f"{fp}:{lineno}: {len(toks)} values, "
                            f"expected {len(names)}")
                    for c, t in enumerate(toks):
                        raw[c].append(t)
        if not in_data:
            raise ValueError(f"{fp}: no @data section")
    vecs: dict[str, Vec] = {}
    for c, (name, typ) in enumerate(zip(names, types)):
        if name in skipped:
            continue
        if isinstance(typ, list):          # declared nominal domain
            pos = {d: i for i, d in enumerate(typ)}
            codes = np.empty(len(raw[c]), dtype=np.int32)
            for i, tok in enumerate(raw[c]):
                if tok == "?" or tok == "":
                    codes[i] = -1
                elif tok in pos:
                    codes[i] = pos[tok]
                else:
                    raise ValueError(
                        f"'{tok}' not in declared domain of '{name}'")
            vecs[name] = _host_vec(codes, name, domain=list(typ))
        elif typ == "string":
            vecs[name] = _materialize(raw[c], "enum", name, {"?", ""})
        else:
            vecs[name] = _materialize(raw[c], typ, name, {"?", ""})
    return Frame(vecs)


def import_file(path: str | Sequence[str], sep: str | None = None,
                header: int = -1, col_names: Sequence[str] | None = None,
                col_types: Mapping[str, str] | Sequence[str] | None = None,
                na_strings: Sequence[str] | None = None,
                skipped_columns: Sequence[str] | None = None,
                device=None) -> Frame:
    """h2o.import_file analog: parse CSV/Parquet/ORC/Avro/SVMLight/ARFF
    file(s) into a Frame on ``device`` (None = the CUDA card; raises
    without one unless ``device="cpu"``). The format is sniffed per file
    set, like the reference's parser-provider guess. On a row group
    every rank parses the whole file on its host, then keeps its row
    shard."""
    from ..runtime.mesh import RowGroup, n_row_shards, use_mesh

    dev = resolve_device(device)
    with use_mesh(RowGroup()):          # the host frame is whole
        host = _import_host(path, sep, header, col_names, col_types,
                            na_strings, skipped_columns)
    if n_row_shards() == 1:
        out = host._to(dev)
    else:
        out = Frame({n: Vec.from_numpy(v.to_numpy(), n, domain=v.domain,
                                       kind=v.kind, device=dev)
                     for n, v in host._vecs.items()})
    out.csv_path = host.csv_path
    return out


def _host_vec(x, name: str = "", domain=None, kind: str | None = None
              ) -> Vec:
    return Vec.from_numpy(x, name, domain=domain, kind=kind, device=_HOST)


def _import_host(path, sep, header, col_names, col_types, na_strings,
                 skipped_columns) -> Frame:
    """``import_file``'s parse, every column on the host."""
    files = _expand_paths(path)
    fmt = _binary_format(files[0])
    if fmt == "avro":
        return _import_avro(files, set(skipped_columns or []))
    if fmt is not None:
        return _import_arrow(files, fmt,
                             col_types if isinstance(col_types, Mapping)
                             else None, set(skipped_columns or []))
    base = files[0].lower()
    for z in (".gz", ".bz2", ".xz"):
        if base.endswith(z):
            base = base[: -len(z)]
    if base.endswith(".arff") or _looks_arff(files[0]):
        return _import_arff(files, set(skipped_columns or []))
    if base.endswith((".svm", ".svmlight", ".libsvm")) or \
            _looks_svmlight(files[0]):
        return _import_svmlight(files, set(skipped_columns or []))
    setup = parse_setup(path, sep=sep, header=header, na_strings=na_strings)
    # copy: uniquification below must not leak into setup["names"], which
    # later files' first records are compared against verbatim
    names = list(col_names) if col_names else list(setup["names"])
    # uniquify duplicate headers like the reference parser (a, a -> a, a2)
    # instead of silently collapsing same-named columns into one dict key
    seen: dict[str, int] = {}
    for i, n in enumerate(names):
        if n in seen:
            while True:          # walk past real headers like a2
                seen[n] += 1
                cand = f"{n}{seen[n]}"
                if cand not in names and cand not in seen:
                    break
            names[i] = cand
        seen.setdefault(names[i], 1)
    types = list(setup["types"])
    if col_types:
        if isinstance(col_types, Mapping):
            for n, t in col_types.items():
                types[names.index(n)] = _norm_type(t)
        else:
            types = [_norm_type(t) for t in col_types]
    skipped = set(skipped_columns or [])
    nas = setup["na_strings"]
    ncol = len(names)

    if _arrow_csv_eligible(setup, names, types):
        try:
            frame = _import_csv_arrow(setup, names, types, skipped)
            frame.csv_path = "arrow"
            return frame
        except Exception:
            # the pure-Python path below DEFINES the parse semantics;
            # anything arrow rejects (ragged rows, unparseable floats,
            # exotic quoting) re-parses there
            pass

    raw: list[list[str]] = [[] for _ in range(ncol)]
    for fi, fp in enumerate(setup["files"]):
        with _open_text(fp) as f:
            it = _read_records(f)
            if setup["header"]:
                if fi == 0:
                    next(it, None)
                else:
                    # later files in a multi-file parse may be headerless
                    # continuations: only drop the first record when it
                    # repeats the header (the reference checks each file's
                    # first line against the ParseSetup columns)
                    first = next(it, None)
                    if first is not None:
                        toks = _split_line(first, setup["sep"])
                        if [t.strip() for t in toks] != setup["names"]:
                            it = itertools.chain([first], it)
            for lineno, ln in enumerate(it, start=1):
                toks = _split_line(ln, setup["sep"])
                if len(toks) != ncol:
                    # fail loudly like ParseDataset on column-count
                    # breaks — BOTH directions: a short row is how a
                    # stream truncated mid-record presents, and
                    # silently padding it with NAs would ship a
                    # corrupted frame (tools/chaos.py
                    # ingest-truncated-csv rehearses exactly this)
                    raise ValueError(
                        f"{fp}:{lineno}: {len(toks)} columns, expected "
                        f"{ncol}")
                for c in range(ncol):
                    raw[c].append(toks[c])

    vecs: dict[str, Vec] = {}
    for c, (name, typ) in enumerate(zip(names, types)):
        if name in skipped:
            continue
        vecs[name] = _materialize(raw[c], typ, name, nas)
    frame = Frame(vecs)
    frame.csv_path = "python"
    return frame


class _EnumAcc:
    """Streaming categorical interner: per-batch dictionary-encoded
    chunks remapped through a growing first-seen LUT of STRIPPED
    tokens; finalize() sorts the domain and remaps once — exactly the
    strip + lowercase-NA + sorted-domain semantics of the pure-Python
    `_materialize`, paid per batch dictionary (small) instead of per
    row."""

    def __init__(self, nas: set[str]):
        self.nas = nas
        self.lut: dict[str, int] = {}
        self.chunks: list[np.ndarray] = []

    def add(self, col) -> None:
        enc = col.dictionary_encode()
        codes = np.nan_to_num(
            enc.indices.to_numpy(zero_copy_only=False).astype(
                np.float64), nan=-1).astype(np.int64)
        remap = np.empty(len(enc.dictionary) + 1, dtype=np.int32)
        remap[-1] = NA_ENUM
        for old, tok in enumerate(enc.dictionary.to_pylist()):
            tok = str(tok).strip()
            if tok.lower() in self.nas:
                remap[old] = NA_ENUM
            else:
                remap[old] = self.lut.setdefault(tok, len(self.lut))
        self.chunks.append(remap[codes])

    def finalize(self, name: str) -> Vec:
        codes = np.concatenate(self.chunks) if self.chunks else \
            np.empty(0, dtype=np.int32)
        self.chunks = []
        return _lut_to_vec(codes, self.lut, name)


class _TimeAcc:
    """Streaming time-column parser: per-batch host parse through the
    shared _parse_time_ms formats into float64 epoch-ms chunks."""

    def __init__(self, nas: set[str]):
        self.nas = nas
        self.chunks: list[np.ndarray] = []

    def add(self, col) -> None:
        vals = col.to_pylist()
        out = np.empty(len(vals), dtype=np.float64)
        for i, v in enumerate(vals):
            tok = "" if v is None else v
            ms = None if _is_na(tok, self.nas) else _parse_time_ms(tok)
            out[i] = np.nan if ms is None else ms
        self.chunks.append(out)

    def finalize(self, name: str) -> Vec:
        a = np.concatenate(self.chunks) if self.chunks else \
            np.empty(0, dtype=np.float64)
        self.chunks = []
        return _host_vec(a, name, kind="time")


class _NumAcc:
    def __init__(self):
        self.chunks: list[np.ndarray] = []

    def add(self, col) -> None:
        self.chunks.append(np.asarray(
            col.to_numpy(zero_copy_only=False), dtype=np.float32))

    def finalize(self, name: str) -> Vec:
        a = np.concatenate(self.chunks) if self.chunks else \
            np.empty(0, dtype=np.float32)
        self.chunks = []
        return _host_vec(a, name)


def _import_csv_arrow(setup: dict, names: list[str], types: list[str],
                      skipped: set[str]) -> Frame:
    """10M-row-capable CSV fast path, STREAMED: pyarrow's C++ CSV
    reader tokenizes and converts one record batch at a time
    (`pacsv.open_csv`), and each batch lands chunk-wise in per-column
    accumulators — host peak beyond the final typed columns is
    O(batch), never a whole-file pyarrow Table (the round-5 monolithic
    `read_csv` held the table + pylists + numpy copies at once). Our
    preview pass keeps type-inference semantics (the reference's
    analog is the chunk-parallel ParseDataset over NewChunks,
    water/parser/ [U3]). Batch bytes: H2O_TPU_INGEST_CHUNK_BYTES
    (default 16 MiB).

    Eligibility is decided by the caller; any arrow-level failure
    (ragged rows, unparseable numerics, unsupported codec — including
    a stream TRUNCATED mid-record) raises and the caller falls back to
    the pure-Python path, which defines the parse semantics and fails
    a truncated file loudly rather than shipping a short frame."""
    import pyarrow as pa
    import pyarrow.csv as pacsv

    nas = setup["na_strings"]
    # arrow null matching is exact; cover the case variants of our
    # lowercase token set (the slow path lowercases before comparing)
    null_values = sorted({v for t in nas for v in
                          (t, t.upper(), t.capitalize(), t.title())})
    col_types: dict[str, pa.DataType] = {}
    time_cols = set()
    for name, typ in zip(names, types):
        if typ == "numeric":
            col_types[name] = pa.float32()
        else:
            # enum AND time columns land as strings; time parsing uses
            # the shared _parse_time_ms formats host-side (rare columns
            # — the 10M-row cost is numeric/enum, which stay in C++)
            col_types[name] = pa.string()
            if typ == "time":
                time_cols.add(name)

    keep = [n for n in names if n not in skipped]
    acc: dict[str, object] = {}
    for name, typ in zip(names, types):
        if name in skipped:
            continue
        acc[name] = _NumAcc() if typ == "numeric" else \
            _TimeAcc(nas) if name in time_cols else _EnumAcc(nas)

    block = config.ingest_chunk_bytes()
    for fi, fp in enumerate(setup["files"]):
        # arrow's skip_rows counts PHYSICAL lines while the slow path
        # skips blank lines anywhere — count the leading blank/
        # whitespace-only lines so the header row is the one skipped
        blanks = 0
        with _open_text(fp) as f:
            for ln in f:
                if ln.strip():
                    break
                blanks += 1
        skip = blanks
        if setup["header"]:
            if fi == 0:
                skip += 1
            else:
                # later files may be headerless continuations (same
                # check as the slow path): drop the first record only
                # when it repeats the header
                with _open_text(fp) as f:
                    first = next(_read_records(f, limit=1), None)
                if first is not None and [
                        t.strip() for t in
                        _split_line(first, setup["sep"])] == setup["names"]:
                    skip += 1
        # pa.input_stream decompresses gz/bz2 by extension; xz is
        # rejected by the caller's eligibility check
        with pa.input_stream(fp, compression="detect") as stream:
            reader = pacsv.open_csv(
                stream,
                read_options=pacsv.ReadOptions(
                    column_names=names, skip_rows=skip,
                    block_size=block),
                parse_options=pacsv.ParseOptions(
                    delimiter=setup["sep"], newlines_in_values=True),
                convert_options=pacsv.ConvertOptions(
                    column_types=col_types, null_values=null_values,
                    strings_can_be_null=True,
                    quoted_strings_can_be_null=False,
                    # drop skipped columns inside the reader — at 10M
                    # rows their C++ conversion is real money
                    include_columns=keep))
            with reader:
                for batch in reader:
                    for name in keep:
                        acc[name].add(
                            batch.column(batch.schema.get_field_index(
                                name)))

    vecs: dict[str, Vec] = {}
    for name in names:
        if name in skipped:
            continue
        vecs[name] = acc.pop(name).finalize(name)
    return Frame(vecs)


def _arrow_csv_eligible(setup: dict, names: list[str],
                        types: list[str]) -> bool:
    """The fast path must only run where it reproduces the slow path's
    semantics: single-char separator, no xz/lzma (arrow can't detect
    it), pyarrow importable, and not disabled via env."""
    if not config.arrow_csv_enabled():
        return False
    # MAIN THREAD ONLY: pyarrow materialization segfaulted (flaky,
    # ~3-in-4 module runs) when this path ran inside a REST handler
    # thread on a 1-core box (tests/test_rest.py::
    # test_model_detail_fields; crash stack in _import_csv_arrow), and
    # ReadOptions(use_threads=False) did NOT cure it — so server-side
    # imports take the pure-Python parser, and the 10M-row fast reader
    # stays a Python-API (main-thread) feature. Narrowing this guard
    # needs a root cause, not another heuristic.
    import threading

    if threading.current_thread() is not threading.main_thread():
        return False
    # whitespace-only lines are records to arrow but skipped by the
    # slow path; with >= 2 columns they raise a column-count error and
    # fall back, but a 1-column frame (or space separator) would
    # silently grow NA rows instead
    if len(names) < 2 or setup["sep"] == " ":
        return False
    if len(setup["sep"]) != 1:
        return False
    if any(f.lower().endswith((".xz", ".lzma")) for f in setup["files"]):
        return False
    if len(set(names)) != len(names):
        return False
    try:
        import pyarrow.csv  # noqa: F401
    except ImportError:
        return False
    return True


def _norm_type(t: str) -> str:
    t = t.lower()
    return {"real": "numeric", "int": "numeric", "float": "numeric",
            "factor": "enum", "categorical": "enum", "string": "enum",
            }.get(t, t)


def _materialize(vals: list[str], typ: str, name: str,
                 nas: set[str]) -> Vec:
    n = len(vals)
    if typ == "numeric":
        out = np.empty(n, dtype=np.float32)
        for i, tok in enumerate(vals):
            if _is_na(tok, nas):
                out[i] = np.nan
            else:
                f = _try_float(tok)
                out[i] = np.nan if f is None else f
        return _host_vec(out, name)
    if typ == "time":
        out = np.empty(n, dtype=np.float64)
        for i, tok in enumerate(vals):
            ms = None if _is_na(tok, nas) else _parse_time_ms(tok)
            out[i] = np.nan if ms is None else ms
        return _host_vec(out, name, kind="time")
    # enum: intern strings host-side, codes to device; domain sorted
    # alphabetically like the reference's categorical domains
    lut: dict[str, int] = {}
    codes = np.empty(n, dtype=np.int32)
    for i, tok in enumerate(vals):
        tok = tok.strip()
        if _is_na(tok, nas):
            codes[i] = NA_ENUM
        else:
            codes[i] = lut.setdefault(tok, len(lut))
    return _lut_to_vec(codes, lut, name)


def _lut_to_vec(codes: np.ndarray, lut: dict[str, int], name: str) -> Vec:
    """First-seen intern codes (-1 = NA) → Vec with a SORTED domain —
    the one remap implementation shared by the CSV/ARFF and Avro
    interning paths."""
    domain = sorted(lut)
    order = {tok: i for i, tok in enumerate(domain)}
    remap = np.empty(len(lut) + 1, dtype=np.int32)
    remap[-1] = NA_ENUM
    for tok, old in lut.items():
        remap[old] = order[tok]
    return _host_vec(remap[codes], name, domain=domain)
