"""PyTorch port, runtime and fleet surface: the cloud persist backends
(``h2o_kubernetes_tpu_torch/persist_cloud.py``: ``s3://``, ``gs://``,
``hdfs://``) against local fake servers — no network, no SDKs — held
against the JAX package's: the same signed bytes for the same request
and clock, and artifacts that cross between the packages through an
object store both ways."""

import datetime as _dt
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

import h2o_kubernetes_tpu.operator.registry as jregistry
import h2o_kubernetes_tpu.persist_cloud as jcloud
import h2o_kubernetes_tpu_torch as port
from h2o_kubernetes_tpu_torch import persist, persist_cloud
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.operator import ModelRegistry, load_artifact


def _server_side_sigv4(method, path_qs, headers, payload, secret):
    """The signature recomputed from the request as the server saw it
    (what minio/localstack verify), written from the AWS spec."""
    import hashlib
    import hmac as hm

    auth = headers.get("Authorization")
    if not auth or not auth.startswith("AWS4-HMAC-SHA256"):
        return None
    cred = auth.split("Credential=")[1].split(",")[0]
    signed = auth.split("SignedHeaders=")[1].split(",")[0]
    _akid, datestamp, region, service, _term = cred.split("/")
    path = path_qs.split("?", 1)[0]
    query = path_qs.split("?", 1)[1] if "?" in path_qs else ""
    canon = "".join(f"{h}:{headers.get(h).strip()}\n"
                    for h in signed.split(";"))
    canonical = "\n".join([method, path, query, canon, signed,
                           hashlib.sha256(payload).hexdigest()])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", headers["x-amz-date"], scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])

    def _k(key, msg):
        return hm.new(key, msg.encode(), hashlib.sha256).digest()

    k = _k(_k(_k(_k(b"AWS4" + secret.encode(), datestamp), region),
               service), "aws4_request")
    return hm.new(k, to_sign.encode(), hashlib.sha256).hexdigest()


class _FakeStore(BaseHTTPRequestHandler):
    """S3 path-style and WebHDFS object paths and the GCS JSON media
    endpoints; signed S3 requests are verified (a signer defect 403s)."""

    store: dict = {}
    auth_headers: list = []
    sigv4_checked = 0

    def log_message(self, *a):
        pass

    def _verify_sig(self, payload):
        auth = self.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256"):
            return True
        expect = _server_side_sigv4(self.command, self.path, self.headers,
                                    payload, "secret")
        type(self).sigv4_checked += 1
        return expect == auth.split("Signature=")[1]

    def _key(self):
        from urllib.parse import parse_qs, unquote, urlparse

        path = self.path.split("?", 1)[0]
        if path.startswith("/upload/storage/v1/b/"):
            q = parse_qs(urlparse(self.path).query)
            return f"/{path.split('/')[5]}/{q['name'][0]}"
        if path.startswith("/storage/v1/b/"):
            parts = path.split("/")
            return f"/{parts[4]}/{unquote(parts[6])}"
        return path

    def do_GET(self):
        self.auth_headers.append(dict(self.headers))
        key = self._key()
        if not self._verify_sig(b"") or key not in self.store:
            self.send_response(403 if key in self.store else 404)
            self.end_headers()
            return
        body = self.store[key]
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        self.auth_headers.append(dict(self.headers))
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if not self._verify_sig(body):
            self.send_response(403)
            self.end_headers()
            return
        self.store[self._key()] = body
        self.send_response(200)
        self.end_headers()

    do_POST = do_PUT


@pytest.fixture()
def fake_store(monkeypatch):
    _FakeStore.store = {}
    _FakeStore.auth_headers = []
    _FakeStore.sigv4_checked = 0
    srv = HTTPServer(("127.0.0.1", 0), _FakeStore)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    for k in ("AWS_ENDPOINT_URL", "STORAGE_EMULATOR_HOST",
              "H2O_TPU_WEBHDFS"):
        monkeypatch.setenv(k, url)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIDEXAMPLE")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    yield url
    srv.shutdown()
    srv.server_close()
    t.join(5)


def _frame(n=200, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    y = np.where(x + rng.normal(scale=0.3, size=n) > 0, "p", "n")
    return port.Frame.from_arrays({"x": x, "y": y}, device="cpu")


def test_schemes_registered():
    assert {"http", "https", "s3", "gs", "gcs", "hdfs", "mem"} <= \
        set(persist.PERSIST_SCHEMES)
    assert persist.PERSIST_SCHEMES["s3"] == (persist_cloud.s3_read,
                                             persist_cloud.s3_write)


@pytest.mark.parametrize("path", ["s3://bkt/dir/frame.h2f",
                                  "gs://bkt/dir/frame.h2f",
                                  "hdfs:///dir/frame.h2f"])
def test_frame_roundtrip(fake_store, path):
    fr = _frame()
    port.save_frame(fr, path)
    fr2 = port.load_frame(path, device="cpu")
    np.testing.assert_array_equal(fr["x"].to_numpy(), fr2["x"].to_numpy())
    assert fr2["y"].domain == fr["y"].domain


def test_s3_requests_are_sigv4_signed_and_gs_names(fake_store):
    fr = _frame(50)
    port.export_file(fr, "s3://bkt/export.csv")
    a = [h.get("Authorization") for h in _FakeStore.auth_headers
         if h.get("Authorization")][-1]
    assert a.startswith("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/")
    assert _FakeStore.sigv4_checked > 0
    assert _FakeStore.store["/bkt/export.csv"].decode().splitlines()[0] \
        == "x,y"
    port.export_file(fr, "gs://bkt/a/b/c.csv")
    assert persist.read_bytes("gs://bkt/a/b/c.csv") == \
        _FakeStore.store["/bkt/a/b/c.csv"]
    with pytest.raises(FileNotFoundError):
        port.load_frame("s3://bkt/nope.h2f", device="cpu")


class _FixedClock(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 3, 4, 5, 6, 7, tzinfo=_dt.timezone.utc)


@pytest.mark.parametrize("method,payload,token", [
    ("GET", b"", None), ("PUT", b"model bytes \x00\xff" * 50, None),
    ("PUT", b"x", "session-token")])
def test_sigv4_bytes_equal_reference(monkeypatch, method, payload, token):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIDEXAMPLE")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wJalrXUtnFEMI/K7MDENG")
    monkeypatch.setenv("AWS_REGION", "eu-west-3")
    if token:
        monkeypatch.setenv("AWS_SESSION_TOKEN", token)
    else:
        monkeypatch.delenv("AWS_SESSION_TOKEN", raising=False)
    monkeypatch.setattr(persist_cloud, "datetime", _FixedClock)
    monkeypatch.setattr(jcloud, "datetime", _FixedClock)
    for endpoint in (None, "http://gw:9000/minio"):
        if endpoint:
            monkeypatch.setenv("AWS_ENDPOINT_URL", endpoint)
        else:
            monkeypatch.delenv("AWS_ENDPOINT_URL", raising=False)
        url = persist_cloud._s3_url("bkt", "dir/a b+c.bin")
        assert url == jcloud._s3_url("bkt", "dir/a b+c.bin")
        _, host, uri = url
        got = persist_cloud._sigv4_headers(method, host, uri, payload)
        assert got == jcloud._sigv4_headers(method, host, uri, payload)
        assert "20260304T050607Z" in got["x-amz-date"]


def test_hdfs_create_follows_307_redirect(monkeypatch):
    class _NameNode(BaseHTTPRequestHandler):
        store: dict = {}

        def log_message(self, *a):
            pass

        def do_PUT(self):
            path = self.path.split("?", 1)[0]
            if "dn=1" not in self.path:
                self.send_response(307)
                self.send_header("Location", f"http://127.0.0.1:"
                                 f"{self.server.server_port}{self.path}&dn=1")
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            self.store[path] = self.rfile.read(n)
            self.send_response(201)
            self.end_headers()

        def do_GET(self):
            body = self.store.get(self.path.split("?", 1)[0], b"")
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = HTTPServer(("127.0.0.1", 0), _NameNode)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        monkeypatch.setenv("H2O_TPU_WEBHDFS",
                           f"http://127.0.0.1:{srv.server_port}")
        persist.write_bytes("hdfs:///data/x.bin", b"payload")
        assert _NameNode.store["/webhdfs/v1/data/x.bin"] == b"payload"
        assert persist.read_bytes("hdfs:///data/x.bin") == b"payload"
        monkeypatch.delenv("H2O_TPU_WEBHDFS")
        with pytest.raises(ValueError, match="H2O_TPU_WEBHDFS"):
            persist.read_bytes("hdfs:///x")
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(5)


def test_model_roundtrip_s3(fake_store):
    fr = _frame()
    m = port.GBM(ntrees=3, max_depth=3, seed=1).train(y="y",
                                                      training_frame=fr)
    path = port.save_model(m, "s3://bkt/models/gbm.model")
    m2 = port.load_model(path, device="cpu")
    X = np.asarray(fr["x"].to_numpy(), np.float32)[:, None]
    np.testing.assert_array_equal(m.score_numpy(X), m2.score_numpy(X))


def test_s3_artifacts_cross_packages_both_ways(fake_store, mesh8):
    """A registry on ``s3://`` written by the port is read by the JAX
    package's registry and scores the same margins there, and the other
    way round."""
    F = 6
    X = random_rows(7, 64, F)
    blob = random_tree_artifact(21, n_features=F, ntrees=4, max_depth=3)
    preg = ModelRegistry("s3://bkt/port-reg")
    v = preg.publish(load_artifact(blob, device="cpu"), "a")
    jreg = jregistry.ModelRegistry("s3://bkt/port-reg")
    assert jreg.latest("a") == v
    jm = jregistry.load_artifact(jreg.fetch("a", v))
    pm = load_artifact(preg.fetch("a", v), device="cpu")
    np.testing.assert_array_equal(
        np.asarray(jm.score_numpy(X), np.float32), pm.score_numpy(X))
    # the reference publishes, the port fetches and serves
    jreg2 = jregistry.ModelRegistry("gs://bkt/jax-reg")
    v2 = jreg2.publish(jm, "b")
    preg2 = ModelRegistry("gs://bkt/jax-reg")
    assert preg2.info("b", v2)["sha256"] == jreg2.info("b", v2)["sha256"]
    pm2 = load_artifact(preg2.fetch("b", v2), device="cpu")
    np.testing.assert_array_equal(pm2.score_numpy(X), pm.score_numpy(X))
